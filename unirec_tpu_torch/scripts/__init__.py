"""The quality gates of the port and the convergence demo (ports of the
JAX package's ``scripts/measure_int8_quality.py``,
``measure_serving_quality.py``, ``int8_base_convergence.py``,
``convergence_demo.py`` and ``quality_gates.py``, under the same names).

Each runs as ``python -m unirec_tpu_torch.scripts.<name>``, on the CUDA
card unless ``--device cpu`` is given, and prints the JAX script's lines.
"""

from __future__ import annotations

import torch


def full_fp32() -> None:
    """Float32 products at full precision (no TF32 in cuBLAS or cuDNN): the
    fp32 oracles and the fp32 training runs the gates compare keep about
    three digits under TF32, and every gate would then read noise."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
