"""UniRec in PyTorch for NVIDIA Hopper: the port of ``unirec_tpu``.

The package mirrors ``unirec_tpu``'s layout (``models/``, ``ops/``,
``serving/``, ``train/``, ``data/``, ``utils/``) so each module's counterpart
is found by path.  It imports ``torch`` and never ``jax`` nor any module of
``unirec_tpu``: where it needs a framework-free module of that package (the
config dataclasses, the field-embedding cache, the serving micro-batcher) it
carries its own copy.

The TPU's Pallas kernels on the ported paths are hand-written CUDA here
(``csrc/``), built with ``nvcc`` on first use (``ops/_build.py``).
"""

__version__ = "0.1.0"
