"""UniRec in PyTorch for NVIDIA Hopper: the port of ``unirec_tpu``.

The package mirrors ``unirec_tpu``'s layout (``models/``, ``ops/``,
``serving/``, ``data/``, ``utils/``) so each module's counterpart is found by
path.  It imports ``torch`` and never ``jax``; the config dataclasses, the
field-embedding cache and the serving micro-batcher are shared with
``unirec_tpu`` by import because those modules are framework-free.

The TPU's Pallas kernels on the serving path are hand-written CUDA here
(``csrc/``), built with ``nvcc`` on first use (``ops/_build.py``).
"""

__version__ = "0.1.0"
