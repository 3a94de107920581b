"""Data, sequence, tensor and pipeline parallelism over torch.distributed
(port of ``unirec_tpu/parallel``): ``mesh.py``, ``tensor.py`` and
``pipeline.py``."""
