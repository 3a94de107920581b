"""Data and sequence parallelism over torch.distributed (port of
``unirec_tpu/parallel``): ``mesh.py``."""
