"""The benchmark of nanoreviser_torch on NVIDIA GPUs (see run.py)."""
