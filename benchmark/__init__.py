"""The benchmark of gcl_tpu_torch on NVIDIA GPUs (see README.md)."""
