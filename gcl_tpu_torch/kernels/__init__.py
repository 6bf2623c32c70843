"""Hand-written CUDA kernels of the port (sources in ../csrc).

Each module holds one kernel's wrapper, its plain PyTorch version and its
launch counter (``wrapper.launches``): a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises.
"""
from .occupancy_conv import occupancy_conv_fwd, occupancy_conv_fwd_plain
from .sparse_conv import (sparse_conv_implicit_fwd,
                          sparse_conv_implicit_fwd_plain)

KERNELS = (occupancy_conv_fwd, sparse_conv_implicit_fwd)


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0
