"""Hand-written CUDA kernels of the port (sources in ../csrc).

Each module holds its kernels' wrappers, their plain PyTorch versions and
their launch counters (``wrapper.launches``): a CPU tensor takes the plain
version, a CUDA tensor launches the kernel or raises.
"""
from .join_kmap import (counted_join_keys, join_kmap, join_kmap_plain,
                        join_windows)
from .occupancy_conv import (c1z_unpack_bits, counted_occupancy_keys,
                             occupancy_conv_dw, occupancy_conv_dw_plain,
                             occupancy_conv_fwd, occupancy_conv_fwd_plain,
                             occupancy_windows)
from .radius_topk import (counted_topk_keys, topk_windows,
                          windowed_cell_topk, windowed_cell_topk_exact,
                          windowed_cell_topk_packed, windowed_cell_topk_plain)
from .scalar_conv import (counted_scalar_keys, scalar_conv_dw,
                          scalar_conv_dw_plain,
                          scalar_conv_dx, scalar_conv_dx_plain,
                          scalar_conv_fwd, scalar_conv_fwd_plain)
from .sparse_conv import (compacted_rows, counted_dw_rows,
                          counted_gather_rows, sparse_conv_dw,
                          sparse_conv_dw_plain,
                          sparse_conv_implicit_bwd,
                          sparse_conv_implicit_bwd_plain,
                          sparse_conv_implicit_fwd,
                          sparse_conv_implicit_fwd_plain,
                          sparse_conv_table_fwd, sparse_conv_table_fwd_plain)

# TPU kernel number -> (wrapper, plain version)
KERNELS = {
    "K1": (windowed_cell_topk_packed, windowed_cell_topk_plain),
    "K2": (occupancy_conv_fwd, occupancy_conv_fwd_plain),
    "K3": (occupancy_conv_dw, occupancy_conv_dw_plain),
    "K4": (scalar_conv_fwd, scalar_conv_fwd_plain),
    "K5": (scalar_conv_dw, scalar_conv_dw_plain),
    "K6": (sparse_conv_implicit_fwd, sparse_conv_implicit_fwd_plain),
    "K7": (sparse_conv_implicit_bwd, sparse_conv_implicit_bwd_plain),
    "K8": (sparse_conv_dw, sparse_conv_dw_plain),
    "K9": (scalar_conv_dx, scalar_conv_dx_plain),
    "K10": (join_kmap, join_kmap_plain),
    "K11": (windowed_cell_topk_exact, windowed_cell_topk_plain),
    "K12": (sparse_conv_table_fwd, sparse_conv_table_fwd_plain),
}


def reset_launch_counts() -> None:
    for fn, _ in KERNELS.values():
        fn.launches = 0


def launch_counts() -> dict:
    return {name: fn.launches for name, (fn, _) in KERNELS.items()}
