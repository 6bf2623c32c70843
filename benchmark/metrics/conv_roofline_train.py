"""The sparse conv kernels' share of their roofline (%): the least time of
the step's sparse convs (each call the larger of its matched operations
over the peak and its bytes over the bandwidth) over the profiler's
device time of the kernels that kernels/sparse_conv.json names."""
from ..kernels import device_seconds
from ..spec import kernel_family


def read(ctx, record):
    work, tr = record.get("work"), record.get("trace")
    if not work or not tr:
        return None
    spent = device_seconds(tr["kernel_s"], kernel_family("sparse_conv"))
    if spent <= 0:
        return None
    return 100.0 * work["family_least_s"] * tr["units"] / spent
