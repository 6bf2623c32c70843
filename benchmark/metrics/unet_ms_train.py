"""Device ms a step of the U-Net, forward and backward (models/,
core/sparse_ops.py): the port's ``<prefix>/unet`` range, and the
backward's, whose kernels autograd launches from its own thread outside
every range: the device's busy time less what the step's ranges hold."""
from ._trace import per_unit_ms, prefix


def read(ctx, record):
    tr = record.get("trace")
    if not tr:
        return None
    pre = prefix(ctx) + "/"
    dev = tr["range_device_s"]
    inside = sum(v for k, v in dev.items() if k.startswith(pre))
    s = dev.get(pre + "unet", 0.0) + dev.get(pre + "backward", 0.0) + max(
        0.0, tr["busy_s"] - inside)
    return per_unit_ms(record, s) if s > 0 else None
