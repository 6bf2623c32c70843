"""What the trace readers share."""


def per_unit_ms(record, seconds):
    return seconds * 1e3 / record["trace"]["units"]


def prefix(ctx):
    return ctx.config["train"]["prefix"]


def ranges(record, pre, names):
    dev = record["trace"]["range_device_s"]
    return sum(dev.get(f"{pre}/{n}", 0.0) for n in names)


def idle_share(record):
    """1 - the device's busy time (the union of its kernels' and copies'
    intervals) over the profiled window's wall, both from the trace."""
    tr = record.get("trace")
    if not tr or tr["busy_s"] <= 0 or tr["window_s"] <= 0:
        return None
    return 1.0 - tr["busy_s"] / tr["window_s"]
