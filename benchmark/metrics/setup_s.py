"""Set-up time: from the process's start to the first timed unit (loading,
building or loading the kernels, weights, the pool, warming up)."""


def read(ctx, record):
    return record.get("setup_s")
