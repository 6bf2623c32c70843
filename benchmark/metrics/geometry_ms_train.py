"""Device ms a step inside the port's ``<prefix>/voxelize``, ``/groups``
and ``/graph`` ranges (data/device_pipeline.py, core/voxelize.py,
core/kernel_maps.py, kernels/radius_topk.py, kernels/join_kmap.py)."""
from ._trace import per_unit_ms, prefix, ranges


def read(ctx, record):
    if not record.get("trace"):
        return None
    s = ranges(record, prefix(ctx), ("voxelize", "groups", "graph"))
    return per_unit_ms(record, s) if s > 0 else None
