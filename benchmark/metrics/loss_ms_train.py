"""Device ms a step inside the port's ``<prefix>/loss`` range, with
``fcgf/correspondences`` where the step has it (losses/)."""
from ._trace import per_unit_ms, prefix, ranges


def read(ctx, record):
    if not record.get("trace"):
        return None
    s = ranges(record, prefix(ctx), ("loss", "correspondences"))
    return per_unit_ms(record, s) if s > 0 else None
