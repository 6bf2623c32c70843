"""What the readers of the port's own spans share (gcl_tpu_torch's
utils.spans: sibling ranges named ``<stage>/<part>``)."""
from ._trace import per_unit_ms


def span_ms(record, names):
    """Device ms a unit launched inside the spans ``names`` (none nested
    in another of them), or None where the trace holds none of them."""
    tr = record.get("trace")
    if not tr:
        return None
    dev = tr["range_device_s"]
    found = [n for n in names if n in dev]
    if not found:
        return None
    return per_unit_ms(record, sum(dev[n] for n in found))
