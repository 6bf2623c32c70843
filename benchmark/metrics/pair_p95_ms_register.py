"""The 95th percentile of every pair's latency in the window (ms), in a
cell where the card idles over most of the window and the host paces
it; the sample count goes to standard error."""
import sys

from ..stats import percentile


def read(ctx, record):
    lat = (record.get("window") or {}).get("latencies_s")
    if not lat:
        return None
    p95, beyond = percentile(lat, 95)
    print(f"pair_p95_ms.register: {len(lat)} pairs, {beyond} beyond the "
          f"95th percentile", file=sys.stderr)
    return p95 * 1e3
