"""The benchmark's own span around the feature extractor's call (voxelize,
levels and maps, the U-Net forward), host clock, ending in a synchronize:
mean ms over the span pass of the traced run (pairs after its timed
window, each with the spans on)."""


def read(ctx, record):
    spans = (record.get("spans") or {}).get("extract")
    return 1e3 * sum(spans) / len(spans) if spans else None
