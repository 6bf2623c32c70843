"""The benchmark's own span around the estimator's calls (keypoints and
SC2-PCR; or the subsample, feature matching and RANSAC), host clock, up
to the transform read on the host: mean ms over the span pass of the
traced run (pairs after its timed window, each with the spans on)."""


def read(ctx, record):
    spans = (record.get("spans") or {}).get("estimate")
    return 1e3 * sum(spans) / len(spans) if spans else None
