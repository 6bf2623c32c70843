"""The readers of the port's own spans, by hand on synthetic records."""
from __future__ import annotations

import pytest

from benchmark import spec


def _record(units, range_device_s):
    return {"trace": {"units": units, "busy_s": 1.0, "window_s": 2.0,
                      "range_device_s": range_device_s}}


def test_conv_ms_sums_forward_and_backward_by_hand():
    conv = spec.reader("conv_ms.train")
    record = _record(4, {"conv/fwd": 0.2, "conv/bwd": 0.3,
                         "gcl/unet": 0.25, "gcl/backward": 0.01,
                         "graph/maps": 0.05})
    # (0.2 + 0.3) s over 4 steps; the step's own ranges are not summed
    assert conv.read(None, record) == pytest.approx(125.0)
    assert conv.read(None, _record(4, {"gcl/unet": 0.25})) is None
    assert conv.read(None, {}) is None


def test_extract_device_ms_sums_the_three_stages_by_hand():
    extract = spec.reader("extract_device_ms.register")
    record = _record(8, {"extract/voxelize": 0.008,
                         "extract/graph": 0.016, "extract/unet": 0.12,
                         "conv/fwd": 0.1, "bench/extract": 0.15})
    # 0.144 s over 8 pairs; conv/fwd, nested in extract/unet, is not
    # counted twice
    assert extract.read(None, record) == pytest.approx(18.0)
    assert extract.read(None, _record(8, {"bench/extract": 0.15})) is None


@pytest.mark.parametrize("ranges,want", [
    ({"register/keypoints": 0.001, "sc2pcr/match": 0.01,
      "sc2pcr/consistency": 0.04, "sc2pcr/seeds": 0.02,
      "sc2pcr/hypotheses": 0.03, "sc2pcr/refine": 0.02,
      "bench/estimate": 0.2}, 121.0 / 8),
    ({"match/sample": 0.0, "match/nn": 0.003, "ransac/draw": 0.0015,
      "ransac/score": 0.3, "ransac/refine": 0.0045,
      "bench/estimate": 0.4}, 309.0 / 3),
], ids=["sc2pcr", "ransac"])
def test_estimate_device_ms_sums_either_estimator_by_hand(ranges, want):
    estimate = spec.reader("estimate_device_ms.register")
    units = 8 if "sc2pcr/match" in ranges else 3
    assert estimate.read(None, _record(units, ranges)) == pytest.approx(want)
    assert estimate.read(None, _record(units, {"bench/estimate": 0.2})) \
        is None


def test_span_readers_lists_are_disjoint():
    """Each span is read by one reader, and none is one of the training
    step's ranges or the benchmark's own."""
    lists = [spec.reader(m).SPANS for m in (
        "conv_ms.train", "extract_device_ms.register",
        "estimate_device_ms.register")]
    names = [n for spans in lists for n in spans]
    assert len(names) == len(set(names))
    assert not any(n.startswith(("gcl/", "fcgf/", "bench/")) for n in names)
