"""Device ms a pair launched inside the estimator's spans: the keypoint
draw and SC2-PCR's five stages (infer.register_pair, reg/sc2pcr.py), or
the subsample, feature neighbours and RANSAC's three stages
(eval_kitti.random_sample, reg/matching.py, reg/ransac.py), from the
profiled window; beside ``estimate_ms.register``'s host clock it shows
how host-bound the estimator is."""
from ._spans import span_ms

SPANS = ("register/keypoints", "sc2pcr/match", "sc2pcr/consistency",
         "sc2pcr/seeds", "sc2pcr/hypotheses", "sc2pcr/refine",
         "match/sample", "match/nn", "ransac/draw", "ransac/score",
         "ransac/refine")


def read(ctx, record):
    return span_ms(record, SPANS)
