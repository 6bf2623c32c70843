"""Device ms a pair launched inside the feature extractor's spans
(infer.make_feature_extractor: ``extract/voxelize``, ``extract/graph``,
``extract/unet``), from the profiled window; beside
``extract_ms.register``'s host clock it shows how host-bound the
extractor is."""
from ._spans import span_ms

SPANS = ("extract/voxelize", "extract/graph", "extract/unet")


def read(ctx, record):
    return span_ms(record, SPANS)
