"""Metric readers: one module a metric, ``<metric>.py`` with dots in the
name as underscores, each ``read(ctx, record)`` returning the metric's
value from the run's record, or None where it finds nothing to read (the
runner then leaves the metric out of the result)."""
