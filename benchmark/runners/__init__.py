"""Runners: one module a kind of cell (``train``, ``register``), each with
``run(ctx)``, which builds the program from the cell's files, warms it
up, runs the measured window and the check, and returns the run's record
(see ``benchmark/run.py``)."""
