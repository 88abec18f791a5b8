"""One reader a metric, found by the metric's name in ``BENCHMARK.json``
(``<name>.py``).  Each has ``read(r)``: ``r`` is the run's reading (see
``run.py``); it returns the metric's value, or None where the run gives it
nothing to read, and the harness then leaves the metric out of the line."""
