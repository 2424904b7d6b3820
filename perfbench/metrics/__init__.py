"""One reader per metric, ``<metric name>.py``, each with ``read(run)``:
the metric's value from the run's record (:class:`perfbench.run.Record`),
or None where the run gives it nothing to read."""
