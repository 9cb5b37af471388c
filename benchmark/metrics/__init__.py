"""One reader a per-layer metric, named as the metric: ``read(rec)``
takes the traced run's record (the runner's counts, the configuration,
the mix, and ``profile``, the window's reduced trace) and returns the
metric's value, or None when there is nothing to read."""
