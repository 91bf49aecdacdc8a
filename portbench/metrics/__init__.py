"""Per-layer metric readers, one file each, named as the metric
(``metrics/<name>.py``) and loaded by path. Each defines ``read(ctx)``,
which returns the metric's value from the traced window, or None where it
finds nothing to read. ``ctx`` (``run.ReadContext``) holds the trace, the
driver's counters of the traced call, the configuration, the traffic and
the device's peaks."""
