"""The share of the traced window in which no operation ran on the
device (``trace.idle_pct``)."""
from benchmark.trace import idle_pct as read  # noqa: F401
