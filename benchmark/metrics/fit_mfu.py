"""The whole fit's share of the card's peaks (``metrics._fit.fit_mfu``)."""
from benchmark.metrics._fit import fit_mfu as read  # noqa: F401
