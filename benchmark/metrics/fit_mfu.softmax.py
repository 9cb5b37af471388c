"""The whole softmax fit's share of the card's peaks
(``metrics._softmax.fit_mfu``)."""
from benchmark.metrics._softmax import fit_mfu as read  # noqa: F401
