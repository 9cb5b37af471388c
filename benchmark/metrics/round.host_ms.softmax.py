"""Host-clock ms of a softmax round, from the port's trace ring
(``metrics._softmax.round_host_ms``)."""
from benchmark.metrics._softmax import round_host_ms as read  # noqa: F401
