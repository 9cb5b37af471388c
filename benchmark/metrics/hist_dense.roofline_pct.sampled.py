"""The dense histogram kernel's share of its roofline
(``metrics._fit.hist_roofline``)."""
from benchmark.metrics._fit import hist_roofline as read  # noqa: F401
