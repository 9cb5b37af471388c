"""The dense histogram kernel's share of its roofline in the softmax fits
(``metrics._fit.hist_roofline``: the train rows, 140 trees a fit, 54
columns)."""
from benchmark.metrics._fit import hist_roofline as read  # noqa: F401
