"""Device operations a tree in the softmax fits
(``metrics._softmax.tree_launches``)."""
from benchmark.metrics._softmax import tree_launches as read  # noqa: F401
