"""Model families: sparse linear and FM as ``nn.Module``s over padded
batches, and the histogram GBDT over binned features."""
from .common import forest_from_numpy, logistic_nll, params_from_numpy
from .fm import FactorizationMachine
from .gbdt import GBDT, QuantileBinner
from .linear import SparseLinearModel

__all__ = ["SparseLinearModel", "FactorizationMachine", "GBDT",
           "QuantileBinner", "forest_from_numpy", "logistic_nll",
           "params_from_numpy"]
