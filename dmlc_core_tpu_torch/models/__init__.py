"""Model families over sparse padded batches, as ``nn.Module``s."""
from .common import logistic_nll, params_from_numpy
from .fm import FactorizationMachine
from .linear import SparseLinearModel

__all__ = ["SparseLinearModel", "FactorizationMachine", "logistic_nll",
           "params_from_numpy"]
