"""Model families: sparse linear, FM and field-aware FM as ``nn.Module``s
over padded batches, and the histogram GBDT over binned features."""
from .common import (forest_from_numpy, logistic_nll,
                     params_block_from_numpy, params_from_numpy)
from .ffm import FieldAwareFactorizationMachine
from .fm import FactorizationMachine
from .gbdt import GBDT, QuantileBinner
from .linear import SparseLinearModel

__all__ = ["SparseLinearModel", "FactorizationMachine",
           "FieldAwareFactorizationMachine", "GBDT",
           "QuantileBinner", "forest_from_numpy", "logistic_nll",
           "params_block_from_numpy", "params_from_numpy"]
