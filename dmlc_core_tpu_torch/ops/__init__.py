"""Sparse ops and the hand-written CUDA kernels they reduce through.

The segment-sum front end, its kernel wrapper and its plain version live
in the submodule :mod:`.segment_sum` (not re-exported here, so the name
stays the module's)."""
from .segment_sum import VALID_FORCE, check_force
from .sparse import (csr_matmul, csr_matvec, csr_row_sumsq_matmul,
                     padded_row_mean)

__all__ = ["VALID_FORCE", "check_force", "csr_matvec", "csr_matmul",
           "csr_row_sumsq_matmul", "padded_row_mean"]
