"""Sparse ops and the hand-written CUDA kernels they reduce through.

Each kernel's front end, wrapper and plain version live in their submodule
(:mod:`.segment_sum`, :mod:`.histogram`, :mod:`.histogram_sparse`,
:mod:`.draws`, :mod:`.route`; not
re-exported here, so the names stay the modules')."""
from .segment_sum import VALID_FORCE, check_force
from .sparse import (csr_matmul, csr_matvec, csr_row_sumsq_matmul,
                     csr_to_dense, csr_to_dense_missing, padded_row_mean)

__all__ = ["VALID_FORCE", "check_force", "csr_matvec", "csr_matmul",
           "csr_row_sumsq_matmul", "csr_to_dense", "csr_to_dense_missing",
           "padded_row_mean"]
