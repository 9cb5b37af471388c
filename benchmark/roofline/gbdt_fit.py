"""A whole boosting fit: its levels plus each tree's per-row work.

Per tree, beyond its levels (:mod:`.hist_level`): the gradients, which
read each row's margin and label (2 float32) and write its (g, h) (2
float32), and the margin update, which reads each row's margin and leaf
id (float32, int32) and writes the margin (float32).  The level counts
use the rows and features a tree may use (its row sample and column
sample); the per-row work covers every row, since every margin moves.
FLOPs: a sigmoid and a few products a row for (g, h) (counted as 8) and
one add for the update; the histograms' adds as in :mod:`.hist_level`.
"""
from . import hist_level
from .peaks import bound_s

GRAD_BYTES = 16    # margin, label in; g, h out
UPDATE_BYTES = 12  # margin, leaf id in; margin out
GRAD_FLOPS = 8
UPDATE_FLOPS = 1


def fit_bytes(rows: int, features: int, trees: int, depth: int,
              bins: int = 256, row_share: float = 1.0,
              features_used: int = 0) -> float:
    used = features_used or features
    levels = sum(hist_level.level_bytes(rows * row_share, used, 2 ** d,
                                        bins) for d in range(depth))
    return trees * (levels + rows * (GRAD_BYTES + UPDATE_BYTES))


def fit_flops(rows: int, features: int, trees: int, depth: int,
              row_share: float = 1.0, features_used: int = 0) -> float:
    used = features_used or features
    return trees * (depth * hist_level.level_flops(rows * row_share, used)
                    + rows * (GRAD_FLOPS + UPDATE_FLOPS))


def fit_bound_s(rows: int, features: int, trees: int, depth: int,
                bins: int = 256, row_share: float = 1.0,
                features_used: int = 0) -> float:
    return bound_s(fit_bytes(rows, features, trees, depth, bins, row_share,
                             features_used),
                   fit_flops(rows, features, trees, depth, row_share,
                             features_used))


def columns_per_tree(features: int, colsample_bytree: float) -> int:
    """XGBoost's and the JAX package's rounding of a tree's column
    sample."""
    if colsample_bytree >= 1.0:
        return features
    return max(1, int(round(colsample_bytree * features)))
