"""A whole multi:softmax boosting fit with a held-out set evaluated every
round: K trees a round, each with its levels, plus the per-row work of
each tree and of each round.

Per tree (``rows`` train rows, ``eval_rows`` held-out rows): the levels
(:mod:`.hist_level`); its (g, h), which read the row's p_k and label and
write g and h (16 B a train row; 5 FLOPs: a subtract, a product, a
complement, a clamp, a compare); its margin column's update, which reads
the margin and the leaf id and writes the margin (12 B a train row; 1
FLOP); and the eval rows' routing down the tree, a code read a level and
the eval margin read and written (depth + 8 B an eval row; the tree's
leaf table is read once; depth compares and an add, depth + 1 FLOPs).  Per round: the
softmax, which reads the K margins and writes the K p (8 K B a train row;
4 K FLOPs: a max, a subtract, an exp and a divide a class), and the
held-out loss, which reads the K eval margins and the label (4 K + 4 B an
eval row; 3 K + 2 FLOPs: the logsumexp and the pick).
"""
from . import hist_level
from .peaks import bound_s

GRAD_BYTES = 16
GRAD_FLOPS = 5
UPDATE_BYTES = 12
UPDATE_FLOPS = 1
EVAL_ROUTE_BYTES = 8  # plus one code byte a level


def eval_route_bytes(depth: int) -> int:
    return depth + EVAL_ROUTE_BYTES


def tree_bytes(rows: int, eval_rows: int, features: int, depth: int,
               bins: int = 256) -> float:
    levels = sum(hist_level.level_bytes(rows, features, 2 ** d, bins)
                 for d in range(depth))
    return (levels + rows * (GRAD_BYTES + UPDATE_BYTES)
            + eval_rows * eval_route_bytes(depth))


def tree_flops(rows: int, eval_rows: int, features: int,
               depth: int) -> float:
    return (depth * hist_level.level_flops(rows, features)
            + rows * (GRAD_FLOPS + UPDATE_FLOPS) + eval_rows * (depth + 1))


def round_bytes(rows: int, eval_rows: int, classes: int) -> float:
    return rows * 8 * classes + eval_rows * (4 * classes + 4)


def round_flops(rows: int, eval_rows: int, classes: int) -> float:
    return rows * 4 * classes + eval_rows * (3 * classes + 2)


def fit_bytes(rows: int, eval_rows: int, features: int, classes: int,
              rounds: int, depth: int, bins: int = 256) -> float:
    return rounds * (classes * tree_bytes(rows, eval_rows, features, depth,
                                          bins)
                     + round_bytes(rows, eval_rows, classes))


def fit_flops(rows: int, eval_rows: int, features: int, classes: int,
              rounds: int, depth: int) -> float:
    return rounds * (classes * tree_flops(rows, eval_rows, features, depth)
                     + round_flops(rows, eval_rows, classes))


def fit_bound_s(rows: int, eval_rows: int, features: int, classes: int,
                rounds: int, depth: int, bins: int = 256) -> float:
    """The least time of one fit at the published peaks."""
    return bound_s(fit_bytes(rows, eval_rows, features, classes, rounds,
                             depth, bins),
                   fit_flops(rows, eval_rows, features, classes, rounds,
                             depth))
