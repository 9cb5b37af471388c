"""One level of a dense (grad, hess) histogram.

A level with ``nodes`` nodes over ``rows`` used rows and ``features``
usable features must read, for every used row, its bin code of each
usable feature (one byte, uint8 codes), its (g, h) pair (two float32) and
its node id (int32), and write the level's histograms once: nodes x
features x bins x 2 float32.  Each (g, h) is added into two bins' sums of
each feature: 2 FLOPs a row a feature a lane.
"""
from .peaks import bound_s

CODE_BYTES = 1
GH_BYTES = 8
NODE_BYTES = 4
BIN_BYTES = 8  # a bin's (g, h) sums, float32


def level_bytes(rows: float, features: int, nodes: int,
                bins: int = 256) -> float:
    return (rows * (features * CODE_BYTES + GH_BYTES + NODE_BYTES)
            + nodes * features * bins * BIN_BYTES)


def level_flops(rows: float, features: int) -> float:
    return 2.0 * 2.0 * rows * features


def level_bound_s(rows: float, features: int, nodes: int,
                  bins: int = 256) -> float:
    return bound_s(level_bytes(rows, features, nodes, bins),
                   level_flops(rows, features))


def tree_levels_bound_s(rows: float, features: int, depth: int,
                        bins: int = 256) -> float:
    """The bound of a tree's ``depth`` levels (2**d nodes at depth d)."""
    return sum(level_bound_s(rows, features, 2 ** d, bins)
               for d in range(depth))
