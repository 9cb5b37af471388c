"""What the softmax fit cell's per-layer readers share: each reader file
names its metric and takes one of these."""
from benchmark.roofline import gbdt_softmax


def fit_mfu(rec):
    """The whole softmax fit's share of the card's peaks: the least time
    of the window's fits' required work (``roofline.gbdt_softmax``: the
    levels, each tree's and each round's per-row work, the held-out
    routing and loss), over the span from the first fit's start to the
    last fit's end."""
    if not rec.get("fits") or rec.get("fit_span_s", 0) <= 0:
        return None
    one = gbdt_softmax.fit_bound_s(rec["rows"], rec["eval_rows"],
                                   rec["features"], rec["classes"],
                                   rec["rounds"], rec["depth"], rec["bins"])
    return 100.0 * rec["fits"] * one / rec["fit_span_s"]


def tree_launches(rec):
    """The traced window's device operations (every kernel, copy and set
    the profile saw) over the trees the window built (the port's
    ``gbdt.trees`` counter's rise across the window)."""
    prof = rec.get("profile")
    trees = rec.get("trees_built")
    if not prof or not rec.get("fits") or not trees:
        return None
    return float(sum(n for _, n in prof["kernels"].values())) / trees


def round_host_ms(rec):
    """The mean host-clock ms of a ``gbdt.round`` span in the port's trace
    ring, armed around the traced window."""
    if not rec.get("fits") or not rec.get("rounds_seen"):
        return None
    return float(rec["round_ms"])
