"""What the fit cells' per-layer readers share: each reader file names its
metric and takes one of these."""
from benchmark.roofline import gbdt_fit, hist_level
from benchmark.trace import kernel_seconds


def hist_roofline(rec):
    """The dense histogram kernel's share of its roofline over the traced
    window: the byte-and-FLOP bound of every level the window's fits
    needed (``roofline.hist_level``, at the rows and columns a tree may
    use), over the device time of the histogram call's kernels
    (``hist_dense`` and its ``prologue``)."""
    prof = rec.get("profile")
    if not prof or not rec.get("fits"):
        return None
    secs, _ = kernel_seconds(prof, "hist_dense", "prologue")
    if secs <= 0:
        return None
    tree = hist_level.tree_levels_bound_s(
        rec["rows"] * rec["row_share"], rec["features_used"], rec["depth"],
        rec["bins"])
    return 100.0 * rec["fits"] * rec["trees"] * tree / secs


def fit_mfu(rec):
    """The whole fit's share of the card's peaks: the least time of the
    window's fits' required work (``roofline.gbdt_fit``: levels,
    gradients, margin updates), over the span from the first fit's start
    to the last fit's end."""
    if not rec.get("fits") or rec.get("fit_span_s", 0) <= 0:
        return None
    one = gbdt_fit.fit_bound_s(rec["rows"], rec["features"], rec["trees"],
                               rec["depth"], rec["bins"], rec["row_share"],
                               rec["features_used"])
    return 100.0 * rec["fits"] * one / rec["fit_span_s"]
