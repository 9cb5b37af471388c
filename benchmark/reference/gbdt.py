"""A plain histogram GBDT (XGBoost-hist, binary:logistic), to judge a fit.

The semantics, as the configuration states them: quantile cuts from a
host sample (linear interpolation, non-decreasing), codes = the number of
cuts at or below a value; the base margin is the logit of the positive
share (clamped to [1e-6, 1 - 1e-6]); each tree takes g = sigmoid(m) - y
and h = max(p (1 - p), 1e-16), times the tree's row draw; each level sums
(g, h) by (node, feature, bin), and a node splits at the (feature, bin)
of the largest gain GL^2/(HL+lambda) + GR^2/(HR+lambda) - G^2/(H+lambda)
("go right if code > bin", each side's hessian at least
min_child_weight, the first maximum in feature-major order), or not at
all when no gain is above 2 gamma; a leaf is -eta G / (H + lambda).

:func:`audit` follows a fitted forest tree by tree in float64: the
margins come from the reference's base and the forest's own earlier
leaves, and each level's rows are routed by the forest's own splits.  At
every node it holds the forest's split to the float64 best, its gain and
cover to their float64 values, and every leaf to its float64 value.
:func:`fit` grows a forest by the same rules in any precision: in bfloat16
inputs it is the control that the audit has to fail.
"""
from __future__ import annotations

import numpy as np
import torch

from . import threefry

TINY = 1e-30


def quantile_cuts(sample: np.ndarray, num_bins: int) -> np.ndarray:
    """float32 [features, num_bins - 1] cuts of a host sample."""
    qs = np.linspace(0.0, 1.0, num_bins + 1)[1:-1]
    cuts = np.nanquantile(np.asarray(sample, np.float32), qs, axis=0).T
    cuts = np.nan_to_num(cuts).astype(np.float32)
    return np.maximum.accumulate(cuts, axis=1)


def codes(x: torch.Tensor, cuts: np.ndarray, chunk: int = 1 << 21
          ) -> torch.Tensor:
    """uint8 [rows, features]: for each value, the number of its
    feature's cuts at or below it."""
    c = torch.as_tensor(cuts, device=x.device)
    out = torch.empty(x.shape, dtype=torch.uint8, device=x.device)
    for r0 in range(0, x.shape[0], chunk):
        xs = x[r0:r0 + chunk].T.contiguous()
        out[r0:r0 + chunk] = torch.searchsorted(
            c, xs, right=True).T.to(torch.uint8)
    return out


def tree_draws(t: int, rows: int, features: int, p: dict, device) -> tuple:
    """(row weights float32 [rows] or None, usable features bool [F] or
    None) of tree ``t``: ``subsample`` rows by a Bernoulli draw under
    fold_in(key, 2t), ``colsample_bytree`` columns as the first of a
    permutation under fold_in(key, 2t + 1), key = PRNGKey(seed)."""
    sub, col = p.get("subsample", 1.0), p.get("colsample_bytree", 1.0)
    if min(sub, col) >= 1.0:
        return None, None
    root = threefry.prng_key(p["seed"])
    w = cols = None
    if sub < 1.0:
        w = threefry.bernoulli(threefry.fold_in(root, 2 * t), sub, rows,
                               device).to(torch.float32)
    if col < 1.0:
        k = max(1, int(round(col * features)))
        sel = threefry.permutation(threefry.fold_in(root, 2 * t + 1),
                                   features, device)[:k]
        cols = torch.zeros(features, dtype=torch.bool, device=device)
        cols[sel] = True
    return w, cols


def base_margin(y: torch.Tensor) -> float:
    p = float((y > 0.5).double().mean())
    p = min(max(p, 1e-6), 1 - 1e-6)
    return float(np.log(p / (1 - p)))


def grad_hess(m: torch.Tensor, y: torch.Tensor) -> tuple:
    p = torch.sigmoid(m)
    return p - (y > 0.5).to(m.dtype), torch.clamp(p * (1 - p), min=1e-16)


def histogram(bins: torch.Tensor, rel: torch.Tensor, gh: torch.Tensor,
              nodes: int, num_bins: int) -> torch.Tensor:
    """[nodes, F, B, 2] sums of ``gh`` [rows, 2] in ``gh``'s dtype, one
    feature and lane at a time."""
    F = bins.shape[1]
    out = torch.zeros(nodes, F, num_bins, 2, dtype=gh.dtype,
                      device=gh.device)
    base = rel.long() * num_bins
    n = nodes * num_bins
    for f in range(F):
        key = base + bins[:, f].long()
        for lane in range(2):
            out[:, f, :, lane] = torch.bincount(
                key, weights=gh[:, lane], minlength=n)[:n].view(
                    nodes, num_bins)
    return out


def gains(hist: torch.Tensor, lam: float, mcw: float) -> tuple:
    """(gain, terms) [nodes, F, B] of "go right if code > b": the gain,
    -inf where a side's hessian is under ``mcw``; and the sum of the three
    terms' magnitudes, the scale rounding works on."""
    gl, hl = torch.cumsum(hist[..., 0], 2), torch.cumsum(hist[..., 1], 2)
    g, h = gl[..., -1:], hl[..., -1:]
    gr, hr = g - gl, h - hl
    a, b, c = gl ** 2 / (hl + lam), gr ** 2 / (hr + lam), g ** 2 / (h + lam)
    ok = (hl >= mcw) & (hr >= mcw)
    return torch.where(ok, a + b - c, -torch.inf), a + b + c


def route(bins: torch.Tensor, rel: torch.Tensor, feat: torch.Tensor,
          thr: torch.Tensor) -> torch.Tensor:
    """Each row's child (0 left, 1 right) under its node's split."""
    f = feat[rel.long()].long()
    code = torch.gather(bins, 1, f[:, None])[:, 0].to(torch.int32)
    return (code > thr[rel.long()]).to(rel.dtype)


def _level(bins, node, gh, depth: int, p: dict, cols):
    n, B = 2 ** depth, p["num_bins"]
    rel = node - (n - 1)
    hist = histogram(bins, rel, gh, n, B)
    gain, terms = gains(hist, p["lambda"], p["min_child_weight"])
    if cols is not None:
        gain = torch.where(cols[None, :, None], gain, -torch.inf)
    return rel, hist, gain.reshape(n, -1), terms.reshape(n, -1)


def audit(forest: dict, bins: torch.Tensor, y: torch.Tensor,
          p: dict) -> dict:
    """Every node and leaf of ``forest`` (numpy or tensors: feature,
    threshold, split_gain, split_cover, leaf, base) against float64 on
    ``bins``.  Returns the worst of each:

    * ``split_err``: (|forest gain - float64 gain of its split| + float64
      best gain - float64 gain of its split) / the terms' scale at the
      best split, the gain and the choice in one number; a split on a
      feature the tree may not use, or one whose sides break
      min_child_weight by more than rounding (1e-5), reads inf;
    * ``cover_err``: |forest cover - float64 H| / (H + lambda);
    * ``leaf_err``: |leaf - float64 leaf| / max(|float64 leaf|, the
      median |float64 leaf| of the tree), the base margin counted as a
      leaf."""
    dev = bins.device
    rows, F = bins.shape
    B, depth, lam, eta = (p["num_bins"], p["max_depth"], p["lambda"],
                          p["eta"])
    fz = {k: torch.as_tensor(np.asarray(forest[k]), device=dev)
          for k in ("feature", "threshold", "split_gain", "split_cover",
                    "leaf")}
    base = base_margin(y)
    base_f = float(np.asarray(forest["base"]))
    out = {"split_err": 0.0, "cover_err": 0.0,
           "leaf_err": abs(base_f - base) / max(abs(base), 1e-3)}
    y64 = y.double()
    m = torch.full((rows,), base, dtype=torch.float64, device=dev)
    for t in range(fz["leaf"].shape[0]):
        w, cols = tree_draws(t, rows, F, p, dev)
        g, h = grad_hess(m, y64)
        if w is not None:
            g, h = g * w, h * w
        gh = torch.stack([g, h], 1)
        node = torch.zeros(rows, dtype=torch.int32, device=dev)
        for d in range(depth):
            first, n = 2 ** d - 1, 2 ** d
            rel, hist, gain, terms = _level(bins, node, gh, d, p, cols)
            loose = gains(hist, lam, p["min_child_weight"] * (1 - 1e-5))[0]
            if cols is not None:
                loose = torch.where(cols[None, :, None], loose, -torch.inf)
            loose = loose.reshape(n, -1)
            feat = fz["feature"][t, first:first + n].long()
            thr = fz["threshold"][t, first:first + n].long()
            null = thr >= B
            pick = (feat * B + thr.clamp(max=B - 1))[:, None]
            chosen = torch.where(null, 0.0, loose.gather(1, pick)[:, 0])
            best_at = gain.argmax(1, keepdim=True)
            best = gain.gather(1, best_at)[:, 0].clamp(min=0.0)
            scale = torch.where(best > 0, terms.gather(1, best_at)[:, 0],
                                terms.gather(1, pick)[:, 0]) + TINY
            got = fz["split_gain"][t, first:first + n].double()
            err = ((got - chosen).abs() + (best - chosen)) / scale
            err = torch.where(torch.isfinite(chosen), err, torch.inf)
            out["split_err"] = max(out["split_err"], float(err.max()))
            H = hist[:, 0, :, 1].sum(1)
            cov = fz["split_cover"][t, first:first + n].double()
            out["cover_err"] = max(out["cover_err"], float(
                ((cov - H).abs() / (H + lam)).max()))
            node = 2 * node + 1 + route(bins, rel, fz["feature"][t, first:
                                                                 first + n],
                                        fz["threshold"][t, first:first + n])
        leaf_rel = (node - (2 ** depth - 1)).long()
        s = torch.zeros(2 ** depth, 2, dtype=torch.float64, device=dev)
        s.index_add_(0, leaf_rel, gh)
        leaf64 = -eta * s[:, 0] / (s[:, 1] + lam)
        leaf = fz["leaf"][t].double()
        denom = torch.clamp(leaf64.abs(), min=max(
            float(leaf64.abs().median()), 1e-12))
        out["leaf_err"] = max(out["leaf_err"], float(
            ((leaf - leaf64).abs() / denom).max()))
        m = m + leaf[leaf_rel]
    return out


def fit(bins: torch.Tensor, y: torch.Tensor, p: dict,
        dtype=torch.float64) -> dict:
    """A forest grown by the rules above, with (g, h) rounded to
    ``dtype`` before they are summed (in float64): ``torch.bfloat16`` is
    the control.  Returns numpy arrays with the port's forest keys."""
    dev = bins.device
    rows, F = bins.shape
    B, depth, lam, eta, trees = (p["num_bins"], p["max_depth"], p["lambda"],
                                 p["eta"], p["num_trees"])
    base = base_margin(y)
    m = torch.full((rows,), base, dtype=torch.float64, device=dev)
    y64 = y.double()
    keys = ("feature", "threshold", "split_gain", "split_cover")
    out = {k: np.zeros((trees, 2 ** depth - 1), np.float64) for k in keys}
    out["leaf"] = np.zeros((trees, 2 ** depth))
    for t in range(trees):
        w, cols = tree_draws(t, rows, F, p, dev)
        g, h = grad_hess(m, y64)
        if w is not None:
            g, h = g * w, h * w
        gh = torch.stack([g, h], 1).to(dtype).double()
        node = torch.zeros(rows, dtype=torch.int32, device=dev)
        for d in range(depth):
            first, n = 2 ** d - 1, 2 ** d
            rel, hist, gain, _ = _level(bins, node, gh, d, p, cols)
            best_at = gain.argmax(1)
            best = gain.gather(1, best_at[:, None])[:, 0]
            null = ~(best > 2.0 * p.get("gamma", 0.0))
            feat = torch.where(null, 0, best_at // B)
            thr = torch.where(null, B, best_at % B)
            sl = slice(first, first + n)
            out["feature"][t, sl] = feat.cpu().numpy()
            out["threshold"][t, sl] = thr.cpu().numpy()
            out["split_gain"][t, sl] = torch.where(null, 0.0,
                                                   best).cpu().numpy()
            out["split_cover"][t, sl] = hist[:, 0, :, 1].sum(1).cpu().numpy()
            node = 2 * node + 1 + route(bins, rel, feat, thr)
        leaf_rel = (node - (2 ** depth - 1)).long()
        s = torch.zeros(2 ** depth, 2, dtype=torch.float64, device=dev)
        s.index_add_(0, leaf_rel, gh)
        leaf = -eta * s[:, 0] / (s[:, 1] + lam)
        out["leaf"][t] = leaf.cpu().numpy()
        m = m + leaf[leaf_rel]
    out["feature"] = out["feature"].astype(np.int32)
    out["threshold"] = out["threshold"].astype(np.int32)
    out["base"] = np.float64(base)
    return out
