"""A plain histogram GBDT under multi:softmax, to judge a multi-class fit
and its held-out losses.

The semantics, as the configuration states them (``reference.gbdt``'s
cuts, codes, histograms, gains and routing): the base margin of class k is
log(max(its share of the rows, 1e-6)); each round takes p = softmax(m)
once, and class k's tree takes g = p_k - [y = k] and h = max(p_k (1 -
p_k), 1e-16) from that p; the K trees of a round are stored round-major
(tree r K + k is class k's tree of round r), and each adds its leaves to
its class's margin.  The held-out loss after each round is the mean of
logsumexp(m) - m_y over the eval rows (mlogloss).

Where this departs from XGBoost's ``multi:softmax`` as its GPU demo runs
it: labels are 0-6 (Covertype's 1-7 less one); the cuts come from a host
sample (XGBoost sketches every row); the hessian is p (1 - p) (XGBoost
takes 2 p (1 - p)) and the base margin the log prior (XGBoost starts every
class at 0); a node splits at the first maximum of the gain in
feature-major order, "go right if code > bin", only where the gain is
above 2 gamma (the port's tie rule); mlogloss is not clipped at 1e-15.

:func:`audit` follows a fitted forest round by round.  The state is held
in the forest's own precision, the configuration's float32 for the
program's forest: the train margins are the forest's base and leaves
added in its order, and each round's p their softmax in that precision
(for a float32 forest on the program's device, the program's margins and
p bit for bit).  A float64 p would hold the program to more than float32
can represent: for a row its class already fits, g = p - 1 cancels, and
on Covertype whole leaves of such rows move by a few percent with p's
last bit.  Everything computed from p is float64: (g, h), the
histograms, gains and leaves, with each level's rows routed by the
forest's own splits.  The eval rows' margins are the forest's base and
leaves added in float64.  :func:`fit` grows a forest by the same rules with
(g, h) rounded to a dtype: in bfloat16 it is the control.  Every sum is in
float64, and TF32 is off while the reference runs.
"""
from __future__ import annotations

import numpy as np
import torch

from .gbdt import TINY, _level, gains, route


def _no_tf32() -> None:
    """No float32 product rounded to TF32 on the card (set when the
    reference runs, after the program's window)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def base_margin(y: torch.Tensor, K: int) -> torch.Tensor:
    """float64 [K]: the log of each class's share, clamped to [1e-6, 1]."""
    share = torch.bincount(y.long(), minlength=K)[:K].double() / y.numel()
    return torch.log(share.clamp(1e-6, 1.0))


def class_gh(p: torch.Tensor, y: torch.Tensor, k: int) -> torch.Tensor:
    """[rows, 2] (g, h) of class ``k``'s tree from the round's p."""
    pk = p[:, k]
    g = pk - (y.long() == k).to(p.dtype)
    return torch.stack([g, torch.clamp(pk * (1 - pk), min=1e-16)], 1)


def mlogloss(m: torch.Tensor, y: torch.Tensor) -> float:
    """Mean of logsumexp(m) - m_y over the rows."""
    picked = m.gather(1, y.long()[:, None])[:, 0]
    return float((torch.logsumexp(m, 1) - picked).mean())


def leaves_of(bins: torch.Tensor, feature: torch.Tensor,
              threshold: torch.Tensor, depth: int) -> torch.Tensor:
    """Each row's leaf [0, 2**depth) in one tree, given its heap-ordered
    splits."""
    node = torch.zeros(bins.shape[0], dtype=torch.int32, device=bins.device)
    for d in range(depth):
        first, n = 2 ** d - 1, 2 ** d
        rel = node - first
        node = 2 * node + 1 + route(bins, rel, feature[first:first + n],
                                    threshold[first:first + n])
    return (node - (2 ** depth - 1)).long()


def _audit_tree(fz: dict, t: int, bins: torch.Tensor, gh: torch.Tensor,
                p: dict, out: dict) -> torch.Tensor:
    """``reference.gbdt.audit``'s checks of tree ``t`` on rows ``bins``
    with their float64 (g, h); returns each row's leaf."""
    B, depth, lam = p["num_bins"], p["max_depth"], p["lambda"]
    node = torch.zeros(bins.shape[0], dtype=torch.int32, device=bins.device)
    for d in range(depth):
        first, n = 2 ** d - 1, 2 ** d
        rel, hist, gain, terms = _level(bins, node, gh, d, p, None)
        loose = gains(hist, lam, p["min_child_weight"] * (1 - 1e-5))[0]
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
    s = torch.zeros(2 ** depth, 2, dtype=torch.float64, device=bins.device)
    s.index_add_(0, leaf_rel, gh)
    leaf64 = -p["eta"] * s[:, 0] / (s[:, 1] + lam)
    leaf = fz["leaf"][t].double()
    denom = torch.clamp(leaf64.abs(), min=max(
        float(leaf64.abs().median()), 1e-12))
    out["leaf_err"] = max(out["leaf_err"], float(
        ((leaf - leaf64).abs() / denom).max()))
    return leaf_rel


def audit(forest: dict, bins: torch.Tensor, y: torch.Tensor, p: dict,
          eval_bins: torch.Tensor, eval_y: torch.Tensor,
          eval_losses) -> dict:
    """Every node and leaf of ``forest`` (numpy or tensors, the port's
    keys, ``p["num_class"]`` trees a round) against float64 on ``bins``,
    and the program's held-out losses ``eval_losses`` (one a round)
    against the float64 mlogloss of the forest's own margins on
    ``eval_bins``.  The base margins are held to the float64 prior and
    counted as leaves.  Returns the worst of each:

    * ``split_err``, ``cover_err``, ``leaf_err``: ``reference.gbdt.audit``'s
      definitions, the base margins counted as leaves;
    * ``eval_err``: |program's loss - float64 loss| / float64 loss, worst
      round; inf where the program gives no loss for a round."""
    _no_tf32()
    dev = bins.device
    K, depth = p["num_class"], p["max_depth"]
    fz = {k: torch.as_tensor(np.asarray(forest[k]), device=dev)
          for k in ("feature", "threshold", "split_gain", "split_cover",
                    "leaf")}
    base = base_margin(y, K)
    base_f = torch.as_tensor(np.asarray(forest["base"]), device=dev)
    out = {"split_err": 0.0, "cover_err": 0.0,
           "leaf_err": float(((base_f.double() - base).abs()
                              / base.abs().clamp(min=1e-3)).max()),
           "eval_err": 0.0}
    rounds = fz["leaf"].shape[0] // K
    losses = list(eval_losses)
    if len(losses) != rounds:
        out["eval_err"] = float("inf")
    # the train margins and each round's p in the forest's own precision,
    # the margins added in its order: a float32 forest's are the program's
    # float32 state bit for bit (on the program's device)
    m = base_f.to(fz["leaf"].dtype).expand(bins.shape[0], K).clone()
    em = base_f.double().expand(eval_bins.shape[0], K).clone()
    for r in range(rounds):
        prob = torch.softmax(m, 1).double()
        for k in range(K):
            t = r * K + k
            leaf_rel = _audit_tree(fz, t, bins, class_gh(prob, y, k), p, out)
            m[:, k] += fz["leaf"][t][leaf_rel]
            em[:, k] += fz["leaf"][t].double()[leaves_of(
                eval_bins, fz["feature"][t], fz["threshold"][t], depth)]
        if r < len(losses):
            want = mlogloss(em, eval_y)
            out["eval_err"] = max(out["eval_err"],
                                  abs(float(losses[r]) - want) / want)
    return out


def fit(bins: torch.Tensor, y: torch.Tensor, p: dict,
        eval_bins: torch.Tensor, eval_y: torch.Tensor,
        dtype=torch.float64) -> tuple:
    """(forest, eval losses): a forest grown by the rules above, with each
    tree's (g, h) rounded to ``dtype`` before they are summed (in float64),
    and each round's held-out loss from the eval margins rounded to
    ``dtype``.  ``torch.bfloat16`` is the control.  The forest holds numpy
    arrays under the port's keys."""
    _no_tf32()
    dev = bins.device
    K, B, depth, lam, eta = (p["num_class"], p["num_bins"], p["max_depth"],
                             p["lambda"], p["eta"])
    trees = p["num_trees"] * K
    base = base_margin(y, K)
    m = base.expand(bins.shape[0], K).clone()
    em = base.expand(eval_bins.shape[0], K).clone()
    keys = ("feature", "threshold", "split_gain", "split_cover")
    out = {k: np.zeros((trees, 2 ** depth - 1), np.float64) for k in keys}
    out["leaf"] = np.zeros((trees, 2 ** depth))
    losses = []
    for r in range(p["num_trees"]):
        prob = torch.softmax(m, 1)
        for k in range(K):
            t = r * K + k
            gh = class_gh(prob, y, k).to(dtype).double()
            node = torch.zeros(bins.shape[0], dtype=torch.int32, device=dev)
            for d in range(depth):
                first, n = 2 ** d - 1, 2 ** d
                rel, hist, gain, _ = _level(bins, node, gh, d, p, None)
                best_at = gain.argmax(1)
                best = gain.gather(1, best_at[:, None])[:, 0]
                null = ~(best > 2.0 * p.get("gamma", 0.0))
                feat = torch.where(null, 0, best_at // B)
                thr = torch.where(null, B, best_at % B)
                sl = slice(first, first + n)
                out["feature"][t, sl] = feat.cpu().numpy()
                out["threshold"][t, sl] = thr.cpu().numpy()
                out["split_gain"][t, sl] = torch.where(
                    null, 0.0, best).cpu().numpy()
                out["split_cover"][t, sl] = hist[:, 0, :, 1].sum(
                    1).cpu().numpy()
                node = 2 * node + 1 + route(bins, rel, feat, thr)
            leaf_rel = (node - (2 ** depth - 1)).long()
            s = torch.zeros(2 ** depth, 2, dtype=torch.float64, device=dev)
            s.index_add_(0, leaf_rel, gh)
            leaf = -eta * s[:, 0] / (s[:, 1] + lam)
            out["leaf"][t] = leaf.cpu().numpy()
            m[:, k] += leaf[leaf_rel]
            em[:, k] += leaf[leaves_of(
                eval_bins, torch.as_tensor(out["feature"][t], device=dev),
                torch.as_tensor(out["threshold"][t], device=dev), depth)]
        losses.append(mlogloss(em.to(dtype).double(), eval_y))
    out["feature"] = out["feature"].astype(np.int32)
    out["threshold"] = out["threshold"].astype(np.int32)
    out["base"] = base.cpu().numpy()
    return out, losses
