"""Shared loss, predict and SGD pieces of the margins-based model
families."""
from __future__ import annotations

import numpy as np
import torch

from .._device import resolve_device
from ..data.staging import PaddedBatch, pad_batch_to_bucket
from ..ops.sparse import padded_row_mean

#: each family's parameter names (the flat dict the JAX package's
#: ``init()`` returns and its snapshots carry)
PARAM_KEYS = {"linear": ("b", "w"), "fm": ("b", "v", "w")}


def logistic_nll(margin: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Per-row binary cross-entropy from margins, overflow-stable.

    Accepts labels in {0,1} or {-1,1} (anything > 0.5 is positive).
    The kinks at ``m == 0`` take JAX's slopes under autograd, so a
    gradient there is the JAX package's: ``maximum`` splits its slope
    (1/2, as ``torch.maximum`` does; ``clamp`` would give 1) and ``|m|``
    takes +1 (``abs`` would give 0).  The gradient at a zero margin is
    then ``-y``, where the smooth loss has ``sigmoid(0) - y``; the port
    follows the reference.  The values are ``abs``'s and ``clamp``'s."""
    y = (label > 0.5).to(margin.dtype)
    a = torch.where(margin >= 0, margin, -margin)
    return (torch.maximum(margin, torch.zeros_like(margin)) - margin * y
            + torch.log1p(torch.exp(-a)))


#: a GBDT forest's arrays and their dtypes (``GBDT.init()``'s keys)
FOREST_DTYPES = {"feature": np.int32, "threshold": np.int32,
                 "default_right": np.int32, "split_gain": np.float32,
                 "split_cover": np.float32, "leaf": np.float32,
                 "base": np.float32, "trees_used": np.int32}
FOREST_REQUIRED = ("feature", "threshold", "leaf", "base")


def forest_from_numpy(forest_np: dict, device) -> dict:
    """The JAX package's GBDT forest as numpy arrays -> the port's forest
    dict on ``device``, each array copied in its own dtype (int32 node
    arrays and ``trees_used``, f32 gains, leaves and base; a 0-d ``base``
    stays 0-d, a softmax ``base`` stays [K]).  Forests saved before
    ``default_right``, ``split_gain``/``split_cover`` or ``trees_used``
    existed load without them."""
    dev = resolve_device(device)
    unknown = sorted(set(forest_np) - set(FOREST_DTYPES))
    missing = [k for k in FOREST_REQUIRED if k not in forest_np]
    if unknown or missing:
        raise ValueError(f"params of family 'gbdt' (a forest): unknown "
                         f"keys {unknown}, missing keys {missing}")
    return {k: torch.tensor(np.asarray(v, FOREST_DTYPES[k]), device=dev)
            for k, v in forest_np.items()}


def params_from_numpy(family: str, params_np: dict,
                      device) -> dict:
    """The JAX package's flat param dict as numpy arrays (``{"w": [F],
    "b": []}`` for linear, plus ``"v": [F, K]`` for fm) -> the port's
    module state on ``device``, ready for ``load_state_dict``.  The arrays
    are copied; a 0-d ``b`` stays 0-d.  ``"gbdt"`` is a forest, and goes
    to :func:`forest_from_numpy`."""
    if family == "gbdt":
        return forest_from_numpy(params_np, device)
    if family not in PARAM_KEYS:
        raise ValueError(f"no torch model for family '{family}'")
    want = PARAM_KEYS[family]
    dev = resolve_device(device)
    if tuple(sorted(params_np)) != want:
        raise ValueError(f"{family} params need keys {want}, got "
                         f"{tuple(sorted(params_np))}")
    return {k: torch.tensor(np.asarray(params_np[k], np.float32),
                            device=dev) for k in want}


class SGDModelMixin:
    """loss / predict / train_step shared by the margins-based families.

    Subclasses are ``nn.Module``s that provide ``margins(batch)`` plus
    attributes ``objective`` ("logistic"/"squared"), ``l2`` and
    ``learning_rate``, and may override ``_l2_terms()`` (default: just
    ``self.w``)."""

    def _l2_terms(self) -> tuple:
        return (self.w,)

    def forward(self, batch: PaddedBatch) -> torch.Tensor:
        return self.margins(batch)

    def loss(self, batch: PaddedBatch) -> torch.Tensor:
        m = self.margins(batch)
        if self.objective == "logistic":
            per_row = logistic_nll(m, batch.label)
        else:
            per_row = 0.5 * (m - batch.label) ** 2
        data_loss = padded_row_mean(per_row, batch.weight)
        if self.l2 > 0.0:
            data_loss = data_loss + 0.5 * self.l2 * sum(
                torch.sum(t ** 2) for t in self._l2_terms())
        return data_loss

    def predict(self, batch: PaddedBatch) -> torch.Tensor:
        m = self.margins(batch)
        return torch.sigmoid(m) if self.objective == "logistic" else m

    def train_step(self, batch: PaddedBatch) -> torch.Tensor:
        """One SGD step on the module's parameters, in place: the loss's
        gradient by autograd, then ``p -= learning_rate * p.grad`` under
        ``no_grad``; the grads are cleared after.  Returns the loss before
        the step (detached).  The JAX package's functional ``train_step``
        returns ``(new_params, loss)``; here the module is the params.
        With ``sdot_backend="pallas"`` on the card the forward sums run on
        the segment-sum kernel (3 launches an FM step, 1 a linear one) and
        their gradient is its gather."""
        loss = self.loss(batch)
        loss.backward()
        with torch.no_grad():
            for p in self.parameters():
                p -= self.learning_rate * p.grad
                p.grad = None
        return loss.detach()

    def predict_bucketed(self, batch: PaddedBatch, row_bucket=None,
                         nnz_bucket=None) -> torch.Tensor:
        """Pad the batch up to its pow-2 (rows, nnz) bucket, predict, and
        slice back to the batch's rows.  Real-row outputs equal
        ``predict`` (pad rows and lanes are inert in the margins)."""
        padded = pad_batch_to_bucket(batch, row_bucket, nnz_bucket)
        return self.predict(padded)[:batch.batch_size]
