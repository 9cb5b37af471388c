"""ScoringEngine — one immutable model snapshot on one device.

An engine binds a model (an ``nn.Module`` holding the snapshot's
parameters on its device, or for ``gbdt`` a ``GBDT`` with its forest and
fitted binner); ``score(batch)`` runs the family's bucketed predict.
Engines are immutable: a hot swap builds a NEW engine from the pushed
snapshot bytes and the server flips one pointer, so in-flight batches keep
scoring against the engine (and the weights) they captured.
"""
from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from .. import telemetry
from ..models import QuantileBinner
from ..models.common import params_from_numpy
from .snapshot import family_cls, snapshot_digest, unpack_snapshot


class ScoringEngine:
    """Scores :class:`~dmlc_core_tpu_torch.data.staging.PaddedBatch`
    requests against one frozen snapshot."""

    def __init__(self, family: str, model, params: Optional[dict] = None,
                 binner=None, digest: str = "", seq: int = 0):
        if family == "gbdt" and (params is None or binner is None):
            raise ValueError("a gbdt engine needs the forest and the fitted "
                             "binner")
        self.family = family
        self.model = model if family == "gbdt" else model.eval()
        self.params = params
        self.binner = binner
        self.digest = digest
        self.seq = int(seq)

    @classmethod
    def from_snapshot_bytes(cls, data, seq: Optional[int] = None,
                            device="cuda") -> "ScoringEngine":
        """Build an engine on ``device`` from a DTSNAP01 payload (packed by
        either package)."""
        data = bytes(data)
        digest = snapshot_digest(data)
        family, config, params, binner = unpack_snapshot(data)
        seq = seq if seq is not None else 0
        if family == "gbdt":
            model = family_cls(family)(**config, device=device)
            if binner is not None:
                binner = QuantileBinner.from_cuts(
                    binner.cuts, binner.num_bins,
                    missing_aware=binner.missing_aware, device=device)
            telemetry.counter_add("serve.swap_bytes", len(data))
            return cls(family, model,
                       params=params_from_numpy(family, params, device),
                       binner=binner, digest=digest, seq=seq)
        # built on "meta" (no storage), then the snapshot's tensors are
        # assigned in, so the weights are allocated on the device once
        model = family_cls(family)(**config, device="meta")
        model.load_state_dict(params_from_numpy(family, params, device),
                              assign=True)
        telemetry.counter_add("serve.swap_bytes", len(data))
        return cls(family, model, digest=digest, seq=seq)

    def score(self, batch) -> np.ndarray:
        """Score one packed (bucket-geometry) batch -> f32 scores for the
        REAL rows only; blocks until the result is on the host."""
        t0 = time.monotonic_ns()
        n = int(batch.num_rows)
        with torch.inference_mode():
            if self.family == "gbdt":
                out = self.model.predict_batch_bucketed(self.params, batch,
                                                        self.binner)
            else:
                out = self.model.predict_bucketed(batch)
            res = out[:n].cpu().numpy()
        telemetry.counter_add("serve.score_busy_us",
                              (time.monotonic_ns() - t0) // 1000)
        return res
