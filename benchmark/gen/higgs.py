"""Higgs-width rows: float32 features and a 0/1 label.

Features are standard normal, except the four jet b-tag columns (8, 12,
16 and 20 in UCI HIGGS's order), which, as in HIGGS, hold three distinct
values: 0, 1 or 2, drawn with equal shares.  The label is a Bernoulli
draw from a logistic model over threshold terms of seven features and
their conjunctions (the "steps" rule), so that, as in UCI HIGGS, seven
features carry signal and the rest are noise.  Made on the device by one
``torch.Generator`` seeded with the run's seed, in three large calls.
"""
from __future__ import annotations

import torch

#: HIGGS's jet b-tag columns (jets 1 to 4), each of three values
BTAG_COLUMNS = (8, 12, 16, 20)


def higgs_like(rows: int, features: int, seed: int, device) -> tuple:
    """(x float32 [rows, features], y float32 0/1 [rows]) on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed))
    x = torch.randn((rows, features), generator=gen, device=device)
    u = torch.rand(rows, generator=gen, device=device)
    cols = [c for c in BTAG_COLUMNS if c < features]
    x[:, cols] = torch.randint(0, 3, (rows, len(cols)), generator=gen,
                               device=device).to(torch.float32)
    f = lambda i: x[:, i]  # noqa: E731
    m = (1.5 * (f(0) > 0.0).float() - 1.0 * (f(1) > 0.5).float()
         + 1.0 * ((f(2) > -0.3) & (f(3) > 0.2)).float()
         + 0.8 * (f(4) > 1.0).float() - 0.6 * (f(5) < -0.8).float()
         + 0.5 * ((f(6) > 0) & (f(0) > 0)).float() - 0.9)
    y = (u < torch.sigmoid(2.0 * m)).float()
    return x, y
