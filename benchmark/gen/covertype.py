"""Covertype-width rows: 54 float32 columns and a class label 0-6.

UCI Covertype's layout: 10 continuous columns, then the four wilderness
areas one-hot, then the 40 soil types one-hot.  The continuous columns are
standard normal (the real ones are integer-valued measurements); the
wilderness area is drawn at the dataset's shares, the soil type uniformly
over 40 (the real one is skewed).  The classes come at the dataset's
counts (scaled to ``rows`` where it differs from 581,012), cut in the
dataset's elevation order from a latent "elevation" of the first
continuous columns, the area and the soil, so that, as in Covertype, the
class follows the elevation closely and the one-hot columns shift it.
Made on the device by one ``torch.Generator`` seeded with the run's seed.
At 581,012 rows it is the bring-up script's Covertype generator row for
row, frozen here so that a change to the program cannot move the
yardstick.
"""
from __future__ import annotations

import torch

ROWS, CONT, SOILS = 581_012, 10, 40
FEATURES = CONT + 4 + SOILS
#: each class's rows in UCI Covertype (classes 1-7 as 0-6)
COUNTS = (211_840, 283_301, 35_754, 2_747, 9_493, 17_367, 20_510)
#: the classes from the lowest elevation to the highest
ELEVATION_ORDER = (3, 2, 5, 4, 1, 0, 6)
#: the four wilderness areas' shares of the rows
WILD_SHARES = (0.449, 0.051, 0.436, 0.064)


def class_counts(rows: int) -> list:
    """Each class's rows: Covertype's counts scaled to ``rows``, the
    remainder to the largest fractions (exact at 581,012)."""
    exact = [c * rows / ROWS for c in COUNTS]
    out = [int(e) for e in exact]
    rest = sorted(range(len(COUNTS)), key=lambda k: out[k] - exact[k])
    for k in rest[:rows - sum(out)]:
        out[k] += 1
    return out


def covertype_like(rows: int, seed: int, device) -> tuple:
    """(x float32 [rows, 54], y float32 class ids [rows]) on ``device``."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    cont = torch.randn(rows, CONT, generator=g, device=device)
    wild = torch.multinomial(torch.tensor(WILD_SHARES, device=device),
                             rows, replacement=True, generator=g)
    soil = torch.randint(0, SOILS, (rows,), generator=g, device=device)
    latent = (cont[:, 0] + 0.6 * (wild == 2) - 0.8 * (wild == 3)
              + 0.5 * torch.sin(soil.float()) + 0.3 * cont[:, 1] * cont[:, 2])
    order = torch.argsort(latent, stable=True)
    label = torch.empty(rows, device=device)
    counts = class_counts(rows)
    e0 = 0
    for c in ELEVATION_ORDER:
        label[order[e0:e0 + counts[c]]] = c
        e0 += counts[c]
    oh = torch.nn.functional.one_hot
    x = torch.cat([cont, oh(wild, 4).float(), oh(soil, SOILS).float()],
                  dim=1).contiguous()
    return x, label
