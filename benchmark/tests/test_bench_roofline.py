"""The byte and FLOP counts at known shapes, against hand counts."""
import pytest

from benchmark.roofline import gbdt_fit, hist_level, peaks


def test_higgs_level_is_0_1315_ms():
    mean = sum(hist_level.level_bound_s(11e6, 28, 2 ** d)
               for d in range(6)) / 6
    assert mean * 1e3 == pytest.approx(0.1315, abs=5e-5)
    # byte bound: 11M rows x (28 codes + 8 gh + 4 node) + the histograms
    assert hist_level.level_bytes(11e6, 28, 1) == 11e6 * 40 + 28 * 256 * 8


def test_higgs_fit_needs_about_59_gb():
    nbytes = gbdt_fit.fit_bytes(11_000_000, 28, 20, 6)
    levels = sum(hist_level.level_bytes(11e6, 28, 2 ** d) for d in range(6))
    assert nbytes == 20 * (levels + 11e6 * 28)
    assert 58e9 < nbytes < 60e9
    assert gbdt_fit.fit_bound_s(11_000_000, 28, 20, 6) == pytest.approx(
        nbytes / peaks.HBM_BYTES_PER_S)


def test_sampled_fit_counts_used_rows_and_columns():
    assert gbdt_fit.columns_per_tree(28, 0.8) == 22
    full = gbdt_fit.fit_bytes(1000, 28, 1, 1, row_share=0.8,
                              features_used=22)
    assert full == 800 * (22 + 12) + 22 * 256 * 8 + 1000 * 28
