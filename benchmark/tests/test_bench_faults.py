"""A run with the timed path broken underneath comes out not correct,
once for each fault the cell can have: a step that returns its state
unchanged, half of the batch left out (the mean over the rest), an answer
altered where it is produced.  (No cell here exchanges between chips.)"""
import pytest

from conftest import TINY
from runs import run_cell


def gbdt_faults(monkeypatch, kind):
    from dmlc_core_tpu_torch.models import GBDT
    fit = GBDT.fit

    def broken(self, bins, label, *a, **kw):
        if kind == "unchanged":
            out = self.init()
            out["base"] = fit(self, bins, label, *a, **kw)["base"]
            return out
        if kind == "half":
            n = bins.shape[0] // 2
            return fit(self, bins[:n], label[:n], *a, **kw)
        out = fit(self, bins, label, *a, **kw)
        out["leaf"][0, 0] *= 1.01
        return out
    monkeypatch.setattr(GBDT, "fit", broken)


CASES = [(c, k, gbdt_faults) for c in ("higgs.fit", "higgs.fit_sampled")
         for k in ("unchanged", "half", "answer")]


@pytest.mark.parametrize("cell,kind,plant", CASES,
                         ids=[f"{c}-{k}" for c, k, _ in CASES])
def test_a_broken_path_is_not_correct(monkeypatch, cell, kind, plant):
    plant(monkeypatch, kind)
    rc, line, err = run_cell(cell, TINY[cell])
    assert rc == 0, err
    assert line["correct"] is False, line["checks"]
