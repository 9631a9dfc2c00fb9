"""The port's microbatch autotuner (``repro_torch.launch.autotune``).

* Both packages' ``autotune`` with their ``measure`` replaced by one
  deterministic plant (``tests/torch_jax_tooling.py``; the reference's
  module runs in a subprocess, since importing it sets ``XLA_FLAGS``):
  the histories equal probe for probe, the best-effort alert included.
* The port's own plant, the dry-run's reckoning on ``meta``, on a reduced
  yi-6b: the loop picks a divisor of the batch that fits the budget.
"""

import dataclasses

import pytest

import torch_jax_tooling as tooling
from repro_torch.configs import SHAPES, get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import autotune as at
from repro_torch.launch.mesh import ShapeMesh
from repro_torch.optim.accum import divisors

ONE_CARD = ShapeMesh((1, 1), ("data", "model"))
ALERT = ("goal unreachable at max feasible microbatching (controller "
         "best-effort alert)\n")


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    return tooling.run("autotune", tmp_path_factory.mktemp("jax_autotune"))


@pytest.mark.parametrize("budget,batch", tooling.AUTOTUNE_CASES)
def test_history_equals_reference(jx, budget, batch, monkeypatch, capsys):
    monkeypatch.setitem(SHAPES, "plant", ShapeConfig("plant", 4096, batch,
                                                     "train"))
    monkeypatch.setattr(
        at, "measure", lambda arch, shape_name, n, **kw: tooling.plant(
            n, batch))
    # on one card a rank's rows are the global batch, the reference's
    got = at.autotune("yi-6b", "plant", budget, mesh=ONE_CARD)
    want = jx[(budget, batch)]
    assert got == want["history"]
    assert capsys.readouterr().out == want["stdout"]


def test_cases_cover_the_loop(jx):
    """Among the shared cases: one reached after probes, one unreachable
    (the alert), one fitting at the first probe, batches of other
    divisors."""
    runs = {k: [h["n_micro"] for h in v["history"]] for k, v in jx.items()}
    assert any(v["stdout"] == ALERT for v in jx.values())
    assert any(len(r) == 1 or r[-1] != 1 for r in runs.values())
    assert {b for _, b in runs} == {16, 6, 12}


def test_divisors_of_a_ranks_rows_on_the_pod(monkeypatch):
    """On the 16 x 16 pod a rank's step takes 16 of ``train_4k``'s 256
    rows: the loop tries divisors of 16 and gives the alert past it."""
    seen = []

    def plant(arch, shape_name, n, **kw):
        seen.append(n)
        return tooling.plant(n, 16)
    monkeypatch.setattr(at, "measure", plant)
    at.autotune("yi-6b", "train_4k", 19e9)
    assert seen == [1, 4, 8, 16]


def test_reckoning_plant_picks_a_feasible_divisor(capsys):
    cfg = dataclasses.replace(reduced(get_config("yi-6b")), vocab_size=4096)
    shape = ShapeConfig("t", 256, 16, "train")
    mesh = ShapeMesh((1, 1), ("data", "model"))
    kw = dict(cfg=cfg, shape=shape, mesh=mesh)
    first = at.measure("yi-6b", "t", 1, **kw)
    last = at.measure("yi-6b", "t", 16, **kw)
    assert first["static_bytes"] == last["static_bytes"]
    assert first["peak_bytes"] > 2 * last["peak_bytes"]
    budget = (first["peak_bytes"] + 2 * last["peak_bytes"]) / 3
    hist = at.autotune("yi-6b", "t", budget, **kw)
    assert hist[0]["n_micro"] == 1 and len(hist) > 1
    assert hist[-1]["n_micro"] in divisors(16)
    assert hist[-1]["peak_bytes"] <= budget
    assert all(h["peak_bytes"] > budget for h in hist[:-1])
    assert capsys.readouterr().out == ""
