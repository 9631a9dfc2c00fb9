"""The paper's six case studies and the §6.4 ablations on the port
(``repro_torch.core.simenv`` / ``ablations``) against the JAX package's,
decision for decision.

Both simulators draw their noise from ``numpy.random.Generator``s seeded
alike, and each package synthesizes its SmartConf from its own profile
with its own ``fit_model`` and controller: the port through
``simenv.synthesize``, the reference through ``benchmarks/common.py``'s
``synthesize`` (``tests/test_simenv.py``'s recipe).  For every case and
seeds 1-3 the port's arrays equal the reference's bit for bit
(``np.array_equal`` on float64): the profile samples, the SmartConf
trace (``t``, ``metric``, ``conf``, ``deputy``, ``tradeoff``, ``goal``,
the first violation and the count), the static default's,
``best_static``'s, and both ablation controllers'.  Then the
reference's own properties (``tests/test_simenv.py``) hold on the port.
"""

import dataclasses
import warnings

import numpy as np
import pytest

from benchmarks.common import synthesize as jx_synthesize
from repro.core import ablations as jx_ablations
from repro.core import simenv as jx_se
from repro_torch.core import ablations
from repro_torch.core import simenv as se

warnings.filterwarnings("ignore", category=RuntimeWarning)

CASES = list(se.ALL_CASES)
SEEDS = [1, 2, 3]
ABLATIONS = {
    "single_pole": lambda abl: (
        lambda m, g, c0: abl.SinglePoleController(m, g, c0, pole=0.9)),
    "no_virtual_goal": lambda abl: abl.NoVirtualGoalController,
}


def port_policy(env, controller_cls=None):
    """``simenv.synthesize``, what ``chip_smoke.py``'s phase 17a runs."""
    return se.synthesize(env, controller_cls=controller_cls)


def ref_policy(env, controller_cls=None):
    """The reference's recipe, ``benchmarks/common.py``'s ``synthesize``
    (``tests/test_simenv.py``'s with the controller swap of Figure 7)."""
    policy, model, _ = jx_synthesize(env, controller_cls=controller_cls)
    return policy, model


def assert_same_trace(got, want):
    for f in ("t", "metric", "conf", "deputy", "tradeoff", "goal"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype == (np.int64 if f == "t" else np.float64)
        assert np.array_equal(a, b), f
    assert got.first_violation == want.first_violation
    assert got.violations == want.violations
    assert got.hard == want.hard
    assert got.failed == want.failed


def both(case):
    return se.ALL_CASES[case](), jx_se.ALL_CASES[case]()


def test_case_table_matches():
    assert CASES == list(jx_se.ALL_CASES)
    for case in CASES:
        env, ref = both(case)
        for attr in ("issue", "indirect", "conditional", "horizon",
                     "phase_boundary", "conf_grid", "buggy_default",
                     "patched_default", "conf_min", "conf_max", "integer",
                     "metric_name", "tradeoff_name"):
            assert getattr(env, attr) == getattr(ref, attr), (case, attr)
        assert (env.goal.value, env.goal.hard) == (ref.goal.value,
                                                   ref.goal.hard)


@pytest.mark.parametrize("case", CASES)
def test_profile_samples_equal_reference(case):
    env, ref = both(case)
    got, want = env.profile(seed=0), ref.profile(seed=0)
    assert len(got) == len(want) > 0
    assert np.array_equal(np.array(got, dtype=np.float64),
                          np.array(want, dtype=np.float64))


@pytest.mark.parametrize("case", CASES)
def test_synthesized_model_equals_reference(case):
    env, ref = both(case)
    _, got = port_policy(env)
    _, want = ref_policy(ref)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", CASES)
def test_smartconf_trace_equals_reference(case, seed):
    env, ref = both(case)
    got = env.evaluate(port_policy(env)[0], seed=seed)
    want = ref.evaluate(ref_policy(ref)[0], seed=seed)
    assert_same_trace(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", CASES)
def test_static_defaults_equal_reference(case, seed):
    env, ref = both(case)
    for value in (env.buggy_default, env.patched_default):
        assert_same_trace(env.evaluate(se.StaticPolicy(value), seed=seed),
                          ref.evaluate(jx_se.StaticPolicy(value), seed=seed))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("case", CASES)
def test_best_static_equals_reference(case, seed):
    env, ref = both(case)
    cv, got = env.best_static(seed=seed)
    cv_ref, want = ref.best_static(seed=seed)
    assert cv == cv_ref
    assert_same_trace(got, want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("variant", list(ABLATIONS))
@pytest.mark.parametrize("case", CASES)
def test_ablation_trace_equals_reference(case, variant, seed):
    env, ref = both(case)
    pol, _ = port_policy(env, ABLATIONS[variant](ablations))
    pol_ref, _ = ref_policy(ref, ABLATIONS[variant](jx_ablations))
    assert type(pol.smartconf.controller).__name__ == \
        type(pol_ref.smartconf.controller).__name__
    assert_same_trace(env.evaluate(pol, seed=seed),
                      ref.evaluate(pol_ref, seed=seed))


def test_ablation_controllers_differ_as_designed():
    """Figure 7's variants are the designs they claim: one pole and a
    virtual goal, or two poles and the raw goal."""
    from repro_torch.core import ControllerModel, GoalSpec
    model = ControllerModel(alpha=1.0, delta=1.3, lam=0.1)
    goal = GoalSpec(100.0, hard=True)
    one = ablations.SinglePoleController(model, goal, 0.0, pole=0.9)
    assert one.pole == one.aggressive_pole == 0.9
    assert one.virtual_goal < goal.value
    raw = ablations.NoVirtualGoalController(model, goal, 0.0)
    assert raw.virtual_goal == goal.value
    raw.set_goal(GoalSpec(50.0, hard=True))
    assert raw.virtual_goal == 50.0


# ---- the reference's properties (tests/test_simenv.py) on the port ----------


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("seed", SEEDS)
def test_smartconf_satisfies_constraint(case, seed):
    env = se.ALL_CASES[case]()
    tr = env.evaluate(port_policy(env)[0], seed=seed)
    assert not tr.failed, (f"{case} seed {seed}: violations={tr.violations} "
                           f"first={tr.first_violation}")


@pytest.mark.parametrize("case", CASES)
def test_buggy_default_fails(case):
    env = se.ALL_CASES[case]()
    assert env.evaluate(se.StaticPolicy(env.buggy_default), seed=1).failed


@pytest.mark.parametrize("case", ["HB2149", "HB6728", "MR2820"])
def test_patched_default_still_fails(case):
    env = se.ALL_CASES[case]()
    assert env.evaluate(se.StaticPolicy(env.patched_default), seed=1).failed


@pytest.mark.parametrize("case", CASES)
def test_smartconf_tradeoff_competitive(case):
    env = se.ALL_CASES[case]()
    tr = env.evaluate(port_policy(env)[0], seed=1)
    _, best = env.best_static(seed=1)
    assert tr.total_tradeoff >= 0.90 * best.total_tradeoff


def test_goal_change_at_phase2_tracked():
    env = se.ALL_CASES["HB2149"]()
    tr = env.evaluate(port_policy(env)[0], seed=1)
    assert tr.metric[260:].mean() <= 5.0 * 1.1
