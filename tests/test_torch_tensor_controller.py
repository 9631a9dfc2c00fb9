"""The controller twin (``core/tensor_controller.py``) and the
fault-tolerance runtime against the JAX package's.

The JAX side (``tests/torch_jax_side.py``'s ``controller`` job) runs
once, in a subprocess with eight fake CPU devices.  Eight controllers
(hard and soft goals, upper and lower, super-hard ones sharing metrics,
a clip at ``conf_max``) go through both:

* ``make_spec``, ``stack_specs`` and ``init_state`` equal the
  reference's field for field, bit for bit;
* ``controller_step`` over eight readings, ``indirect_controller_step``,
  ``interaction_counts`` and ``coordinated_step`` equal
  ``repro.core.jax_controller``'s bit for bit, and ``controller_step``
  equals the host ``SmartController`` within 1e-5 relative (the
  reference's own bound; the host steps in f64);
* ``sharded_coordinated_step`` on four gloo ranks (two controllers a
  rank, over ``data`` and over ``model``) equals JAX's under
  ``shard_map`` on four devices, and the reference suite's case gives
  ``(vg - 60) / 8``;
* ``HeartbeatMonitor`` and ``StragglerDetector`` replay
  ``tests/test_substrate.py``'s event sequences, and longer ones, next
  to the reference classes.
"""

import numpy as np
import pytest
import torch

import torch_jax_side as side
import torch_train_ranks as ranks
from repro.distributed import fault_tolerance as jft
from repro_torch.core import ControllerModel, GoalSpec, SmartController
from repro_torch.core import tensor_controller as tc
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.launch.mesh import MeshPool

CASES = side.controller_cases()


@pytest.fixture(scope="module")
def jx(tmp_path_factory):
    return side.run("controller", tmp_path_factory.mktemp("jax_ctl"))


def spec_of(case):
    return tc.make_spec(ControllerModel(**case["model"]),
                        GoalSpec(**case["goal"]),
                        metric_id=case["metric_id"], device="cpu")


def host_of(case, initial):
    return SmartController(ControllerModel(**case["model"]),
                           GoalSpec(**case["goal"]), initial)


@pytest.mark.parametrize("i", range(len(CASES)))
def test_make_spec_matches_jax(jx, i):
    spec = spec_of(CASES[i])
    for f in tc.ControllerSpec._fields:
        got = getattr(spec, f).numpy()
        want = jx["specs"][i][f]
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


def test_stack_and_init_state_match_jax(jx):
    stacked = tc.stack_specs([spec_of(c) for c in CASES])
    for f in tc.ControllerSpec._fields:
        np.testing.assert_array_equal(getattr(stacked, f).numpy(),
                                      jx["stacked"][f], err_msg=f)
    state = tc.init_state(np.asarray(side.INITIAL, np.float32)
                          .tolist(), device="cpu")
    np.testing.assert_array_equal(state.conf.numpy(), jx["init_state"])
    assert state.conf.dtype == torch.float32


@pytest.mark.parametrize("i", range(len(CASES)))
def test_controller_step_matches_jax_and_host(jx, i):
    spec = spec_of(CASES[i])
    state = tc.init_state(side.INITIAL[i], device="cpu")
    host = host_of(CASES[i], side.INITIAL[i])
    for k, m in enumerate(side.MEASUREMENTS):
        state, conf = tc.controller_step(spec, state, torch.tensor(m))
        assert float(conf) == jx["direct"][i][k], (k, m)
        host.observe(m)
        assert float(conf) == pytest.approx(host.actuate(), rel=1e-5)


@pytest.mark.parametrize("i", range(len(CASES)))
def test_indirect_step_matches_jax_and_host(jx, i):
    spec = spec_of(CASES[i])
    for k, (m, d) in enumerate(zip(side.MEASUREMENTS, side.DEPUTIES)):
        _, conf = tc.indirect_controller_step(
            spec, tc.init_state(side.INITIAL[i], device="cpu"),
            torch.tensor(m), torch.tensor(d))
        assert float(conf) == jx["indirect"][i][k], (k, m, d)
        host = host_of(CASES[i], side.INITIAL[i])
        host.observe(m, deputy=d)
        assert float(conf) == pytest.approx(host.actuate(), rel=1e-5)


def test_counts_and_coordinated_step_match_jax(jx):
    stacked = tc.stack_specs([spec_of(c) for c in CASES])
    np.testing.assert_array_equal(
        tc.interaction_counts(stacked.metric_id, 8).numpy(), jx["counts"])
    states = tc.ControllerState(conf=torch.tensor(side.INITIAL))
    _, confs = tc.coordinated_step(stacked, states,
                                   torch.tensor(side.MEASUREMENTS))
    np.testing.assert_array_equal(confs.numpy(), jx["coordinated"])
    # a super-hard controller's N is the count of its metric's sharers,
    # every other's 1
    host = [host_of(c, x) for c, x in zip(CASES, side.INITIAL)]
    for h, c, n, m in zip(host, CASES, jx["counts"], side.MEASUREMENTS):
        h.set_interacting(int(n) if c["goal"].get("super_hard") else 1)
        h.observe(m)
    np.testing.assert_allclose(confs.numpy(), [h.actuate() for h in host],
                               rtol=1e-5)


def test_steps_run_on_the_inputs_device():
    spec = spec_of(CASES[0])
    state, conf = tc.controller_step(spec, tc.init_state(0.0, device="cpu"),
                                     torch.tensor(10.0))
    assert conf.device.type == "cpu" and state.conf.dtype == torch.float32
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tc.make_spec(ControllerModel(alpha=1.0), GoalSpec(1.0))


@pytest.fixture(scope="module")
def pool():
    p = MeshPool(4, 1, timeout_s=60.0, threads=1)
    yield p
    p.close()


@pytest.mark.parametrize("data,model,axis", [(4, 1, "data"),
                                             (1, 4, "model")])
def test_sharded_coordinated_step_matches_jax(jx, pool, data, model, axis):
    out = pool.run(ranks.sharded_controllers, CASES,
                   np.asarray(side.INITIAL, np.float32),
                   np.asarray(side.MEASUREMENTS, np.float32), data, model,
                   axis)
    got = np.concatenate([c for _, c in sorted(out, key=lambda r: r[0])])
    np.testing.assert_array_equal(got, jx["sharded"])


def test_reference_suite_case(jx, pool):
    case = dict(model=dict(alpha=1.0, delta=1.0, conf_max=1e9,
                           integer=False),
                goal=dict(value=100.0, super_hard=True), metric_id=0)
    out = pool.run(ranks.sharded_controllers, [case] * 8,
                   np.zeros(8, np.float32), np.full(8, 60.0, np.float32),
                   4, 1, "data")
    got = np.concatenate([c for _, c in sorted(out, key=lambda r: r[0])])
    np.testing.assert_array_equal(got, jx["suite"])
    assert abs(float(got[0]) - (jx["suite_vg"] - 60.0) / 8.0) < 1e-4


def _heartbeat_trail(mod):
    t = [0.0]
    failures = []
    mon = mod.HeartbeatMonitor(["w0", "w1", "w2"], timeout_s=5.0,
                               on_failure=failures.append,
                               clock=lambda: t[0])
    trail = []
    for now, beats in [(4.0, ["w0"]), (6.0, []), (7.0, ["w1", "w2"]),
                       (9.5, ["w0"]), (12.5, []), (13.0, ["w1"]),
                       (30.0, []), (31.0, ["w0", "w2"])]:
        t[0] = now
        for w in beats:
            mon.beat(w)
        trail.append((now, mon.check(), list(mon.alive)))
    return trail, failures


def test_heartbeat_monitor_matches_reference():
    assert _heartbeat_trail(ft) == _heartbeat_trail(jft)
    trail, failures = _heartbeat_trail(ft)
    assert trail[1] == (6.0, ["w1", "w2"], ["w0"])    # the substrate case
    assert failures[:2] == ["w1", "w2"]


def _straggler_trail(mod):
    det = mod.StragglerDetector(factor=2.0, window=4)
    out = [det.stragglers()]
    rng = np.random.default_rng(0)
    for i in range(12):
        det.record("fast1", 1.0)
        det.record("fast2", 1.1)
        det.record("slow", 3.5 if i < 8 else 1.2)
        det.record("noisy", float(rng.uniform(0.5, 3.0)))
        out.append(det.stragglers())
    return out


def test_straggler_detector_matches_reference():
    assert _straggler_trail(ft) == _straggler_trail(jft)
    det = ft.StragglerDetector(factor=2.0)
    for _ in range(8):
        det.record("fast1", 1.0)
        det.record("fast2", 1.1)
        det.record("slow", 3.5)
    assert det.stragglers() == ["slow"]
