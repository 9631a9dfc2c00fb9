"""The JAX package's side of the port's mesh-training tests, computed in
one subprocess a test file with eight fake CPU devices
(``--xla_force_host_platform_device_count=8``), so the test process stays
single-device.

``python tests/torch_jax_side.py <job> <out.pkl>`` runs one job and
pickles its results as numpy arrays and plain values (sharded outputs
read with ``np.asarray``, never indexed: indexing an explicitly sharded
array raises ``ShardingTypeError`` under jax 0.9).  :func:`run` does
that from a test.  Module constants name the cases, so a test and the
job agree on them without importing JAX here.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# ---- sharding: the axes tree and every spec function -----------------------
ALL_ARCHS = ["yi-6b", "h2o-danube-3-4b", "gemma3-4b", "starcoder2-15b",
             "deepseek-moe-16b", "llama4-maverick-400b-a17b", "rwkv6-7b",
             "recurrentgemma-9b", "whisper-tiny", "internvl2-1b"]
SIZES = [(a, "reduced") for a in ALL_ARCHS] + [("yi-6b", "full"),
                                               ("deepseek-moe-16b", "full")]
MESHES = {"2x1": ((2, 1), ("data", "model")),
          "1x2": ((1, 2), ("data", "model")),
          "2x2": ((2, 2), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
FSDP = [True, False, "residual"]
# (name, seq_len, global_batch, kind): a decode cell's 4096-entry rings
# reach the rule that puts a long dim on model; batch 6 and 3 do not
# divide every mesh's data axes
BATCH_SHAPES = [("train", 64, 8, "train"), ("train6", 64, 6, "train"),
                ("prefill", 64, 8, "prefill"), ("decode", 4096, 8, "decode"),
                ("decode3", 4096, 3, "decode")]

# ---- data-parallel training -------------------------------------------------
DP_ARCHS = ["yi-6b", "deepseek-moe-16b", "rwkv6-7b"]
# embed and head of 2^20 entries reach FSDP_THRESHOLD; rwkv6 needs d 128
# for two heads
DP_OVERRIDES = {"yi-6b": {"vocab_size": 16384},
                "deepseek-moe-16b": {"vocab_size": 16384},
                "rwkv6-7b": {"vocab_size": 16384, "d_model": 128}}
DP_ROWS, DP_SEQ = 4, 24
# A mesh rank's MoE layer caps over all of its rows at once (the
# expert-parallel body's one group), one process's over each row of a
# microbatch (moe_apply's groups): the MoE archs' steps agree bit for bit
# where a rank holds one row, so their D-rank cases take D rows.
DP_ONE_ROW = ("deepseek-moe-16b",)
# a Dx1 rank past GROUP_TOKENS at the configured capacity 1.25, where
# assignments drop: 2 x 320 tokens a rank of a 2x1 mesh, against the
# reference's step at two microbatches under a 1x1 mesh, whose MoE layer
# is the shard body over each microbatch's rows
DP_MOE_ARCH, DP_MOE_ROWS, DP_MOE_SEQ = "deepseek-moe-16b", 4, 320
# the default lr, its full value at step 1, and eps 1: AdamW's first step
# is then lr * g / (|g| + 1), close to linear in the gradient, so a
# parameter's error reads its gradient's; at the default eps 1e-8 it is
# lr * sign(g), which magnifies the last bit of a gradient near 1e-8 up
# to 1e8 times
DP_OPT = dict(warmup_steps=1, total_steps=10, eps=1.0)
COMPRESSED_RANKS = 4


# ---- tensor-parallel training ------------------------------------------------
TP_ARCHS = ["yi-6b", "h2o-danube-3-4b", "gemma3-4b", "starcoder2-15b",
            "internvl2-1b", "whisper-tiny"]
# case -> (arch, reduced() overrides): the six archs as reduced() gives
# them; yi-6b with embed and head past FSDP_THRESHOLD (2x2, FSDP on and
# off); the three replicated forms: one KV head (wk/wv replicated,
# partial on each rank), an odd vocab (embed and head replicated), and
# whisper-tiny with 3/3 heads (the whole attention replicated, the MLP
# split)
TP_CASES = {**{a: (a, {}) for a in TP_ARCHS},
            "yi-6b/v16384": ("yi-6b", {"vocab_size": 16384}),
            "yi-6b/kv1": ("yi-6b", {"num_kv_heads": 1}),
            "yi-6b/v511": ("yi-6b", {"vocab_size": 511}),
            "whisper-tiny/h3": ("whisper-tiny", {"num_heads": 3,
                                                 "num_kv_heads": 3})}
# the recurrent archs (their own job, ``tp_train_recurrent``): both as
# reduced() gives them (rwkv6 at d 64 is one head, which a 1x2 mesh
# straddles), rwkv6 at d 256 (four heads, split under 1x2 and 1x4), and
# with embed and head past FSDP_THRESHOLD for 2x2 (rwkv6 at d 128: two
# heads)
TP_RECURRENT_CASES = {
    "recurrentgemma-9b": ("recurrentgemma-9b", {}),
    "recurrentgemma-9b/v16384": ("recurrentgemma-9b", {"vocab_size": 16384}),
    "rwkv6-7b": ("rwkv6-7b", {}),
    "rwkv6-7b/d256": ("rwkv6-7b", {"d_model": 256}),
    "rwkv6-7b/d128v16384": ("rwkv6-7b", {"d_model": 128,
                                         "vocab_size": 16384}),
    # d_ff 96: three model ranks split the MLP, not the RG-LRU's dr of 64
    "recurrentgemma-9b/ff96": ("recurrentgemma-9b", {"d_ff": 96})}
# the MoE archs (their own job, ``tp_train_moe``): reduced()
# deepseek-moe-16b (a dense layer, then 8 experts top-2 and a shared one)
# and maverick (a dense layer, then 8 experts top-1 and a shared one) at
# capacity 8.0, where neither moe_apply's groups nor the expert-parallel
# body's capacity over a rank's tokens drops an assignment; with embed and
# head past FSDP_THRESHOLD for 2x2; deepseek with 6 experts, which four
# model ranks leave whole
TP_MOE_CASES = {
    "deepseek-moe-16b/c8": ("deepseek-moe-16b", {"capacity_factor": 8.0}),
    "llama4-maverick-400b-a17b/c8": ("llama4-maverick-400b-a17b",
                                     {"capacity_factor": 8.0}),
    "deepseek-moe-16b/c8v16384": ("deepseek-moe-16b", {
        "capacity_factor": 8.0, "vocab_size": 16384}),
    "llama4-maverick-400b-a17b/c8v16384": ("llama4-maverick-400b-a17b", {
        "capacity_factor": 8.0, "vocab_size": 16384}),
    "deepseek-moe-16b/c8e6": ("deepseek-moe-16b", {"capacity_factor": 8.0,
                                                   "num_experts": 6})}
# the 2x2 cases' steps run two microbatches, as one process at n_micro 2
TP_MICRO = {"recurrentgemma-9b/v16384": 2, "rwkv6-7b/d128v16384": 2,
            "deepseek-moe-16b/c8v16384": 2,
            "llama4-maverick-400b-a17b/c8v16384": 2}
TP_ROWS, TP_SEQ = 4, 16


def tp_case(case: str):
    """``(arch, reduced() overrides)`` of a ``TP_CASES``,
    ``TP_RECURRENT_CASES`` or ``TP_MOE_CASES`` case."""
    return {**TP_CASES, **TP_RECURRENT_CASES, **TP_MOE_CASES}[case]


def tp_batch(cfg, rows: int = TP_ROWS, seed: int = 0) -> dict:
    """Tokens and labels [rows, TP_SEQ] int32, and a frontend's f32
    ``patches`` or ``frames``, drawn in that order."""
    import numpy as np
    rng = np.random.default_rng(seed)
    out = {k: rng.integers(0, cfg.vocab_size, (rows, TP_SEQ)).astype(
        np.int32) for k in ("tokens", "labels")}
    if cfg.frontend == "vision":
        out["patches"] = rng.standard_normal(
            (rows, cfg.num_patches, cfg.frontend_dim)).astype(np.float32)
    if cfg.encoder_decoder:
        out["frames"] = rng.standard_normal(
            (rows, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return out


def dp_rows(arch: str, data: int) -> int:
    """The rows of ``arch``'s batch in a ``data``-rank case."""
    return data if arch in DP_ONE_ROW else DP_ROWS


def dp_batch(vocab: int, rows: int = DP_ROWS, seed: int = 0,
             seq: int = DP_SEQ) -> dict:
    import numpy as np
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, vocab, (rows, seq)).astype(np.int32)
            for k in ("tokens", "labels")}


def compressed_case():
    """Four ranks' gradient trees: blocks of very different scales, a
    leaf off the 128-block, a leaf of zeros (scale 1)."""
    import numpy as np
    rng = np.random.default_rng(7)
    n = COMPRESSED_RANKS
    w = rng.standard_normal((n, 8, 300)).astype(np.float32)
    w *= np.logspace(-4, 2, 300, dtype=np.float32)
    return {"w": w,
            "b": (rng.standard_normal((n, 130)) * 1e-3).astype(np.float32),
            "z": np.zeros((n, 256), np.float32)}


def int8_cases() -> dict:
    """Inputs of the quantize round trip: a padded vector, a zero block,
    a given scale that clips, and exact halves (round half to even)."""
    import numpy as np
    rng = np.random.default_rng(3)
    halves = np.concatenate([[127.0], np.arange(-20, 20) + 0.5,
                             np.zeros(87)]).astype(np.float32)
    zero_block = rng.standard_normal((4, 128)).astype(np.float32)
    zero_block[1] = 0.0
    return {
        "padded": (rng.standard_normal(300) * 3).astype(np.float32),
        "zero_block": zero_block,
        "halves": halves,
        "given_scale": (rng.standard_normal((2, 3, 50)) * 5).astype(
            np.float32),
    }


GIVEN_SCALE = [[0.01], [0.2], [3.0]]
# logical_spec's inputs, under the default rules and the serving overlay
LOGICAL = [("batch", "seq", "embed"), ("vocab", "embed"), ("heads", None),
           ("embed", "kv_heads", None), ("kv_seq",), ("experts", "moe_ff"),
           ("ctl",), ("batch", "experts", "expert_cap"), ("fsdp", "ff")]


# ---- the controller twin --------------------------------------------------------
def controller_cases() -> list[dict]:
    """Controllers as (model, goal, metric_id) keyword sets: hard and
    soft, upper and lower, super-hard ones sharing metrics, a clip."""
    return [
        dict(model=dict(alpha=2.0, delta=4.0, lam=0.1, conf_min=0.0,
                        conf_max=1e9, integer=False),
             goal=dict(value=100.0, hard=True), metric_id=0),
        dict(model=dict(alpha=1.0, delta=1.0, conf_max=1e9, integer=False),
             goal=dict(value=50.0), metric_id=1),
        dict(model=dict(alpha=-3.0, delta=2.5, lam=0.2, conf_min=1.0,
                        conf_max=40.0, integer=False),
             goal=dict(value=10.0, hard=True, direction="lower"),
             metric_id=2),
        dict(model=dict(alpha=1.0, delta=1.0, conf_max=1e9, integer=False),
             goal=dict(value=100.0, super_hard=True), metric_id=0),
        dict(model=dict(alpha=0.5, delta=3.0, lam=0.05, conf_max=1e9,
                        integer=False),
             goal=dict(value=80.0, super_hard=True), metric_id=0),
        dict(model=dict(alpha=4.0, delta=1.5, conf_max=500.0,
                        integer=False),
             goal=dict(value=30.0, super_hard=True), metric_id=2),
        dict(model=dict(alpha=1.0, delta=5.0, lam=0.3, conf_max=1e9,
                        integer=False),
             goal=dict(value=70.0, hard=True), metric_id=3),
        dict(model=dict(alpha=2.0, delta=1.0, conf_max=1e9, integer=False),
             goal=dict(value=60.0, super_hard=True), metric_id=2),
    ]


MEASUREMENTS = [10.0, 40.0, 95.0, 120.0, 80.0, 89.0, 5.0, 300.0]
DEPUTIES = [33.0, 0.0, 12.5, 70.0, 3.0, 250.0, 9.0, 1.0]
INITIAL = [0.0, 5.0, 20.0, 1.0, 2.0, 100.0, 7.0, 0.5]


# ---------------------------------------------------------------------------
# the jobs (JAX inside)
# ---------------------------------------------------------------------------


def _keyed(tree, is_leaf=None) -> dict:
    import jax
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=is_leaf)[0]
    return {jax.tree_util.keystr(k): v for k, v in flat}


def _mesh(name):
    import jax
    import numpy as np
    from jax.sharding import Mesh
    shape, names = MESHES[name]
    n = int(np.prod(shape))
    return Mesh(np.array(jax.devices()[:n]).reshape(shape), names)


def job_sharding() -> dict:
    import jax
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config, reduced
    from repro.configs.base import ShapeConfig
    from repro.distributed import sharding as shd
    from repro.distributed.collectives import (dequantize_int8,
                                               quantize_int8)
    from repro.models import zoo
    from repro.optim import adamw
    from repro.train.train_step import batch_pspecs

    import numpy as np

    def spec(p):
        return tuple(p)

    is_p = lambda x: isinstance(x, P)       # noqa: E731
    is_axes = lambda x: isinstance(x, shd.Axes)     # noqa: E731
    out = {"axes": {}, "params": {}, "opt": {}, "batch": {}, "int8": {},
           "logical": {}}
    for mesh_name in MESHES:
        for rules in ("default", "serve"):
            with shd.use_mesh(_mesh(mesh_name), rules=(
                    shd.SERVE_TP_RULES if rules == "serve" else None)):
                for names in LOGICAL:
                    out["logical"][(mesh_name, rules, names)] = spec(
                        shd.logical_spec(*names))
    for arch, size in SIZES:
        cfg = get_config(arch)
        if size == "reduced":
            cfg = reduced(cfg)
        shapes, axes = zoo.abstract_params(cfg)
        out["axes"][(arch, size)] = {
            k: tuple(a.names) for k, a in _keyed(axes, is_axes).items()}
        out.setdefault("shapes", {})[(arch, size)] = {
            k: (tuple(s.shape), str(s.dtype))
            for k, s in _keyed(shapes).items()}
        for mesh_name in MESHES:
            mesh = _mesh(mesh_name)
            for fsdp in FSDP:
                with shd.use_mesh(mesh, fsdp=fsdp):
                    pspecs = shd.params_pspecs(shapes, axes)
                key = (arch, size, mesh_name, str(fsdp))
                out["params"][key] = {
                    k: spec(p) for k, p in _keyed(pspecs, is_p).items()}
                out["opt"][key] = {
                    k: spec(p) for k, p in _keyed(adamw.state_pspecs(pspecs),
                                                  is_p).items()}
            if size != "reduced":
                continue
            for name, seq, batch, kind in BATCH_SHAPES:
                specs = batch_pspecs(cfg, ShapeConfig(name, seq, batch, kind),
                                     mesh)
                out["batch"][(arch, mesh_name, name)] = {
                    k: spec(p) for k, p in _keyed(specs, is_p).items()}
    for name, x in int8_cases().items():
        scale = (np.asarray(GIVEN_SCALE, np.float32)
                 if name == "given_scale" else None)
        q, s, shape = quantize_int8(jax.numpy.asarray(x), scale)
        out["int8"][name] = (np.asarray(q), np.asarray(s), tuple(shape),
                             np.asarray(dequantize_int8(q, s, shape)))
    return out


def job_dp_train() -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P

    from repro.configs import get_config, reduced
    from repro.distributed.collectives import compressed_psum_grads
    from repro.distributed.sharding import shard_map, use_mesh
    from repro.models import zoo
    from repro.optim import adamw
    from repro.train.train_step import make_train_step

    out = {"train": {}}
    opt_cfg = adamw.AdamWConfig(**DP_OPT)

    def step_of(cfg, params, batch):
        step = jax.jit(make_train_step(cfg, opt_cfg, n_micro=2))
        new_p, new_o, metrics = step(params, adamw.init(params),
                                     {k: jnp.asarray(v)
                                      for k, v in batch.items()})
        return {
            "state": {k: np.asarray(v) for k, v in _keyed(
                {"params": new_p, "opt": new_o}).items()},
            "metrics": {k: float(np.asarray(v)) for k, v in metrics.items()},
        }

    for arch in DP_ARCHS:
        cfg = reduced(get_config(arch), **DP_OVERRIDES[arch])
        params, _ = zoo.init(cfg, jax.random.key(0))
        out["train"][arch] = dict(
            step_of(cfg, params, dp_batch(cfg.vocab_size,
                                          dp_rows(arch, 2))),
            weights=jax.tree.map(np.asarray, params))
    cfg = reduced(get_config(DP_MOE_ARCH), **DP_OVERRIDES[DP_MOE_ARCH])
    params, _ = zoo.init(cfg, jax.random.key(0))
    # Auto axes: jax 0.9 makes Explicit ones by default, which refuse
    # the reference's sharding constraints (ROADMAP Queue 3)
    auto = (jax.sharding.AxisType.Auto,) * 2
    with use_mesh(jax.make_mesh((1, 1), ("data", "model"),
                                axis_types=auto)):
        out["moe_capacity"] = dict(
            step_of(cfg, params, dp_batch(cfg.vocab_size, DP_MOE_ROWS,
                                          seq=DP_MOE_SEQ)),
            weights=jax.tree.map(np.asarray, params))
        # and at the data-parallel cases' size, two rows a rank of 2x1
        out["moe_capacity_rows"] = step_of(
            cfg, params, dp_batch(cfg.vocab_size, DP_ROWS))
    mesh = jax.make_mesh((COMPRESSED_RANKS,), ("data",))
    grads = compressed_case()
    specs = {k: P("data") for k in grads}
    f = jax.jit(shard_map(lambda g: compressed_psum_grads(g, "data"),
                          mesh=mesh, in_specs=(specs,), out_specs=specs))
    got = f({k: jnp.asarray(v) for k, v in grads.items()})
    out["compressed"] = {k: np.asarray(v) for k, v in got.items()}
    return out


def job_tp_train(cases: dict | None = None, f64: bool = False) -> dict:
    """For every case of ``cases`` (``TP_CASES`` when None): the seed-0
    weights and the state and metrics after one jitted single-device
    ``make_train_step`` (one microbatch, ``TP_MICRO``'s where it names
    the case) on ``tp_batch``; with ``f64`` the same step with every
    float in f64 (:func:`_in_f64`) from the same weights."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from repro.configs import get_config, reduced
    from repro.models import zoo
    from repro.optim import adamw
    from repro.train.train_step import make_train_step

    out = {}
    opt_cfg = adamw.AdamWConfig(**DP_OPT)
    for case, (arch, over) in (TP_CASES if cases is None
                               else cases).items():
        cfg = reduced(get_config(arch), **over)
        params, _ = zoo.init(cfg, jax.random.key(0))
        weights = jax.tree.map(np.asarray, params)
        batch = tp_batch(cfg)
        with _in_f64() if f64 else contextlib.nullcontext():
            if f64:
                cfg = reduced(get_config(arch), **over, dtype="float64")
                params = jax.tree.map(
                    lambda a: jnp.asarray(a).astype(jnp.float64), weights)
            step = jax.jit(make_train_step(cfg, opt_cfg,
                                           n_micro=TP_MICRO.get(case, 1)))
            new_p, new_o, metrics = step(params, adamw.init(params),
                                         {k: jnp.asarray(v)
                                          for k, v in batch.items()})
        out[case] = {
            "weights": weights,
            "state": {k: np.asarray(v) for k, v in _keyed(
                {"params": new_p, "opt": new_o}).items()},
            "metrics": {k: float(np.asarray(v)) for k, v in metrics.items()},
        }
    return out


@contextlib.contextmanager
def _in_f64():
    """x64 on, and ``jnp.float32`` read as f64 where the reference names
    it (its casts, its f32 leaves and states): every float its step
    computes in f64.  The weights stay those drawn in f32."""
    import jax
    import jax.numpy as jnp
    f32 = jnp.float32
    jax.config.update("jax_enable_x64", True)
    jnp.float32 = jnp.float64
    try:
        yield
    finally:
        jnp.float32 = f32
        jax.config.update("jax_enable_x64", False)


def job_controller() -> dict:
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import PartitionSpec as P  # noqa: F401

    from repro.core import ControllerModel, GoalSpec
    from repro.core import jax_controller as jc

    def spec_of(case):
        return jc.make_spec(ControllerModel(**case["model"]),
                            GoalSpec(**case["goal"]),
                            metric_id=case["metric_id"])

    def fields(spec):
        return {f: np.asarray(getattr(spec, f)) for f in spec._fields}

    cases = controller_cases()
    specs = [spec_of(c) for c in cases]
    out = {"specs": [fields(s) for s in specs], "direct": [],
           "indirect": []}
    for spec, init in zip(specs, INITIAL):
        state = jc.init_state(init)
        confs = []
        for m in MEASUREMENTS:
            state, conf = jc.controller_step(spec, state, jnp.asarray(m))
            confs.append(float(conf))
        out["direct"].append(confs)
        out["indirect"].append([
            float(jc.indirect_controller_step(spec, jc.init_state(init),
                                              jnp.asarray(m),
                                              jnp.asarray(d))[1])
            for m, d in zip(MEASUREMENTS, DEPUTIES)])
    stacked = jc.stack_specs(specs)
    out["stacked"] = fields(stacked)
    out["init_state"] = np.asarray(jc.init_state(np.asarray(INITIAL,
                                                            np.float32)).conf)
    ids = np.asarray([c["metric_id"] for c in cases], np.int32)
    out["counts"] = np.asarray(jc.interaction_counts(jnp.asarray(ids), 8))
    states = jc.ControllerState(conf=jnp.asarray(INITIAL, jnp.float32))
    meas = jnp.asarray(MEASUREMENTS, jnp.float32)
    out["coordinated"] = np.asarray(
        jc.coordinated_step(stacked, states, meas)[1])
    mesh = jax.make_mesh((4,), ("model",))
    step = jax.jit(jc.sharded_coordinated_step(mesh, "model"))
    out["sharded"] = np.asarray(step(stacked, states, meas)[1])
    # the reference suite's case: eight super-hard controllers of one
    # metric, each at 60
    model = ControllerModel(alpha=1.0, delta=1.0, conf_max=1e9,
                            integer=False)
    same = jc.stack_specs([jc.make_spec(model, GoalSpec(100.0,
                                                        super_hard=True),
                                        metric_id=0) for _ in range(8)])
    out["suite"] = np.asarray(step(same, jc.ControllerState(
        conf=jnp.zeros(8)), jnp.full((8,), 60.0))[1])
    out["suite_vg"] = float(np.asarray(same.virtual_goal)[0])
    return out


JOBS = {"sharding": job_sharding, "dp_train": job_dp_train,
        "controller": job_controller, "tp_train": job_tp_train,
        "tp_train_recurrent": lambda: job_tp_train(TP_RECURRENT_CASES),
        "tp_train_recurrent_f64": lambda: job_tp_train(TP_RECURRENT_CASES,
                                                        f64=True),
        "tp_train_moe": lambda: job_tp_train(TP_MOE_CASES)}


def run(job: str, tmp_dir) -> dict:
    """``job``'s results, computed in a subprocess with eight fake CPU
    devices."""
    out = Path(tmp_dir) / f"{job}.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, __file__, job, str(out)],
                          capture_output=True, text=True, env=env,
                          timeout=600)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with open(out, "rb") as fh:
        return pickle.load(fh)


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT / "src"))
    result = JOBS[sys.argv[1]]()
    with open(sys.argv[2], "wb") as fh:
        pickle.dump(result, fh)
