"""The JAX package's side of the tooling tests, computed in a subprocess.

``src/repro/launch/dryrun.py`` sets ``XLA_FLAGS`` to 512 host devices when
it is imported, and ``src/repro/launch/autotune.py`` sets it unless it is
set; imported in a pytest worker before JAX starts, either would give
every later test in that worker 512 devices.  So they are imported here
only, in a process of their own: ``python tests/torch_jax_tooling.py
<job> <out.pkl>`` runs one job and pickles plain values; :func:`run`
does that from a test.  Module constants name the cases, so a test and
the job agree on them without importing JAX there.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# ---- hlo_flops: the reference's dot FLOPs of reduced yi-6b cells on 1x1 ---
# (name, seq_len, global_batch, kind)
FLOP_CELLS = [("train", 64, 4, "train"), ("prefill", 64, 4, "prefill"),
              ("decode", 128, 4, "decode")]

# ---- autotune: the reference's loop on a shared deterministic plant -------
# (budget bytes, batch): reached in a few probes; unreachable (the
# best-effort alert); reached at once; a batch with few divisors
AUTOTUNE_CASES = [(30e9, 16), (19e9, 16), (40e9, 16), (26e9, 6),
                  (24e9, 12)]


def plant(n_micro: int, batch: int) -> dict:
    """A deterministic stand-in for a reckoning: 12 GB of arguments,
    8 GB of temporaries no microbatching divides, and 24 GB of
    activations at the whole batch, divided by ``n_micro`` with a cost
    per microbatch."""
    static = 12_000_000_000
    temp = 8_000_000_000 + 24_000_000_000 // n_micro + 50_000_000 * n_micro
    return {"n_micro": n_micro, "peak_bytes": static + temp,
            "static_bytes": static, "temp_bytes": temp}


# ---------------------------------------------------------------------------
# the jobs (JAX inside)
# ---------------------------------------------------------------------------


def job_hlo_flops() -> dict:
    """The reference's step for each cell of :data:`FLOP_CELLS`, jitted on
    one device (the 1x1 mesh's placement is trivial; the reference's
    ``lower_cell`` raises ``ShardingTypeError`` under jax 0.9's explicit
    shardings, ROADMAP Queue 3), compiled, and counted by
    ``hlo_cost.analyze_module``."""
    import jax

    from repro.configs import get_config
    from repro.configs.base import ShapeConfig, reduced
    from repro.models import zoo
    from repro.optim import adamw
    from repro.roofline import hlo_cost
    from repro.train import train_step as ts

    cfg = reduced(get_config("yi-6b"))
    params = zoo.abstract_params(cfg)[0]
    out = {}
    for name, s, b, kind in FLOP_CELLS:
        specs = zoo.input_specs(cfg, ShapeConfig(name, s, b, kind))
        if kind == "train":
            step = ts.make_train_step(cfg, adamw.AdamWConfig())
            args = (params, jax.eval_shape(adamw.init, params), specs)
        elif kind == "prefill":
            step = ts.make_prefill_step(cfg, cache_len=s)
            args = (params, specs)
        else:
            step = ts.make_serve_step(cfg)
            args = (params, specs["caches"], specs["token"], specs["pos"])
        hlo = jax.jit(step).lower(*args).compile().as_text()
        out[name] = {"flops": float(hlo_cost.analyze_module(hlo)["flops"]),
                     "dots": [r for r in hlo_cost.attribute(hlo, top=60)
                              if r["flops"]]}
    return out


def job_autotune() -> dict:
    import contextlib
    import io

    from repro.configs import SHAPES
    from repro.configs.base import ShapeConfig
    from repro.launch import autotune as at

    out = {}
    for budget, batch in AUTOTUNE_CASES:
        SHAPES["plant"] = ShapeConfig("plant", 4096, batch, "train")
        at.measure = lambda arch, shape_name, n, _b=batch: plant(n, _b)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            hist = at.autotune("yi-6b", "plant", budget)
        out[(budget, batch)] = {"history": hist, "stdout": buf.getvalue()}
    return out


JOBS = {"hlo_flops": job_hlo_flops, "autotune": job_autotune}


def run(job: str, tmp_dir) -> dict:
    """``job``'s results, computed in a subprocess on the CPU."""
    out = Path(tmp_dir) / f"{job}.pkl"
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    env.pop("XLA_FLAGS", None)
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
