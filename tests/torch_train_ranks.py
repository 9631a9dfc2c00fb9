"""What each rank of the mesh-training tests runs (``launch.mesh
.MeshPool``).

Spawned ranks import this module by name; it imports the port and numpy
only, never JAX.  Inputs arrive and results leave as numpy arrays and
plain values.  A function for a mesh smaller than the pool runs on its
first ranks; the others return None.
"""

from __future__ import annotations

import contextlib
import types

import numpy as np
import torch

from repro_torch.checkpoint import restore, save
from repro_torch.configs import get_config, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.core import ControllerModel, GoalSpec
from repro_torch.core import tensor_controller as tc
from repro_torch.distributed import collectives
from repro_torch.launch.mesh import make_host_mesh, world
from repro_torch.models import remat as remat_policy
from repro_torch.models import zoo
from repro_torch.models.bridge import keyed_leaves, params_from_numpy, tree_map
from repro_torch.optim import adamw
from repro_torch.train import train_step as ts
from repro_torch.train.trainer import Trainer, TrainerConfig


def config(arch: str, overrides: dict):
    return reduced(get_config(arch), **overrides)


def _mesh(data: int, model: int = 1):
    """This rank's mesh, or None on a rank past ``data * model``."""
    if world()[1] >= data * model:
        try:
            make_host_mesh(data=data, model=model)   # builds the groups
        except ValueError:
            return None
    return make_host_mesh(data=data, model=model)


def keyed_numpy(tree) -> dict:
    return {k: v.detach().float().numpy() if v.dtype == torch.bfloat16
            else v.detach().numpy() for k, v in keyed_leaves(tree)}


def _metrics(m: dict) -> dict:
    return {k: float(v) for k, v in m.items()}


def _batch(batch: dict) -> dict:
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def one_process(arch, overrides, weights, batch, n_micro, opt):
    """Rank 0 alone: ``make_train_step`` at ``n_micro`` on the whole batch
    (with the ranks' thread count): the full state after one step and
    the metrics."""
    if world()[1] != 0:
        return None
    cfg = config(arch, overrides)
    params = params_from_numpy(weights, "cpu")
    state = adamw.init(params)
    params, state, m = ts.make_train_step(
        cfg, adamw.AdamWConfig(**opt), n_micro=n_micro)(params, state,
                                                         _batch(batch))
    return keyed_numpy({"params": params, "opt": state}), _metrics(m)


def dp_step(arch, overrides, weights, batch, data, fsdp, opt, n_micro=1,
            ckpt_dir=None):
    """One ``make_mesh_train_step`` step on a ``data x 1`` mesh, this rank
    holding its slices and rows: rank 0 returns the gathered full state
    (and with ``ckpt_dir`` writes it there as step 1), every rank its
    metrics and the shapes of the leaves it holds."""
    mesh = _mesh(data)
    if mesh is None:
        return None
    cfg = config(arch, overrides)
    step = ts.make_mesh_train_step(cfg, adamw.AdamWConfig(**opt), mesh,
                                   fsdp=fsdp, n_micro=n_micro)
    pl = step.placement
    params = pl.local({"params": params_from_numpy(weights, "cpu")})["params"]
    state = adamw.init(params)
    params, state, m = step(params, state, ts.local_rows(_batch(batch),
                                                         mesh))
    mine = {"params": params, "opt": state}
    shapes = {k: tuple(v.shape) for k, v in keyed_leaves(mine)}
    full = pl.gather(mine)
    if ckpt_dir is not None and mesh.rank == 0:
        save(ckpt_dir, 1, full)
    return (keyed_numpy(full) if mesh.rank == 0 else None, _metrics(m),
            shapes)


def remat_steps(arch, overrides, data, model, remats, seed=0):
    """One ``make_mesh_train_step`` step (FSDP on) on a ``data x model``
    mesh under each policy of ``remats``, from the same seeded weights
    and 4 x 32 batch: by policy, this rank's slices of the state after
    the step and its metrics."""
    mesh = _mesh(data, model)
    if mesh is None:
        return None
    cfg = config(arch, overrides)
    weights = zoo.init(cfg, torch.Generator().manual_seed(seed), "cpu")
    batch = ts.local_rows(zoo.make_batch(
        cfg, ShapeConfig("t", 32, 4, "train"), np.random.default_rng(seed),
        "cpu"), mesh)
    out = {}
    for remat in remats:
        step = ts.make_mesh_train_step(cfg, adamw.AdamWConfig(), mesh,
                                       remat=remat)
        # AdamW writes in place, and whole leaves are the tree's own
        params = step.placement.local(
            {"params": tree_map(torch.clone, weights)})["params"]
        params, state, m = step(params, adamw.init(params), batch)
        out[remat] = (keyed_numpy({"params": params, "opt": state}),
                      _metrics(m))
    return out


@contextlib.contextmanager
def nan_placeholder():
    """The recompute's stand-in for each closing product's output
    (``models.remat._placeholder``) filled with NaN instead, so that a
    gradient which read it would not be finite; yields the shapes of the
    stand-ins made."""
    made, orig = [], remat_policy._placeholder

    def nan(shape, dtype, device):
        made.append(tuple(shape))
        return torch.full(shape, float("nan"), dtype=dtype, device=device)
    remat_policy._placeholder = nan
    try:
        yield made
    finally:
        remat_policy._placeholder = orig


def remat_steps_nan(arch, overrides, data, model, remats, seed=0):
    """:func:`remat_steps` under :func:`nan_placeholder`, and the number
    of stand-ins this rank made."""
    with nan_placeholder() as made:
        out = remat_steps(arch, overrides, data, model, remats, seed)
    return out, len(made)


def restore_on(ckpt_dir, arch, overrides, data, fsdp, model=1):
    """The elastic restore of ``ckpt_dir``'s latest step on a ``data x
    model`` mesh: every rank's slices, gathered; rank 0 returns the full
    tree, every rank the shapes of its slices."""
    mesh = _mesh(data, model)
    if mesh is None:
        return None
    cfg = config(arch, overrides)
    pl = ts.state_placement(cfg, mesh, fsdp=fsdp)
    params = zoo.init(cfg, torch.Generator().manual_seed(1), "cpu")
    like = pl.local({"params": params, "opt": adamw.init(params)})
    tree, _, step = restore(ckpt_dir, None, like, placement=pl)
    shapes = {k: tuple(v.shape) for k, v in keyed_leaves(tree)}
    full = pl.gather(tree)
    return (keyed_numpy(full) if mesh.rank == 0 else None), shapes, step


def compressed(grads, data):
    """``compressed_psum_grads`` of rank r's tree (row r of every leaf)
    over ``data``, and the exact f32 mean."""
    mesh = _mesh(data)
    if mesh is None:
        return None
    mine = {k: torch.from_numpy(v[mesh.data_index]) for k, v in grads.items()}
    got = collectives.compressed_psum_grads(mine, mesh, "data")
    exact = {k: collectives.all_reduce(v, mesh, "data") / data
             for k, v in mine.items()}
    return ({k: v.numpy() for k, v in got.items()},
            {k: v.numpy() for k, v in exact.items()})


def trainer_steps(workdir, arch, overrides, data, steps, fsdp):
    """A ``Trainer(mesh=)`` run one step at a time, SmartConf live: after
    each step the checkpoint interval, the last saved step, the number of
    writes and the loss; and the rows a rank draws a step."""
    mesh = _mesh(data)
    if mesh is None:
        return None
    cfg = config(arch, overrides)
    tr = Trainer(cfg, adamw.AdamWConfig(warmup_steps=1), TrainerConfig(
        workdir=workdir, total_steps=steps, ckpt_interval=2, batch_size=4,
        seq_len=16), device="cpu", mesh=mesh, fsdp=fsdp)
    trail = []
    for _ in range(steps):
        tr.run(1)
        trail.append((tr.step, tr.ckpt.interval_steps, tr.ckpt.last_saved,
                      tr.ckpt.writes, tr.metrics_log[-1]["loss"]))
    rows = tr.source.local_batch
    tr.close()
    return trail, rows


def trainer_resume(workdir, arch, overrides, data, fsdp):
    """A fresh ``Trainer(mesh=)`` over ``workdir``: the step it resumed at
    and its state gathered (rank 0)."""
    mesh = _mesh(data)
    if mesh is None:
        return None
    cfg = config(arch, overrides)
    tr = Trainer(cfg, adamw.AdamWConfig(warmup_steps=1), TrainerConfig(
        workdir=workdir, batch_size=4, seq_len=16, enable_smartconf=False),
        device="cpu", mesh=mesh, fsdp=fsdp)
    full = tr.placement.gather({"params": tr.params, "opt": tr.opt_state})
    step = tr.step
    tr.close()
    return step, (keyed_numpy(full) if mesh.rank == 0 else None)


def sharded_controllers(cases, initial, measurements, data, model, axis):
    """``sharded_coordinated_step`` over ``axis`` of a ``data x model``
    mesh, each rank holding its contiguous slice of the controllers."""
    mesh = _mesh(data, model)
    if mesh is None:
        return None
    n = mesh.axis_size(axis)
    i = mesh.data_index if axis == "data" else mesh.model_index
    per = len(cases) // n
    mine = slice(i * per, (i + 1) * per)
    specs = tc.stack_specs([
        tc.make_spec(ControllerModel(**c["model"]), GoalSpec(**c["goal"]),
                     metric_id=c["metric_id"], device="cpu")
        for c in cases[mine]])
    states = tc.init_state(torch.tensor(initial[mine], dtype=torch.float32))
    step = tc.sharded_coordinated_step(mesh, axis)
    _, confs = step(specs, states, torch.tensor(measurements[mine],
                                                dtype=torch.float32))
    return i, confs.numpy()


def tp_step(arch, overrides, weights, batch, data, model, fsdp, opt,
            n_micro=1, ckpt_dir=None):
    """One ``make_mesh_train_step`` step on a ``data x model`` mesh, this
    rank holding its slices and rows: rank 0 returns the gathered full
    state (and with ``ckpt_dir`` writes it there as step 1), every rank
    its metrics, the shapes of the leaves it holds, and the calls and
    bytes of its all-reduces over ``model``."""
    mesh = _mesh(data, model)
    if mesh is None:
        return None
    cfg = config(arch, overrides)
    step = ts.make_mesh_train_step(cfg, adamw.AdamWConfig(**opt), mesh,
                                   fsdp=fsdp, n_micro=n_micro)
    pl = step.placement
    params = pl.local({"params": params_from_numpy(weights, "cpu")})["params"]
    state = adamw.init(params)
    params, state, m = step(params, state, ts.local_rows(_batch(batch),
                                                         mesh))
    mine = {"params": params, "opt": state}
    shapes = {k: tuple(v.shape) for k, v in keyed_leaves(mine)}
    full = pl.gather(mine)
    if ckpt_dir is not None and mesh.rank == 0:
        save(ckpt_dir, 1, full)
    tp = step.tp
    return (keyed_numpy(full) if mesh.rank == 0 else None, _metrics(m),
            shapes, (tp.calls, tp.bytes) if tp is not None else (0, 0))


def tp_collectives(arch, overrides, weights, batch, opt):
    """A ``1x2`` step with every ``torch.distributed`` call of the rank
    recorded: (the call, the group's ranks) in order, the bytes of the
    tensors handed to them, and the step's ``ModelParallel`` count of
    all-reduces over ``model`` and of their bytes."""
    import torch.distributed as dist
    mesh = _mesh(1, 2)
    if mesh is None:
        return None
    cfg = config(arch, overrides)
    step = ts.make_mesh_train_step(cfg, adamw.AdamWConfig(**opt), mesh)
    params = step.placement.local(
        {"params": params_from_numpy(weights, "cpu")})["params"]
    state = adamw.init(params)
    calls = []
    sent = [0]
    real = {n: getattr(dist, n) for n in ("all_reduce", "all_gather",
                                          "broadcast", "reduce_scatter")}

    def recording(name):
        def call(*a, group=None, **kw):
            calls.append((name, tuple(dist.get_process_group_ranks(group))
                          if group is not None else None))
            t = a[1] if name == "all_gather" else a[0]
            sent[0] += t.numel() * t.element_size()
            return real[name](*a, group=group, **kw)
        return call

    for n in real:
        setattr(dist, n, recording(n))
    try:
        step(params, state, ts.local_rows(_batch(batch), mesh))
    finally:
        for n, f in real.items():
            setattr(dist, n, f)
    return calls, step.tp.calls, sent[0], step.tp.bytes


def tp_pair(x, w1, w2, logits, labels, table, ids):
    """The autograd pair, the vocab-parallel embedding and the
    vocab-parallel cross-entropy on a ``1x2`` mesh, each rank holding its
    half of ``w1``'s columns, ``w2``'s rows, ``logits``' and ``table``'s
    vocab: the outputs and this rank's gradients as numpy."""
    mesh = _mesh(1, 2)
    if mesh is None:
        return None
    mp = collectives.ModelParallel(mesh, {})
    r = mesh.model_index
    t = {k: torch.from_numpy(v).requires_grad_()
         for k, v in dict(x=x, w1=np.split(w1, 2, axis=1)[r],
                          w2=np.split(w2, 2, axis=0)[r],
                          logits=np.split(logits, 2, axis=1)[r],
                          table=np.split(table, 2, axis=0)[r]).items()}
    h = torch.tanh(collectives.copy_to_model(t["x"], mp) @ t["w1"])
    y = collectives.reduce_from_model(h @ t["w2"], mp)
    ce = collectives.vocab_cross_entropy(t["logits"],
                                         torch.from_numpy(labels), mp)
    emb = collectives.vocab_embed(t["table"], torch.from_numpy(ids), mp)
    ((y.square().sum() + ce + (emb * emb).sum()).backward())
    out = {"y": y, "ce": ce, "emb": emb}
    out.update({"d_" + k: v.grad for k, v in t.items()})
    return {k: v.detach().numpy() for k, v in out.items()}


def gather_case(leaves, specs):
    """On a ``2x2`` mesh: this rank's slices of ``leaves`` under ``specs``
    gathered over ``data`` alone and over both axes."""
    mesh = _mesh(2, 2)
    if mesh is None:
        return None
    from repro_torch.distributed.sharding import Placement
    pl = Placement(mesh, {k: tuple(v) for k, v in specs.items()})
    mine = pl.local({k: torch.from_numpy(v) for k, v in leaves.items()})
    data = pl.gather(mine, axes=("data",))
    both = pl.gather(mine)
    return ({k: v.numpy() for k, v in data.items()},
            {k: v.numpy() for k, v in both.items()},
            (mesh.data_index, mesh.model_index))


def tp_trainer(workdir, arch, overrides, data, model, steps):
    """A ``Trainer`` run of ``steps`` on a ``data x model`` mesh (or in one
    process on rank 0 when ``data * model == 1``): its losses."""
    if data * model == 1:
        if world()[1] != 0:
            return None
        mesh = None
    else:
        mesh = _mesh(data, model)
        if mesh is None:
            return None
    cfg = config(arch, overrides)
    tr = Trainer(cfg, adamw.AdamWConfig(warmup_steps=1), TrainerConfig(
        workdir=workdir, total_steps=steps, ckpt_interval=100, batch_size=4,
        seq_len=16, enable_smartconf=False), device="cpu", mesh=mesh)
    log = tr.run(steps)
    tr.close()
    return [r["loss"] for r in log]


@contextlib.contextmanager
def in_f64(capture=None):
    """Every float the model computes in f64 inside: the configs' f32 read
    as f64, ``.float()`` keeping f64, the recurrent blocks' zero states
    and the gradient sums over ``data`` and ``model`` in f64 (a call a
    tensor).  ``capture(grads)``, when given, sees the gradients AdamW
    receives."""
    from repro_torch.models import layers, rglru, rwkv6
    update, to32, dtypes = adamw.update, torch.Tensor.float, dict(
        layers.DTYPES)
    states = {lib: lib.init_state for lib in (rglru, rwkv6)}
    buckets = collectives.reduce_f32_buckets

    def wide_sums(tensors, mesh, axes):
        return [collectives.all_reduce(t.double().clone(), mesh, axes)
                for t in tensors]

    def wide_state(init):
        # the recurrent states are f32 by construction
        return lambda *a, **kw: {k: v.double() if v.dtype == torch.float32
                                 else v for k, v in init(*a, **kw).items()}

    def seen(grads, *a, **kw):
        capture(grads)
        return update(grads, *a, **kw)

    layers.DTYPES["float32"] = torch.float64
    torch.Tensor.float = (lambda self, *a, **kw: self
                          if self.dtype == torch.float64 else to32(self))
    if capture is not None:
        adamw.update = seen
    collectives.reduce_f32_buckets = wide_sums
    for lib, init in states.items():
        lib.init_state = wide_state(init)
    try:
        yield
    finally:
        adamw.update, torch.Tensor.float = update, to32
        layers.DTYPES.update(dtypes)
        collectives.reduce_f32_buckets = buckets
        for lib, init in states.items():
            lib.init_state = init


def tp_grads_f64(arch, overrides, weights, batch, data, model):
    """The gradients AdamW receives, gathered whole, with every float the
    model computes in f64 (:func:`in_f64`), on a ``data x model`` mesh,
    or in one process on rank 0 at ``data`` microbatches when ``model``
    is 1: the decomposition's own error, without f32's."""
    from repro_torch.models.bridge import tree_map
    from repro_torch.distributed.sharding import Placement
    one = model == 1
    mesh = None if one else _mesh(data, model)
    if (one and world()[1] != 0) or (not one and mesh is None):
        return None
    got = {}
    with in_f64(lambda g: got.setdefault("grads", g)):
        cfg = config(arch, overrides)
        params = tree_map(torch.Tensor.double,
                          params_from_numpy(weights, "cpu"))
        opt = adamw.AdamWConfig()
        if one:
            ts.make_train_step(cfg, opt, n_micro=data)(
                params, adamw.init(params), _batch(batch))
            grads = got["grads"]
        else:
            step = ts.make_mesh_train_step(cfg, opt, mesh)
            pl = step.placement
            params = pl.local({"params": params})["params"]
            step(params, adamw.init(params), ts.local_rows(_batch(batch),
                                                           mesh))
            grads = Placement(mesh, pl.specs["params"]).gather(got["grads"])
    if mesh is not None and mesh.rank != 0:
        return None
    return {k: v.double().numpy() for k, v in keyed_leaves(grads)}


def one_process_f64(arch, overrides, weights, batch, n_micro, opt):
    """:func:`one_process` with every float in f64 (:func:`in_f64`; the
    moments stay f32): the step f32 rounding would have to reach."""
    from repro_torch.models.bridge import tree_map
    if world()[1] != 0:
        return None
    with in_f64():
        cfg = config(arch, overrides)
        params = tree_map(torch.Tensor.double,
                          params_from_numpy(weights, "cpu"))
        state = adamw.init(params)
        params, state, m = ts.make_train_step(
            cfg, adamw.AdamWConfig(**opt), n_micro=n_micro)(
                params, state, _batch(batch))
    return keyed_numpy({"params": params, "opt": state}), _metrics(m)


def tp_slice_pair(x, w1, w2, c):
    """The second conjugate pair on a ``1x2`` mesh, each rank holding its
    half of ``w1``'s columns and ``w2``'s rows: ``s = sum_to_slice(tanh(x
    w1) w2)``, ``a = tanh(s)``, ``z = gather_from_slice(a)``, and the
    rank's part of ``sum(softmax(z) c) + sum(a^2)`` summed by
    ``reduce_from_model``: s, z, the loss and this rank's gradients."""
    mesh = _mesh(1, 2)
    if mesh is None:
        return None
    mp = collectives.ModelParallel(mesh, {})
    r = mesh.model_index
    t = {k: torch.from_numpy(v).requires_grad_()
         for k, v in dict(x=x, w1=np.split(w1, 2, axis=1)[r],
                          w2=np.split(w2, 2, axis=0)[r]).items()}
    h = torch.tanh(collectives.copy_to_model(t["x"], mp) @ t["w1"])
    s = collectives.sum_to_slice(h @ t["w2"], mp)
    a = torch.tanh(s)
    z = collectives.gather_from_slice(a, mp)
    part = (mp.own(torch.softmax(z, -1)) * mp.own(torch.from_numpy(c))).sum()
    loss = collectives.reduce_from_model(part + a.square().sum(), mp)
    loss.backward()
    out = {"s": s, "z": z, "loss": loss}
    out.update({"d_" + k: v.grad for k, v in t.items()})
    return {k: v.detach().numpy() for k, v in out.items()}, mp.counts


def tp_block_trace(kind, d, width, heads_split, seed=0):
    """One RG-LRU block (``kind`` "rglru", ``width`` its ``dr``) or RWKV-6
    time mix ("rwkv6", ``width`` its ``d_ff``) at model width ``d`` in
    f32, on 2 rows of 40 tokens, in one process and on a ``1x2`` mesh
    (the leaves cut as the placement cuts them): each traced tensor of
    the forward, in order, as rank r holds it and as one process's slice
    of it (``own``: cut to the rank's channels), and the output."""
    from repro_torch.models import rglru, rwkv6
    mesh = _mesh(1, 2)
    if mesh is None:
        return None
    split = {kind if kind == "rglru" else "tm_cm": True,
             "heads": heads_split}
    tp = collectives.ModelParallel(mesh, split)
    gen = torch.Generator().manual_seed(seed)
    cfg = types.SimpleNamespace(d_model=d, num_heads=1, resolved_head_dim=width,
                                d_ff=width, dtype="float32")
    lib = rglru if kind == "rglru" else rwkv6
    init = rglru.rglru_init if kind == "rglru" else rwkv6.rwkv6_init
    params = init(cfg, torch.float32, "cpu", gen)
    for k, v in params.items():
        if v.dtype == torch.float32 and v.dim() == 1:
            params[k] = v + 0.1 * torch.randn(v.shape, generator=gen)
    x = torch.randn(2, 40, d, generator=gen)
    cols = {"rglru": ("w_in", "w_gate_branch", "conv_w"),
            "rwkv6": ("wr", "wk", "wv", "wg")}[kind]
    rows = {"rglru": ("wa", "wx", "w_out"), "rwkv6": ("wo",)}[kind]
    mine = dict(params)
    for k in cols:
        mine[k] = tp.own(params[k], -1)
    for k in rows:
        mine[k] = tp.own(params[k], 0)
    if kind == "rwkv6" and heads_split:
        mine["u"] = tp.own(params["u"], 0)
    seen = []
    record = {"rglru": ("_gates", "_doubling_scan"),
              "rwkv6": ("_projections", "_chunk_closed_form")}[kind]
    real = {n: getattr(lib, n) for n in record}

    def traced(name):
        def call(*a, **kw):
            out = real[name](*a, **kw)
            seen.append((name, a, out))
            return out
        return call
    for n in record:
        setattr(lib, n, traced(n))
    try:
        runs = {}
        for which, p, t in (("one", params, None), ("tp", mine, tp)):
            seen.clear()
            if kind == "rglru":
                st = rglru.init_state(cfg, 2, "cpu", t)
                y, _ = rglru.rglru_block(p, x, st, t)
            else:
                st = rwkv6.init_state(cfg, 2, "cpu", t)
                y, _, _ = rwkv6.time_mix_chunked(p, x, st["S"],
                                                 st["tm_last"], t)
            runs[which] = (list(seen), y)
    finally:
        for n, f in real.items():
            setattr(lib, n, f)
    out = []

    def add(name, got, want, cut=True):
        want = tp.own(want, -1) if cut and want.shape != got.shape else want
        out.append((name, got.detach().numpy(), want.detach().numpy()))
    (one, y1), (mine_seen, y2) = runs["one"], runs["tp"]
    if kind == "rglru":
        (_, a1, g1), (_, a2, g2) = one[0], mine_seen[0]
        add("u (conv output)", a2[1], a1[1])
        add("u @ wa (gate input)", a2[2][0], a1[1] @ params["wa"])
        add("u @ wx (gate input)", a2[2][1], a1[1] @ params["wx"])
        add("log_a", g2[0], g1[0])
        add("gated input", g2[1], g1[1])
        add("h (scan)", mine_seen[1][2], one[1][2])
    else:
        names = ("r", "k", "v", "g", "logw")
        for i, n in enumerate(names):
            got = mine_seen[0][2][i]
            want = one[0][2][i]
            add(n, got, want, cut=got.shape != want.shape)
        ys1, ys2 = (torch.cat([o[2][1] for o in run[1:]], 1).flatten(-2)
                    for run in (one, mine_seen))
        add("y (chunk loop)", ys2, ys1)
    add("output (summed over model)", y2, y1, cut=False)
    return out


def tp_moe_aux(arch, overrides, model, seed=0):
    """One MoE layer of ``arch``'s reduced config in f64 on 2 rows of 16
    tokens, in one process (``moe_apply``) and on a ``1 x model`` mesh
    (``moe_apply_tp`` on the rank's router columns, experts and shared
    experts' slices): the gaps, relative to each tensor's largest
    magnitude, of the aux loss, of its gradients alone to the router
    and the input, and of the gradients of a fixed projection of the
    output to the router, the input and the experts (the rank's router
    columns and experts against one process's same slices); and the
    rank's ``ModelParallel`` counts."""
    from repro_torch.models import moe
    from repro_torch.models.bridge import tree_map
    mesh = _mesh(1, model)
    if mesh is None:
        return None
    cfg = config(arch, overrides)
    gen = torch.Generator().manual_seed(seed)
    full = tree_map(torch.Tensor.double,
                    moe.moe_init(cfg, torch.float32, "cpu", gen))
    x = torch.randn(2, 16, cfg.d_model, generator=gen,
                    dtype=torch.float64)
    c = torch.randn(2, 16, cfg.d_model, generator=gen,
                    dtype=torch.float64)
    tp = collectives.ModelParallel(mesh, {"experts": True, "shared": True})
    mine = dict(full, router=tp.own(full["router"]),
                **{n: tp.own(full[n], 0) for n in ("w_gate", "w_up",
                                                   "w_down")})
    mine["shared"] = {"w_gate": tp.own(full["shared"]["w_gate"]),
                      "w_up": tp.own(full["shared"]["w_up"]),
                      "w_down": tp.own(full["shared"]["w_down"], 0)}
    gaps = {}

    def rel(got, want):
        return float((got - want).abs().max() / want.abs().max())

    runs = {}
    forms = {"one": (full, lambda p, x: moe.moe_apply(p, x, cfg,
                                                      return_aux=True)),
             "tp": (mine, lambda p, x: moe.moe_apply_tp(p, x, cfg, tp,
                                                        return_aux=True))}
    for name, (p, fn) in forms.items():
        p = tree_map(lambda t: t.clone().requires_grad_(), p)
        xi = x.clone().requires_grad_()
        with in_f64():
            out, aux = fn(p, xi)
            d_aux = torch.autograd.grad(aux, (p["router"], xi),
                                        retain_graph=True)
            d_out = torch.autograd.grad((out * c).sum(), (p["router"], xi,
                                                          p["w_gate"]))
        runs[name] = (aux.detach(), d_aux, d_out)
    (aux1, da1, do1), (aux2, da2, do2) = runs["one"], runs["tp"]
    gaps["aux"] = rel(aux2, aux1)
    gaps["d aux / d router"] = rel(da2[0], tp.own(da1[0]))
    gaps["d aux / d x"] = rel(da2[1], da1[1])
    gaps["d out / d router"] = rel(do2[0], tp.own(do1[0]))
    gaps["d out / d x"] = rel(do2[1], do1[1])
    gaps["d out / d w_gate"] = rel(do2[2], tp.own(do1[2], 0))
    return gaps, {k: list(v) for k, v in tp.counts.items()}
