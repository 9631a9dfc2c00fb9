"""Train/prefill/serve step factories with the sharding derivation: the
port of ``src/repro/train/train_step.py``.

The sharding rules live in :mod:`repro_torch.distributed.sharding` and
are resolved against whatever mesh is given: :func:`batch_pspecs`,
:func:`cache_pspecs` and :func:`state_shardings` give the reference's
specs (plain tuples for ``PartitionSpec``s; shapes as meta tensors, not
``ShapeDtypeStruct``s), and :func:`state_placement` the
:class:`~repro_torch.distributed.sharding.Placement` of the trainer's
``{"params", "opt"}`` tree.

:func:`make_mesh_train_step` is the counterpart of the reference's step
jitted under those shardings, for a ``(data, model)`` mesh of processes
(:mod:`repro_torch.launch.mesh`): each rank holds its ``global_batch /
D`` rows and, for a leaf whose spec names ``data`` on a dim, its ``1/D``
slice of that dim (FSDP; the MoE experts' ``moe_ff`` under the default
rules), its AdamW moments the same slice.  With ``model > 1`` the step is
tensor-parallel, as the reference's ``DEFAULT_RULES`` lay it out: a
rank also holds its ``1/M`` of every ``heads``, ``kv_heads``, ``ff``,
``vocab`` and ``experts`` dim that ``model`` divides, and runs the
forward and the backward on those heads, ``ff`` columns, vocab rows and
experts, with the sums over ``model`` that GSPMD and the reference's
expert-parallel ``shard_map`` insert (``collectives.ModelParallel``,
passed down the forward as ``tp``).  Every arch takes it: the attention
text archs, the recurrent ones (their RG-LRU and RWKV-6 blocks on the
rank's channels), the MoE ones (the rank's experts) and the two
frontends.  A block whose dim ``model`` does not divide runs whole on
every rank (``sharding.model_split``, block by block).
"""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import collectives
from repro_torch.distributed import sharding as shd
from repro_torch.models import zoo
from repro_torch.models.blocks import tp_partial
from repro_torch.models.bridge import keyed_map, tree_leaves, tree_map
from repro_torch.optim import accum, adamw

__all__ = ["make_train_step", "make_prefill_step", "make_serve_step",
           "batch_pspecs", "cache_pspecs", "state_shardings",
           "state_placement", "make_mesh_train_step", "local_rows",
           "check_train_mesh"]


# ---------------------------------------------------------------------------
# step functions
# ---------------------------------------------------------------------------


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig, *,
                    n_micro: int = 1, remat: str = "dots"):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: mean loss and gradients over ``n_micro`` microbatches,
    then one AdamW update, which writes the parameters and moments in
    place.  ``metrics`` holds ``lr``, ``grad_norm``, ``loss``, ``ce`` and
    ``aux`` as 0-d tensors."""
    def train_step(params, opt_state, batch):
        def loss_f(p, b):
            return zoo.loss_fn(cfg, p, b, remat=remat)
        loss, aux, grads = accum.accumulate_grads(loss_f, params, batch,
                                                  n_micro)
        params, opt_state, metrics = adamw.update(grads, opt_state, params,
                                                  opt_cfg)
        return params, opt_state, dict(metrics, loss=loss, **aux)

    return train_step


def make_prefill_step(cfg: ArchConfig, *, cache_len: int):
    """``prefill_step(params, batch) -> (logits [B,V], caches)``: the
    one-shot prefill into fresh dense caches of ``cache_len``."""
    def prefill_step(params, batch):
        return zoo.prefill(cfg, params, batch, cache_len=cache_len)

    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """``serve_step(params, caches, token, pos) -> logits [B,V]``: one
    decode step on dense caches, which it updates in place."""
    def serve_step(params, caches, token, pos):
        return zoo.decode_step(cfg, params, caches, token, pos)

    return serve_step


# ---------------------------------------------------------------------------
# sharding derivation
# ---------------------------------------------------------------------------


def _div_axes(size: int, names: tuple[str, ...], mesh) -> tuple[str, ...]:
    """Use the given mesh axes only if ``size`` divides evenly across
    them."""
    prod = 1
    chosen = []
    for n in names:
        if n in mesh.axis_names:
            prod *= mesh.shape[n]
            chosen.append(n)
    if chosen and size % prod == 0:
        return tuple(chosen)
    return ()


def _batch_axes(batch: int, mesh):
    baxes = _div_axes(batch, ("pod", "data"), mesh) or None
    if isinstance(baxes, tuple) and len(baxes) == 1:
        baxes = baxes[0]
    return baxes


def batch_pspecs(cfg: ArchConfig, shape, mesh) -> dict:
    """Specs for the input batch of ``shape`` (a ``ShapeConfig``)."""
    b = shape.global_batch
    baxes = _batch_axes(b, mesh)
    specs: dict = {}
    if shape.kind in ("train", "prefill"):
        specs["tokens"] = (baxes, None)
        if shape.kind == "train":
            specs["labels"] = (baxes, None)
    else:
        specs["token"] = (baxes,)
        specs["pos"] = (baxes,)
        specs["caches"] = cache_pspecs(zoo.init_cache, cfg, b,
                                       shape.seq_len, mesh)
    if cfg.frontend == "vision" and shape.kind != "decode":
        specs["patches"] = (baxes, None, None)
    if cfg.encoder_decoder and shape.kind != "decode":
        specs["frames"] = (baxes, None, None)
    return specs


def cache_pspecs(init_cache_fn, cfg, batch: int, seq_len: int, mesh):
    """Per-leaf cache specs, the cache shapes read on ``meta``: batch over
    (pod, data) when divisible; a long dim (>= 4096) over ``model`` (SP);
    recurrent states batch-sharded only."""
    baxes = _batch_axes(batch, mesh)
    shapes = init_cache_fn(cfg, batch, seq_len, "meta")

    def leaf_spec(x):
        # dims: a leading one may be n_groups (stacked); the batch dim
        # equals `batch`; a long dim is the kv-seq dim
        parts = [None] * x.dim()
        for i, s in enumerate(x.shape):
            if s == batch and parts.count(baxes) == 0 and baxes is not None:
                parts[i] = baxes
            elif s >= 4096 and s % mesh.shape.get("model", 1) == 0 \
                    and "model" not in parts:
                parts[i] = "model"
        return tuple(parts)

    return tree_map(leaf_spec, shapes)


def state_shardings(cfg: ArchConfig, mesh, *, fsdp, with_opt: bool):
    """``(params as meta tensors, their specs[, AdamW state as meta
    tensors, its specs])`` (the last two None without ``with_opt``)."""
    with shd.use_mesh(mesh, fsdp=fsdp):
        aparams, axes = zoo.abstract_params(cfg)
        pspecs = shd.params_pspecs(aparams, axes)
    if not with_opt:
        return aparams, pspecs, None, None
    return aparams, pspecs, adamw.init(aparams), adamw.state_pspecs(pspecs)


def check_train_mesh(shape: dict) -> None:
    """Training shards over ``data`` and ``model``: a mesh ``shape`` with
    any other axis above 1 raises ``ValueError``."""
    if any(n > 1 for ax, n in shape.items() if ax not in ("data", "model")):
        raise ValueError(f"training on mesh {dict(shape)}: a process mesh "
                         "has the axes data and model only")


def state_placement(cfg: ArchConfig, mesh, *, fsdp=True) -> shd.Placement:
    """The placement of the trainer's ``{"params", "opt"}`` tree on
    ``mesh``, a ``(data, model)`` mesh of processes; its ``partial``
    names the parameters (and nothing of the moments) a rank uses only
    in part (``sharding.partial_leaves``)."""
    check_train_mesh(mesh.shape)
    _, pspecs, _, ospecs = state_shardings(cfg, mesh, fsdp=fsdp,
                                           with_opt=True)
    partial = shd.partial_leaves(zoo.init_axes(cfg), pspecs, mesh,
                                 tp_partial)
    return shd.Placement(mesh, {"params": pspecs, "opt": ospecs},
                         ["['params']" + k for k in partial])


def local_rows(batch: dict, mesh) -> dict:
    """This rank's ``1/D`` of every leaf's rows (``batch_pspecs``' data
    entry), each a tensor of its own."""
    specs = {k: ("data",) + (None,) * (v.dim() - 1) for k, v in batch.items()}
    return shd.Placement(mesh, specs).local(batch)


def make_mesh_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig, mesh,
                         *, fsdp=True, n_micro: int = 1,
                         remat: str = "dots"):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)`` on this rank of ``mesh``: ``params`` and ``opt_state`` are
    its slices (``state_placement(...).local`` of a full tree), ``batch``
    its rows.  In order: gather the sliced parameters over ``data`` (a
    rank keeps its ``model`` slices); accumulate the gradients over
    ``n_micro`` microbatches of the local rows, under the tensor-parallel
    forms when ``model > 1``; cast each to f32 and all-reduce the sum
    over ``data`` in a few flat buckets (loss and aux with them; every
    rank of a ``model`` column holds the same rows); sum over ``model``
    the gradients of the leaves a rank uses only in part
    (``placement.partial``); scale by ``1/D``; take the global norm over
    the mesh (``adamw.global_norm`` over the placement); run AdamW on
    this rank's slice with that norm.  Every rank returns the same
    metrics.  With ``D = 2``, ``M = 1`` and ``n_micro = 1`` the step
    equals one process's at ``n_micro = 2`` bit for bit: both cast each
    microbatch's gradient to f32, add the two and scale by 0.5.  With
    ``M > 1`` the sums over ``model`` add the ranks' partial products in
    another order than one device's matrix products, so the step is one
    device's within f32 rounding.  The MoE layer takes its
    expert-parallel form at ``M = 1`` too (``moe.moe_apply_tp``: all
    ``E`` experts, no collective): its capacity counts all of the rank's
    rows of a microbatch, not each
    :data:`~repro_torch.models.moe.GROUP_TOKENS` group's, so a rank
    drops what the reference's shard body drops."""
    placement = state_placement(cfg, mesh, fsdp=fsdp)
    pspecs = placement.specs["params"]
    prefix = len("['params']")
    partial = {k[prefix:] for k in placement.partial}
    on_params = shd.Placement(mesh, pspecs, partial)
    tp = None
    if mesh.shape["model"] > 1:
        split = shd.model_split(zoo.init_axes(cfg), pspecs, mesh)
        tp = collectives.ModelParallel(mesh, split)
        if split.get("heads") and split.get("kv_heads") is False:
            # a chunk of query heads straddling two GQA groups raises
            # here, before any step runs
            tp.kv_span(cfg.num_heads, cfg.num_kv_heads)
    elif cfg.num_experts:
        # M = 1: the MoE layer alone takes its expert-parallel form, so its
        # capacity counts all of the rank's rows, as the reference's shard
        # body does on any mesh with a model axis; every other form reads
        # no split and runs as one device runs it
        tp = collectives.ModelParallel(mesh, {"experts": True})
    inv = 1.0 / mesh.shape["data"]

    def train_step(params, opt_state, batch):
        full = on_params.gather(params, axes=("data",))

        def loss_f(p, b):
            return zoo.loss_fn(cfg, p, b, remat=remat, tp=tp)
        loss, aux, grads = accum.accumulate_grads(loss_f, full, batch,
                                                  n_micro)
        del full
        names = sorted(aux)
        leaves = list(tree_leaves(grads))
        summed = collectives.reduce_f32_buckets(
            leaves + [loss] + [aux[k] for k in names], mesh, "data")
        del leaves
        if partial:
            keys: list[str] = []
            keyed_map(lambda k, _: keys.append(k), grads)
            idx = [i for i, k in enumerate(keys) if k in partial]
            for i, t in zip(idx, tp.sum_buckets([summed[i] for i in idx])):
                summed[i] = t
        it = iter(summed)
        grads = tree_map(lambda _: next(it), grads)
        loss = next(it) * inv
        aux = {k: next(it) * inv for k in names}
        for g in tree_leaves(grads):
            g.mul_(inv)
        gnorm = (adamw.global_norm(grads) if mesh.shape["model"] == 1
                 else adamw.global_norm(grads, on_params, tp))
        mine = on_params.map(
            lambda g, spec: on_params.leaf_local(g, spec, ("data",)), grads)
        params, opt_state, metrics = adamw.update(mine, opt_state, params,
                                                  opt_cfg, gnorm=gnorm)
        return params, opt_state, dict(metrics, loss=loss, **aux)

    train_step.placement = placement
    train_step.tp = tp
    return train_step
