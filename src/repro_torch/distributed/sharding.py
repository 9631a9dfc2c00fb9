"""Logical-axis sharding rules (DP/FSDP/TP/EP), MaxText-style: the port of
``src/repro/distributed/sharding.py``.

Models annotate each parameter with *logical* dim names (the axes tree,
:func:`repro_torch.models.zoo.abstract_params`); this module maps them to
the axes of whatever mesh is active.  :func:`params_pspecs` turns the
axes tree into one spec a leaf, adding the ZeRO/FSDP rule that shards a
large parameter's biggest still-replicated dim over ``data``.

A spec is a plain tuple with one entry per dimension: ``None``, a mesh
axis name, or a tuple of axis names, as ``jax.sharding.PartitionSpec``
holds them.  The spec functions read only ``mesh.axis_names`` and
``mesh.shape``, so any object with those two serves: the port's
:class:`~repro_torch.launch.mesh.ServeMesh` (one process per mesh
position), or the reference's 3-axis ``(pod, data, model)`` shape, which
the port never builds.

:func:`use_mesh` activates a mesh, its rule overlay and the FSDP mode on
this thread; the serving wrappers read :func:`current_mesh` (the serve
engine passes :data:`SERVE_TP_RULES` and ``fsdp=False``, as the
reference's does).  :class:`Placement` is where a tree's leaves lie on a
mesh of processes: :meth:`Placement.local` cuts a full tree to this
rank's slices, :meth:`Placement.gather` puts the slices back together
(over all axes, or over ``data`` alone for the tensor-parallel step).
:func:`model_split` reads which logical families, and which blocks'
``ff`` dims, a placement splits over ``model``, and
:func:`partial_leaves` which replicated leaves a rank then uses only in
part: what the tensor-parallel training step
(``train_step.make_mesh_train_step``) builds its forms from.

Not ported: ``shard`` and ``named_sharding`` (hints to a compiler about
an activation's placement: a rank of the port already holds only its own
rows and slices, so no result depends on them) and the ``shard_map``
alias (the port runs one process per mesh position instead).
"""

from __future__ import annotations

import contextlib
import dataclasses
import re
import threading

__all__ = ["AxisRules", "DEFAULT_RULES", "SERVE_TP_RULES", "use_mesh",
           "current_mesh", "logical_spec", "params_pspecs",
           "FSDP_THRESHOLD", "Axes", "A", "Placement", "keyed_specs",
           "model_split", "partial_leaves", "TP_FAMILIES", "FF_OWNERS",
           "TP_SPLITS"]


@dataclasses.dataclass(frozen=True)
class Axes:
    """Logical dim names for one parameter: a leaf of the axes tree, which
    mirrors the params tree leaf for leaf."""

    names: tuple

    def __iter__(self):
        return iter(self.names)


def A(*names: str | None) -> Axes:
    return Axes(tuple(names))


# logical axis -> preferred mesh axes (first available wins)
DEFAULT_RULES: dict[str, tuple[str, ...]] = {
    "batch": ("pod", "data"),       # DP: batch over pod x data
    "seq": (),                      # activations: sequence replicated
    "kv_seq": ("model",),           # SP: sequence-sharded decode KV caches
    "embed": (),                    # d_model replicated
    "heads": ("model",),            # TP: attention heads
    "kv_heads": ("model",),
    "ff": ("model",),               # TP: FFN hidden
    "vocab": ("model",),            # TP: embedding/logits vocab dim
    "experts": ("model",),          # EP: MoE expert dim
    "moe_ff": ("data",),            # EP: expert hidden dim (resident 2D)
    "expert_cap": (),
    "fsdp": ("data",),              # ZeRO/FSDP axis for large weights
    "state": (),                    # recurrent state dims
    "ctl": ("data",),               # controller batches (tensor_controller)
}

FSDP_THRESHOLD = 2**20  # params larger than 1M elements get FSDP sharding

# Serving tensor-parallel rule overlay: only the attention-head family
# (and MoE experts) shards over the model axis; everything else stays
# replicated, so the per-head math is the single-device program's.
SERVE_TP_RULES: dict[str, tuple[str, ...]] = {
    "batch": (),
    "kv_seq": (),
    "ff": (),
    "vocab": (),
    "moe_ff": (),
    "fsdp": (),
    "ctl": (),
}


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None
        self.rules: dict[str, tuple[str, ...]] = dict(DEFAULT_RULES)
        self.fsdp: bool | str = True


_CTX = _Ctx()
AxisRules = dict


@contextlib.contextmanager
def use_mesh(mesh, rules: dict | None = None, fsdp: bool | str = True):
    """Activate ``mesh``, the rules (``DEFAULT_RULES`` overlaid with
    ``rules``) and the FSDP mode (True, False or ``"residual"``: only
    leaves no rule shards) for the calls inside."""
    prev = (_CTX.mesh, _CTX.rules, _CTX.fsdp)
    _CTX.mesh = mesh
    _CTX.rules = dict(DEFAULT_RULES, **(rules or {}))
    _CTX.fsdp = fsdp
    try:
        yield mesh
    finally:
        _CTX.mesh, _CTX.rules, _CTX.fsdp = prev


def current_mesh():
    """The mesh :func:`use_mesh` activated on this thread, or None."""
    return _CTX.mesh


def _resolve(name: str, taken: set[str], dim_size: int | None = None
             ) -> tuple[str, ...]:
    """Mesh axes for one logical name (skipping axes not in the mesh, axes
    already used by another dim of the same tensor, and, when
    ``dim_size`` is known, axes that would not divide the dimension
    evenly)."""
    mesh = _CTX.mesh
    if mesh is None:
        return ()
    axes = []
    prod = 1
    for ax in _CTX.rules.get(name, ()):
        if ax in mesh.axis_names and ax not in taken:
            if dim_size is not None and dim_size % (prod * mesh.shape[ax]):
                continue
            prod *= mesh.shape[ax]
            axes.append(ax)
            taken.add(ax)
    return tuple(axes)


def _part(axes: tuple[str, ...]):
    return axes if len(axes) > 1 else (axes[0] if axes else None)


def logical_spec(*names: str | None) -> tuple:
    """The spec of a tensor annotated with logical dim names."""
    taken: set[str] = set()
    return tuple(None if n is None else _part(_resolve(n, taken))
                 for n in names)


def _leaf_pspec(axes_names: tuple, shape: tuple[int, ...]) -> tuple:
    """Logical names -> spec for one parameter, with FSDP: shard the
    largest still-replicated dim over the data axis for big params."""
    taken: set[str] = set()
    parts: list = [None if n is None else _part(_resolve(n, taken, shape[i]))
                   for i, n in enumerate(axes_names)]
    mesh = _CTX.mesh
    residual_only = _CTX.fsdp == "residual"
    if (mesh is not None and _CTX.fsdp and "data" not in taken
            and "data" in mesh.axis_names
            and not (residual_only and taken)):
        size = 1
        for s in shape:
            size *= s
        if size >= FSDP_THRESHOLD:
            data_size = mesh.shape["data"]
            # biggest unsharded, divisible dim gets the fsdp axis
            cands = [i for i, p in enumerate(parts)
                     if p is None and shape[i] % data_size == 0]
            if cands:
                i = max(cands, key=lambda j: shape[j])
                parts[i] = "data"
    return tuple(parts)


def params_pspecs(params, logical_tree):
    """A params tree (tensors, meta tensors or anything with ``shape``) and
    its parallel tree of :class:`Axes` -> a tree of specs."""
    if isinstance(params, dict):
        return {k: params_pspecs(v, logical_tree[k])
                for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return type(params)(params_pspecs(p, a)
                            for p, a in zip(params, logical_tree))
    return _leaf_pspec(tuple(logical_tree.names), tuple(params.shape))


def _spec_axes(part) -> tuple[str, ...]:
    """The mesh axes one spec entry names (``()`` for None)."""
    if part is None:
        return ()
    return (part,) if isinstance(part, str) else tuple(part)


def _is_spec(x) -> bool:
    # the trees' containers are dicts, lists and NamedTuples: a plain
    # tuple is a spec
    return isinstance(x, tuple) and not hasattr(x, "_fields")


def _map_spec(fn, tree, specs):
    """``fn(leaf, spec)`` over a tree and its parallel spec tree (a spec
    is a plain tuple, so the walk stops at it)."""
    if isinstance(tree, dict):
        return {k: _map_spec(fn, v, specs[k]) for k, v in tree.items()}
    if hasattr(tree, "_fields"):
        return type(tree)(*(_map_spec(fn, v, s)
                            for v, s in zip(tree, specs)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_spec(fn, v, s) for v, s in zip(tree, specs))
    assert _is_spec(specs), specs
    return fn(tree, specs)


def keyed_specs(specs, prefix: str = ""):
    """(key string, spec) pairs with ``bridge.keyed_leaves``' keys for
    the tree the spec tree mirrors."""
    if _is_spec(specs):
        yield prefix, specs
    elif isinstance(specs, dict):
        for k in sorted(specs):
            yield from keyed_specs(specs[k], f"{prefix}[{k!r}]")
    elif hasattr(specs, "_fields"):
        for name in specs._fields:
            yield from keyed_specs(getattr(specs, name), f"{prefix}.{name}")
    else:
        for i, v in enumerate(specs):
            yield from keyed_specs(v, f"{prefix}[{i}]")


class Placement:
    """Where a tree's leaves lie on a mesh of processes: ``specs`` mirrors
    the tree (one spec a leaf, ``()`` for a 0-d leaf) and ``mesh`` is this
    rank's view of the mesh.  A leaf whose spec names axes on dim ``i`` is
    held as this rank's contiguous share of dim ``i``, its index along
    those axes taken row-major (``jax.sharding`` lays shards out so).

    ``partial`` holds the keys (``bridge.keyed_leaves``') of leaves that
    are replicated over ``model`` yet used only in part on a rank, so
    that a rank's gradient of one is a part of the whole, summed over
    ``model`` by the step: ``wk``/``wv`` when the query heads are split
    over ``model`` and the KV heads are not, the recurrent blocks'
    gate biases, token-shift mixes and decay when ``ff`` is
    (``partial_leaves``)."""

    def __init__(self, mesh, specs, partial=()) -> None:
        self.mesh = mesh
        self.specs = specs
        self.partial = frozenset(partial)

    def _coord(self, axes) -> tuple[int, int]:
        """(this rank's index along ``axes``, their size)."""
        index = {"data": self.mesh.data_index, "model": self.mesh.model_index}
        i, n = 0, 1
        for ax in axes:
            i = i * self.mesh.shape[ax] + index[ax]
            n *= self.mesh.shape[ax]
        return i, n

    def leaf_local(self, x, spec, axes=None):
        """This rank's slice of ``x`` (a view), cut on every dim split
        over mesh axes within ``axes`` (all axes when None): with
        ``axes=("data",)`` a leaf already cut to its ``model`` slice
        gives this rank's slice of it."""
        for dim, group in self.sharded_dims(spec):
            if axes is not None and not set(group) <= set(axes):
                if set(group) & set(axes):
                    raise ValueError(f"dim {dim} is split over {group}, "
                                     f"cut over {axes}")
                continue
            i, n = self._coord(group)
            size = x.shape[dim] // n
            x = x.narrow(dim, i * size, size)
        return x

    def local(self, tree):
        """This rank's slices of a full tree: each sliced leaf a tensor of
        its own, each whole one the tree's own."""
        def cut(x, spec):
            y = self.leaf_local(x, spec)
            return x if y.shape == x.shape else y.clone()
        return _map_spec(cut, tree, self.specs)

    def sharded_dims(self, spec) -> list[tuple[int, tuple[str, ...]]]:
        """(dim, mesh axes) of every dim of ``spec`` split over more than
        one rank."""
        return [(d, _spec_axes(p)) for d, p in enumerate(spec)
                if self._coord(_spec_axes(p))[1] > 1]

    def splits_model(self, spec) -> bool:
        """Whether ``spec`` splits a dim over ``model`` (more than one
        rank)."""
        return any("model" in axes for _, axes in self.sharded_dims(spec))

    def gather(self, tree, axes=None):
        """The tree gathered over ``axes`` (every axis when None) from
        this rank's slices (a collective: every rank calls it)."""
        from .collectives import gather_leaves
        return gather_leaves(tree, self, axes)

    def map(self, fn, tree):
        """``fn(leaf, spec)`` over ``tree`` and the specs."""
        return _map_spec(fn, tree, self.specs)


# the logical families tensor-parallel training splits over ``model``
TP_FAMILIES = ("heads", "kv_heads", "vocab", "experts")
# the blocks whose ``ff`` leaves tensor-parallel training splits over
# ``model``, each on its own (the subtree a leaf sits in): the dense MLP,
# the RG-LRU, the RWKV-6 block, the MoE layer's shared experts
FF_OWNERS = ("mlp", "rglru", "tm_cm", "shared")
# the entries of :func:`model_split`'s result
TP_SPLITS = TP_FAMILIES + FF_OWNERS


def _ff_owner(key: str) -> str:
    """The block (one of :data:`FF_OWNERS`) whose ``ff`` dim the leaf
    ``key`` (``bridge.keyed_leaves``') carries: the innermost subtree of
    its path that names one."""
    names = [n for n in re.findall(r"\['([^']*)'\]", key)
             if n in FF_OWNERS]
    if not names:
        raise ValueError(f"{key}: an 'ff' dim outside the blocks "
                         f"{FF_OWNERS}")
    return names[-1]


def model_split(axes_tree, specs, mesh) -> dict[str, bool]:
    """Which logical families (``heads``, ``kv_heads``, ``vocab``,
    ``experts``) and which blocks' ``ff`` dims (:data:`FF_OWNERS`, keyed
    by the block: :func:`_ff_owner`) the parameter specs split over
    ``model``, read from every leaf that names one: an entry is split
    when its leaves' dim carries ``model`` (``_resolve`` leaves it out
    when ``model`` does not divide the dim).  Two blocks may differ, as
    the reference's ``_resolve`` lets them (recurrentgemma-9b at ``M =
    3``: the MLP's ``d_ff`` split, the RG-LRU's ``dr`` whole).  Raises
    ``ValueError`` if two leaves of one family, or two ``ff`` leaves of
    one block, disagree."""
    pl = Placement(mesh, specs)
    seen: dict[str, bool] = {}
    where: dict[str, str] = {}
    axes_of = dict(_keyed_axes(axes_tree))
    for key, spec in keyed_specs(specs):
        for dim, name in enumerate(axes_of[key]):
            if name == "ff":
                entry = _ff_owner(key)
            elif name in TP_FAMILIES:
                entry = name
            else:
                continue
            split = any(d == dim and "model" in a
                        for d, a in pl.sharded_dims(spec))
            if seen.setdefault(entry, split) != split:
                what = f"{entry}'s 'ff'" if name == "ff" else repr(name)
                raise ValueError(f"{key} and {where[entry]} place the "
                                 f"{what} dim differently over model")
            where.setdefault(entry, key)
    return seen


def partial_leaves(axes_tree, specs, mesh, in_part) -> list[str]:
    """Keys of the leaves a rank uses only in part: the ``kv_heads``
    leaves left replicated over ``model`` while the query heads are
    split (each rank's query chunk reads only its span of the KV heads),
    and every leaf whose key ends with one of the suffixes ``in_part``
    gives for :func:`model_split`'s result (``models.blocks.tp_partial``:
    the recurrent blocks' leaves)."""
    split = model_split(axes_tree, specs, mesh)
    keyed = list(_keyed_axes(axes_tree))
    out = []
    if split.get("heads") and not split.get("kv_heads", True):
        out = [k for k, names in keyed if "kv_heads" in names]
    ends = tuple(in_part(split))
    return out + [k for k, _ in keyed if ends and k.endswith(ends)]


def _keyed_axes(axes_tree, prefix: str = ""):
    """(key, logical names) of every leaf of an axes tree, with
    ``bridge.keyed_leaves``' keys."""
    if isinstance(axes_tree, Axes):
        yield prefix, tuple(axes_tree.names)
    elif isinstance(axes_tree, dict):
        for k in sorted(axes_tree):
            yield from _keyed_axes(axes_tree[k], f"{prefix}[{k!r}]")
    else:
        for i, v in enumerate(axes_tree):
            yield from _keyed_axes(v, f"{prefix}[{i}]")
