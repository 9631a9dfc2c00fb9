"""Sharded KV block store: mesh placement for the serve engine's caches.

The port of the reference's ``serve/block_store.py`` for a mesh of
processes.  The engine's KV state — paged physical block stores ``[N,
Kv, T, D]`` or dense per-slot rings ``[B, n, Kv, D]`` — shards over the
serving mesh's ``model`` axis on the **Kv head dim**: each rank holds
only its contiguous chunk of the KV heads, the chunk the attention
wrappers of :mod:`repro_torch.distributed.collectives` read.  Everything
that is not a K/V plane (dense ``pos`` planes, recurrent scan state)
stays whole on every rank.

* **Host-side allocator stays device-count-agnostic.**  Block *indices*
  (``PagedKVAllocator`` free lists, leases, block tables) are global
  logical names and the same on every rank; only the backing tensors
  shard.  Budget shrinks, demand grows and copy-on-write move whole
  blocks along the block axis and never touch the Kv dim, so they keep
  a rank's slice its own.
* **Indivisible head counts stay whole.**  A leaf whose Kv dim the model
  axis does not divide keeps every head (the reference replicates it).
"""

from __future__ import annotations

__all__ = ["parse_mesh_spec", "build_serve_mesh", "CacheShardingPlan"]


def parse_mesh_spec(spec: str) -> tuple[int, int]:
    """``"DxM"`` -> ``(data, model)``, e.g. ``"2x4"`` -> ``(2, 4)``."""
    parts = str(spec).lower().replace(" ", "").split("x")
    try:
        if len(parts) != 2:
            raise ValueError
        data, model = int(parts[0]), int(parts[1])
    except ValueError:
        raise ValueError(
            f"mesh spec {spec!r} is not 'DxM' (e.g. '2x4' = data=2, model=4)"
        ) from None
    if data < 1 or model < 1:
        raise ValueError(f"mesh spec {spec!r}: both axes must be >= 1")
    return data, model


def build_serve_mesh(spec: str, *, heads: int, kv_heads: int,
                     prefill_impl: str):
    """Resolve a ``"DxM"`` serving-mesh request into this rank's
    :class:`~repro_torch.launch.mesh.ServeMesh`.

    Serving TP rides the packed stream and needs the model axis to divide
    both head counts (contiguous GQA-preserving head chunks), and one rank
    per mesh position (the process group's world size stands for the
    reference's visible devices).  An infeasible request raises with the
    reasons.  The reference's ``REPRO_SERVE_MESH`` sweep, which degrades
    an infeasible forced mesh to one device, has no counterpart: the port
    reads no environment variable."""
    from repro_torch.launch.mesh import make_host_mesh, world

    data, model = parse_mesh_spec(spec)
    problems = []
    if prefill_impl != "packed":
        problems.append(f"prefill_impl={prefill_impl!r} (TP ticks ride the "
                        "packed stream)")
    if model > 1 and (heads % model or kv_heads % model):
        problems.append(f"model={model} does not divide heads={heads} / "
                        f"kv_heads={kv_heads}")
    n = world()[0]
    if data * model > n:
        problems.append(f"mesh {data}x{model} needs {data * model} devices, "
                        f"{n} visible (start {data * model} ranks with "
                        "launch.mesh.spawn_mesh)")
    if problems:
        raise ValueError(f"serve mesh {spec!r} is infeasible: "
                         + "; ".join(problems))
    return make_host_mesh(data=data, model=model)


def _leaves(tree, path=()):
    """``(path, leaf)`` for every tensor of nested dicts and lists."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (i,))
    else:
        yield path, tree


def _map(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)


class CacheShardingPlan:
    """Per-leaf placement of an engine cache tree over the serving mesh.

    K/V planes shard on the Kv head dim over ``model`` (paged stores
    ``[N, Kv, T, D]`` at axis 1, group-stacked ``[G, N, Kv, T, D]`` at 2;
    dense rings ``[B, n, Kv, D]`` at 2, stacked at 3); every other leaf
    — and any Kv dim the axis does not divide — stays whole.  Specs are
    tuples of mesh axis names (None = whole), ``()`` for a whole leaf, as
    a ``PartitionSpec`` reads."""

    def __init__(self, mesh, *, paged: bool):
        self.mesh = mesh
        self.paged = paged
        self.model_size = int(mesh.shape["model"])

    def _axis(self, path, leaf) -> int | None:
        if not path or path[-1] not in ("k", "v") or leaf.dim() not in (4, 5):
            return None
        if self.paged:
            return 1 if leaf.dim() == 4 else 2
        return 2 if leaf.dim() == 4 else 3

    def leaf_spec(self, path, leaf) -> tuple:
        ax = self._axis(path, leaf)
        if ax is None or leaf.shape[ax] % self.model_size:
            return ()
        parts = [None] * leaf.dim()
        parts[ax] = "model"
        return tuple(parts)

    def place(self, caches):
        """This rank's slice of a full cache tree: each sharded leaf's
        contiguous Kv chunk (a new tensor; the full one is freed with the
        caller's tree)."""
        r = self.mesh.model_index

        def one(path, a):
            if "model" not in self.leaf_spec(path, a):
                return a
            ax = self._axis(path, a)
            n = a.shape[ax] // self.model_size
            return a.narrow(ax, r * n, n).clone()

        return _map(one, caches)

    def shard_bytes(self, caches) -> int:
        """Per-rank bytes of a full cache tree under this plan.  For a
        paged store (K/V planes only) ``shard_bytes * model_size`` equals
        the single-device total exactly."""
        total = 0
        for path, a in _leaves(caches):
            denom = (self.model_size if "model" in self.leaf_spec(path, a)
                     else 1)
            total += a.numel() * a.element_size() // denom
        return total
