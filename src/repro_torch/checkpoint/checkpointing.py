"""Atomic checkpoints in the reference's on-disk format (no orbax, no
``ml_dtypes``): the port of ``src/repro/checkpoint/checkpointing.py``.

Layout:  <dir>/step_<N>/
             manifest.json     keys, shapes, logical dtypes, shard map,
                               the caller's ``extra`` state
             shard_<k>.npz     arrays, packed to ~512 MB per shard
Keys are the strings ``jax.tree_util.keystr`` gives the same tree
(``['params']['groups'][0]['attn']['wq']``; a NamedTuple field is
``['opt'].m[...]``), and bf16 is stored as its ``uint16`` bits with the
logical dtype ``"bfloat16"`` in the manifest, so a checkpoint written by
either package restores in the other.  Writes go to ``step_<N>.tmp``
then ``os.replace``: a crash mid-write never corrupts the latest complete
checkpoint; ``keep_n`` newest are kept.  A shard is written as soon as it
is full and a restore reads one shard at a time, so the host holds at
most one shard of arrays beside the tree.
"""

from __future__ import annotations

import json
import os
import shutil
import time

import numpy as np
import torch

from repro_torch.models.bridge import _is_namedtuple, keyed_leaves

__all__ = ["save", "restore", "latest_step", "Checkpointer", "keyed_leaves"]

_SHARD_BYTES = 512 * 1024 * 1024


def _rebuild(tree, leaf_fn, prefix: str = ""):
    """``tree`` with every leaf replaced by ``leaf_fn(key string, leaf)``."""
    if isinstance(tree, dict):
        return {k: _rebuild(v, leaf_fn, f"{prefix}[{k!r}]")
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(_rebuild(getattr(tree, n), leaf_fn,
                                     f"{prefix}.{n}") for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rebuild(v, leaf_fn, f"{prefix}[{i}]")
                          for i, v in enumerate(tree))
    return leaf_fn(prefix, tree)


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array as stored, logical dtype name); numpy has no bfloat16, so a
    bf16 leaf is stored as its uint16 bits."""
    t = torch.as_tensor(leaf).detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.contiguous().view(torch.int16).numpy().view(np.uint16), \
            "bfloat16"
    arr = t.numpy()
    return arr, str(arr.dtype)


def _from_numpy(arr: np.ndarray, stored: str) -> torch.Tensor:
    if stored == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr)


def save(directory: str, step: int, tree, *, extra: dict | None = None,
         keep_n: int = 3) -> str:
    """Atomically write ``tree`` (params / optimizer state) at ``step``."""
    final = os.path.join(directory, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)

    keys: dict[str, dict] = {}
    shard: dict[str, np.ndarray] = {}
    size = 0
    n_shards = 0

    def flush():
        np.savez(os.path.join(tmp, f"shard_{n_shards}.npz"),
                 **{k.replace("/", "\x1f"): v for k, v in shard.items()})

    for key, leaf in keyed_leaves(tree):
        arr, dtype = _to_numpy(leaf)
        if size + arr.nbytes > _SHARD_BYTES and shard:
            flush()
            n_shards += 1
            shard, size = {}, 0
        shard[key] = arr
        size += arr.nbytes
        keys[key] = {"shard": n_shards, "shape": list(arr.shape),
                     "dtype": dtype}
    flush()
    manifest = {"step": step, "keys": keys, "extra": extra or {},
                "n_shards": n_shards + 1}
    with open(os.path.join(tmp, "manifest.json"), "w") as fh:
        json.dump(manifest, fh)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)
    _gc(directory, keep_n)
    return final


def _gc(directory: str, keep_n: int) -> None:
    for s in sorted(_steps(directory))[:-keep_n]:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def _steps(directory: str) -> list[int]:
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return out


def latest_step(directory: str) -> int | None:
    steps = _steps(directory)
    return max(steps) if steps else None


def restore(directory: str, step: int | None, like):
    """Rebuild a tree structured like ``like`` from the checkpoint at
    ``step`` (the latest when None): every leaf takes its ``like`` leaf's
    dtype and device.  Returns ``(tree, extra, step)``."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as fh:
        manifest = json.load(fh)
    wanted = dict(keyed_leaves(like))
    missing = [k for k in wanted if k not in manifest["keys"]]
    if missing:
        raise KeyError(f"checkpoint missing {missing[0]}")
    out: dict[str, torch.Tensor] = {}
    for i in range(manifest["n_shards"]):
        with np.load(os.path.join(path, f"shard_{i}.npz")) as z:
            for name in z.files:
                key = name.replace("\x1f", "/")
                if key not in wanted:
                    continue
                ref = torch.as_tensor(wanted[key])
                t = _from_numpy(z[name], manifest["keys"][key]["dtype"])
                out[key] = t.to(device=ref.device, dtype=ref.dtype)
    tree = _rebuild(like, lambda key, _: out[key])
    return tree, manifest["extra"], step


class Checkpointer:
    """Interval-driven checkpointing with a SmartConf-controllable interval
    (``train.ckpt_interval_steps``, direct and soft: recovery time against
    the share of wall time spent writing checkpoints)."""

    def __init__(self, directory: str, *, interval_steps: int = 100,
                 keep_n: int = 3) -> None:
        self.directory = directory
        self.interval_steps = max(1, int(interval_steps))
        self.keep_n = keep_n
        self.last_saved = None
        self.write_seconds = 0.0
        self.writes = 0

    def set_interval(self, steps: int) -> None:
        self.interval_steps = max(1, int(steps))

    def maybe_save(self, step: int, tree, *, extra: dict | None = None,
                   force: bool = False) -> str | None:
        if not force and step % self.interval_steps != 0:
            return None
        t0 = time.monotonic()
        out = save(self.directory, step, tree, extra=extra, keep_n=self.keep_n)
        self.write_seconds += time.monotonic() - t0
        self.writes += 1
        self.last_saved = step
        return out
