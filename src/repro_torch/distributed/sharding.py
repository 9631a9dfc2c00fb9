"""The active serving mesh.

The serving part of the reference's ``distributed/sharding.py``: a
thread-local context (:func:`use_mesh`, :func:`current_mesh`) that the
attention and MoE wrappers read to learn whether a serving mesh is live.
The mesh is the port's own :class:`repro_torch.launch.mesh.ServeMesh`
(one process per mesh position), not a JAX mesh.  Serving shards
attention heads and MoE experts over ``model`` and nothing else; the
wrappers that do so say it themselves, so no rule table is read.

Training's sharding (the logical-axis rule tables, ``logical_spec``,
``shard``, ``params_pspecs`` and FSDP) is ROADMAP Queue 1 item 11b and
not ported.
"""

from __future__ import annotations

import contextlib
import threading

__all__ = ["use_mesh", "current_mesh"]


class _Ctx(threading.local):
    def __init__(self):
        self.mesh = None


_CTX = _Ctx()


@contextlib.contextmanager
def use_mesh(mesh):
    """Activate ``mesh`` for the calls inside."""
    prev = _CTX.mesh
    _CTX.mesh = mesh
    try:
        yield mesh
    finally:
        _CTX.mesh = prev


def current_mesh():
    """The mesh :func:`use_mesh` activated on this thread, or None."""
    return _CTX.mesh
