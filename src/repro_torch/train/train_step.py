"""The step factories: the port of ``src/repro/train/train_step.py``'s
``make_train_step``, ``make_prefill_step`` and ``make_serve_step``.  Its
sharding derivation waits for ROADMAP Queue 1 item 11b."""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import zoo
from repro_torch.optim import accum, adamw

__all__ = ["make_train_step", "make_prefill_step", "make_serve_step"]


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
