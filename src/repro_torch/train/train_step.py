"""The train step factory: the port of
``src/repro/train/train_step.py::make_train_step``.  Its sharding
derivation, ``make_prefill_step`` and ``make_serve_step`` wait for ROADMAP
Queue 1 items 11 and 5b."""

from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.models import zoo
from repro_torch.optim import accum, adamw

__all__ = ["make_train_step"]


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
