"""The train step: microbatched gradient accumulation + AdamW.

The reference package's ``repro.train.step`` on one card.  With
``num_microbatches`` nm > 1 the batch is split ``(nm, b / nm, ...)`` and
the microbatches run in order: each one's loss is differentiated with
``torch.autograd.grad`` and its gradients added into an accumulator of
``grad_dtype`` (not ``.grad`` accumulation, which would add in the
parameters' dtype), then divided by nm in float32.  The step's loss is
the mean of the microbatch losses and ``nll`` the mean of theirs.  Then
the optional int8 error-feedback round trip (``compress_pod_grads``,
state ``ef_residual``), then AdamW in place
(:func:`~repro_torch.optim.adamw.adamw_update_`, the same bits as the pure
:func:`~repro_torch.optim.adamw.adamw_update`): the optimizer state given
to the step is updated and returned, and the new parameters are written
into the model -- the state is never held twice, so rwkv6-3b's 35 GB of
it trains on one 80 GB card.

The reference's ``constrain_gacc`` pins the accumulator to a ZeRO-2
sharding of its mesh; one H100 has no mesh, so it has no counterpart.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Tuple

import torch

from repro_torch.convert import reference_names
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update_
from repro_torch.optim.compress import ef_compress_tree

__all__ = ["TrainSettings", "build_train_step", "init_opt_state"]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class TrainSettings:
    num_microbatches: int = 1
    grad_dtype: str = "bfloat16"
    compress_pod_grads: bool = False
    opt: AdamWConfig = AdamWConfig()


def _params(model) -> Dict[str, torch.nn.Parameter]:
    """The model's parameters in the reference's leaf order."""
    own = dict(model.named_parameters())
    return {n: own[n] for n in reference_names(model)}


def init_opt_state(model, settings: TrainSettings) -> Dict:
    """AdamW's state for ``model`` (and zero ``ef_residual`` when the
    settings compress)."""
    params = _params(model)
    state = adamw_init(params)
    if settings.compress_pod_grads:
        state["ef_residual"] = {n: torch.zeros_like(m)
                                for n, m in state["m"].items()}
    return state


def build_train_step(model, cfg: ModelConfig, settings: TrainSettings
                     ) -> Callable[[Dict, Dict], Tuple[Dict, Dict]]:
    """``train_step(opt_state, batch) -> (opt_state, metrics)``: one
    optimizer step of ``model`` on ``batch`` (tensors on the model's
    device), the parameters and ``opt_state`` (returned) updated in
    place.  Metrics: ``loss``, ``nll``,
    ``grad_norm``, ``lr`` (and ``tokens`` with one microbatch), float32
    scalar tensors."""
    nm = settings.num_microbatches
    gdt = _DTYPES[settings.grad_dtype]
    params = _params(model)
    plist = list(params.values())

    def grads_of(batch):
        loss, metrics = model.loss(batch)
        gs = torch.autograd.grad(loss, plist, allow_unused=True)
        gs = [torch.zeros_like(p) if g is None else g
              for g, p in zip(gs, plist)]
        return loss.detach(), metrics, gs

    def train_step(opt_state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        if nm == 1:
            loss, metrics, gs = grads_of(batch)
            metrics = {k: v.detach() for k, v in metrics.items()}
            grads = {n: g.to(torch.float32) for n, g in zip(params, gs)}
        else:
            for name, x in batch.items():
                if x.shape[0] % nm:
                    raise ValueError(
                        f"train_step: batch {name} of {x.shape[0]} rows does "
                        f"not split into {nm} microbatches")
            gacc = [torch.zeros(p.shape, dtype=gdt, device=p.device)
                    for p in plist]
            losses, nlls = [], []
            for i in range(nm):
                mb = {k: x.reshape(nm, x.shape[0] // nm, *x.shape[1:])[i]
                      for k, x in batch.items()}
                loss_i, m, gs = grads_of(mb)
                torch._foreach_add_(gacc, [g.to(gdt) for g in gs])
                del gs
                losses.append(loss_i)
                nlls.append(m["nll"].detach())
            grads = {n: a.to(torch.float32) / nm for n, a in zip(params, gacc)}
            del gacc
            loss = torch.stack(losses).mean()
            metrics = {"nll": torch.stack(nlls).mean()}
        if settings.compress_pod_grads:
            grads, opt_state["ef_residual"] = ef_compress_tree(
                grads, opt_state["ef_residual"])
        opt_metrics = adamw_update_(settings.opt, grads, opt_state, params,
                                    cfg.pdtype)
        del grads
        return opt_state, {**metrics, **opt_metrics, "loss": loss}

    return train_step
