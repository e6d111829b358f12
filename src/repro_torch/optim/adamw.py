"""AdamW with float32 master weights and a cosine learning rate.

The reference package's ``repro.optim.adamw`` with its formula and its
operation order.  The state is ``{master, m, v, step}``: ``master``, ``m``
and ``v`` map each parameter name to a float32 tensor on the parameter's
device, ``step`` is an int32 scalar tensor.  Gradients and parameters are
mappings name -> tensor whose order is the reference's leaf order
(:func:`repro_torch.convert.reference_names`): the global norm sums the
leaves in that order.

Every scalar of the schedule and of the bias corrections is float32, as
in the reference (``b1 ** step`` in float32, not as a Python float power),
and the Python constants (``b1``, ``1 - b1``, ``lr_min / lr_peak``, ...)
enter rounded to float32, as JAX's weakly typed constants do.

``torch.optim.AdamW`` is not used: its weight decay multiplies the
parameter before the Adam step and its ``eps`` sits elsewhere.  The
reference's ZeRO-1 sharding of the state has no meaning on one card.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Tuple

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "cosine_lr",
           "global_norm"]

State = Dict[str, object]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 200
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup to ``lr_peak``, then a cosine to ``lr_min`` over
    ``decay_steps``; ``step`` a float32 scalar tensor."""
    dev = step.device
    warm = torch.minimum(step / _f32(max(cfg.warmup_steps, 1), dev),
                         _f32(1.0, dev))
    prog = torch.clamp(
        (step - _f32(cfg.warmup_steps, dev)) / _f32(max(cfg.decay_steps, 1), dev),
        0.0, 1.0)
    cos = _f32(0.5, dev) * (_f32(1.0, dev)
                            + torch.cos(_f32(math.pi, dev) * prog))
    ratio = cfg.lr_min / cfg.lr_peak
    return (_f32(cfg.lr_peak, dev) * warm
            * (_f32(ratio, dev) + _f32(1 - ratio, dev) * cos))


def adamw_init(params: Mapping[str, torch.Tensor]) -> State:
    """float32 copies of ``params`` (``master``), zero ``m`` and ``v``,
    ``step`` 0, on the parameters' devices."""
    some = next(iter(params.values()))
    return {
        "master": {n: p.detach().to(torch.float32, copy=True)
                   for n, p in params.items()},
        "m": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in params.items()},
        "v": {n: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
              for n, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=some.device),
    }


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every leaf's sum of squares (float32), the
    leaves summed in the mapping's order."""
    total = None
    for x in tree.values():
        sq = torch.sum(torch.square(x.to(torch.float32)))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


def adamw_update(
    cfg: AdamWConfig,
    grads: Mapping[str, torch.Tensor],   # any float dtype
    opt_state: State,
    param_dtype: torch.dtype,
) -> Tuple[Dict[str, torch.Tensor], State, Dict[str, torch.Tensor]]:
    """(new params in ``param_dtype``, new state, metrics ``grad_norm`` and
    ``lr``).  The state's tensors are new ones; ``opt_state`` is not
    modified.

    Per element, in the reference's order::

        g = g * scale;  m = b1 m + (1 - b1) g;  v = b2 v + ((1 - b2) g) g
        p = p - lr (m / bc1 / (sqrt(v / bc2) + eps) + wd p)

    as ``torch._foreach_*`` ops over all leaves at once (the same float32
    operations as one leaf at a time, a few launches instead of a dozen a
    leaf)."""
    step = opt_state["step"] + 1
    dev = step.device
    stepf = step.to(torch.float32)
    lr = cosine_lr(cfg, stepf)

    gnorm = global_norm(grads)
    scale = torch.minimum(_f32(1.0, dev),
                          _f32(cfg.grad_clip, dev)
                          / torch.maximum(gnorm, _f32(1e-9, dev)))
    one = _f32(1.0, dev)
    bc1 = one - _f32(cfg.b1, dev) ** stepf
    bc2 = one - _f32(cfg.b2, dev) ** stepf

    # Python scalars enter the foreach kernels rounded to float32, as
    # JAX's weakly typed constants do
    names = list(grads)
    fm, fa, fd = torch._foreach_mul, torch._foreach_add, torch._foreach_div
    g = fm([grads[n].to(torch.float32) for n in names], scale)
    m = fa(fm([opt_state["m"][n] for n in names], cfg.b1), fm(g, 1 - cfg.b1))
    v = fa(fm([opt_state["v"][n] for n in names], cfg.b2),
           fm(fm(g, 1 - cfg.b2), g))
    del g
    upd = fd(fd(m, bc1), fa(torch._foreach_sqrt(fd(v, bc2)), cfg.eps))
    master = [opt_state["master"][n] for n in names]
    upd = fa(upd, fm(master, cfg.weight_decay))
    p = torch._foreach_sub(master, fm(upd, lr))
    del upd
    new_params = {n: x.to(param_dtype) for n, x in zip(names, p)}
    state = {**opt_state, "master": dict(zip(names, p)),
             "m": dict(zip(names, m)), "v": dict(zip(names, v)),
             "step": step}
    return new_params, state, {"grad_norm": gnorm, "lr": lr}
