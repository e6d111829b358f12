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

:func:`adamw_update_` updates the state in place and writes the
parameters, a group of leaves at a time: a model whose state fills most
of the card needs that (rwkv6-3b: 35 GB of float32 state beside 5.8 GB of
bf16 parameters and 11.6 GB of float32 gradients on an 80 GB H100), and
the train step uses it.  :func:`adamw_update` is the reference's pure
form -- a new state and new parameters -- run as :func:`adamw_update_`
on a copy of the state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Tuple

import torch

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "adamw_update_",
           "cosine_lr", "global_norm", "GROUP_ELEMS"]

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
    modified: :func:`adamw_update_` on a copy of it."""
    names = list(grads)
    state = {**opt_state, **{k: {n: opt_state[k][n].clone() for n in names}
                             for k in ("master", "m", "v")}}
    new_params = {n: torch.empty(state["master"][n].shape, dtype=param_dtype,
                                 device=state["master"][n].device)
                  for n in names}
    metrics = adamw_update_(cfg, grads, state, new_params, param_dtype)
    return new_params, state, metrics


# the leaves an in-place update takes at once: consecutive leaves up to
# this many elements (or one larger leaf), so that its float32
# temporaries stay within a few times 0.5 GB
GROUP_ELEMS = 1 << 27


def _groups(names, tensors: Mapping[str, torch.Tensor]):
    group, size = [], 0
    for n in names:
        if group and size + tensors[n].numel() > GROUP_ELEMS:
            yield group
            group, size = [], 0
        group.append(n)
        size += tensors[n].numel()
    if group:
        yield group


def adamw_update_(
    cfg: AdamWConfig,
    grads: Mapping[str, torch.Tensor],     # any float dtype
    opt_state: State,
    params: Mapping[str, torch.Tensor],    # the model's parameters
    param_dtype: torch.dtype,
) -> Dict[str, torch.Tensor]:
    """One AdamW step in place: ``opt_state``'s ``master``, ``m`` and
    ``v`` tensors are updated and its ``step`` replaced, and each
    parameter in ``params`` is written with its new master rounded to
    ``param_dtype`` (then to its own dtype).  Returns the metrics
    ``grad_norm`` and ``lr``.

    Per element, in the reference's order::

        g = g * scale;  m = b1 m + (1 - b1) g;  v = b2 v + ((1 - b2) g) g
        p = p - lr (m / bc1 / (sqrt(v / bc2) + eps) + wd p)

    as ``torch._foreach_*`` ops over one group of leaves (``GROUP_ELEMS``)
    at a time -- the same float32 operations as one leaf at a time, a few
    launches a group instead of a dozen a leaf -- so that beside the
    state, the gradients and the parameters it holds only one group's
    temporaries."""
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
    fm, fa, fd = torch._foreach_mul, torch._foreach_add, torch._foreach_div
    for names in _groups(list(grads), grads):
        g = fm([grads[n].to(torch.float32) for n in names], scale)
        m = [opt_state["m"][n] for n in names]
        v = [opt_state["v"][n] for n in names]
        master = [opt_state["master"][n] for n in names]
        torch._foreach_mul_(m, cfg.b1)
        torch._foreach_add_(m, fm(g, 1 - cfg.b1))
        torch._foreach_mul_(v, cfg.b2)
        torch._foreach_add_(v, fm(fm(g, 1 - cfg.b2), g))
        del g
        upd = fd(fd(m, bc1), fa(torch._foreach_sqrt(fd(v, bc2)), cfg.eps))
        torch._foreach_add_(upd, fm(master, cfg.weight_decay))
        torch._foreach_sub_(master, fm(upd, lr))
        del upd
        with torch.no_grad():
            torch._foreach_copy_([params[n] for n in names],
                                 [x.to(param_dtype) for x in master])
    opt_state["step"] = step
    return {"grad_norm": gnorm, "lr": lr}
