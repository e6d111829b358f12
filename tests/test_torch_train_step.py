"""The port's train step (``build_train_step``) against the JAX package's
jitted step, on the CPU: featinsight-fraud's smoke config (dense, with
its patch frontend) from the same weights on the same batch, with one
and two microbatches, float32 and bfloat16 gradient accumulation, and the
int8 error-feedback round trip.

Comparison rule for the new parameters.  At step 1 Adam's update is
``lr·g/(|g| + eps)`` plus the decay, i.e. about ``lr·sign(g)``: where a
gradient element is tiny -- ``|g| <= 1e-2`` of its leaf's largest |g|,
which covers the gradients' own bound (``2e-4`` of the leaf's scale,
``tests/test_torch_train_loss.py``) and int8's zero bin (half a step of
max/127) -- the two packages' signs may differ and
``|Δp_port - Δp_jax| <= 2·lr₁·(1 + wd·|p|)``; elsewhere the signs agree
and ``|Δp_port - Δp_jax| <= 1e-3·lr₁``.  The loss, ``nll`` and
``grad_norm`` within ``rtol = 1e-4`` (bfloat16 accumulation: ``2e-3``),
``lr`` within ``1e-6``; the first moment ``m`` within ``1e-3`` of its
leaf's largest value (bfloat16 accumulation, or int8 compression where an
element on a rounding boundary moves by one step of 1/127 of its block's
largest value: ``1e-2``).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro.optim.adamw import AdamWConfig as JaxAdamWConfig
from repro.optim.adamw import adamw_init as jax_adamw_init
from repro.train.step import TrainSettings as JaxTrainSettings
from repro.train.step import build_train_step as jax_build_train_step
from repro_torch import convert
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import (
    TrainSettings,
    build_train_step,
    init_opt_state,
)
from test_arch_smoke import _batch_for

OPT = dict(warmup_steps=2, decay_steps=10, weight_decay=0.1)


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), np.asarray(tree, np.float32)


@pytest.mark.parametrize("nm,grad_dtype,compress", [
    (1, "float32", False),
    (2, "float32", False),
    (2, "bfloat16", False),
    (2, "float32", True),
])
def test_train_step_matches_jax(nm, grad_dtype, compress):
    jcfg = jax_smoke_config("featinsight-fraud")
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jm = jax_build_model(jcfg)
    params = jm.init(0)
    p0 = dict(_flat(jax.tree.map(np.asarray, params)))
    batch = _batch_for(jcfg, B=4)
    jset = JaxTrainSettings(num_microbatches=nm, grad_dtype=grad_dtype,
                            compress_pod_grads=compress,
                            opt=JaxAdamWConfig(**OPT))
    jopt = jax_adamw_init(params)
    if compress:
        jopt["ef_residual"] = jax.tree.map(np.zeros_like, jopt["m"])
    jnew, jopt, jmetrics = jax.jit(jax_build_train_step(jm, jcfg, jset))(
        params, jopt, batch)
    # the gradients themselves, to tell tiny elements apart
    (_, _), jgrads = jax.jit(jax.value_and_grad(jm.loss, has_aux=True))(
        params, batch)
    g_leaf = dict(_flat(jax.tree.map(np.asarray, jgrads)))

    model = convert.decoder_from_numpy(cfg, jax.tree.map(np.asarray, params),
                                       device="cpu")
    settings = TrainSettings(num_microbatches=nm, grad_dtype=grad_dtype,
                             compress_pod_grads=compress,
                             opt=AdamWConfig(**OPT))
    step = build_train_step(model, cfg, settings)
    opt = init_opt_state(model, settings)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    opt, metrics = step(opt, tbatch)

    bf16 = grad_dtype == "bfloat16"
    rtol = 2e-3 if bf16 else 1e-4
    assert set(metrics) == set(jmetrics)
    for k in ("loss", "nll", "grad_norm"):
        np.testing.assert_allclose(float(metrics[k]), float(jmetrics[k]),
                                   rtol=rtol, err_msg=k)
    np.testing.assert_allclose(float(metrics["lr"]), float(jmetrics["lr"]),
                               rtol=1e-6)
    lr1 = float(jmetrics["lr"])
    assert int(opt["step"]) == 1

    got = dict(_flat(convert.decoder_to_numpy(model)))
    want = dict(_flat(jax.tree.map(np.asarray, jnew)))
    assert list(got) == list(want)
    for path, w in want.items():
        d_port, d_jax = got[path] - p0[path], w - p0[path]
        g = g_leaf[path]
        tiny = np.abs(g) <= 1e-2 * np.abs(g).max()
        bound = np.where(tiny, 2 * lr1 * (1 + OPT["weight_decay"]
                                          * np.abs(p0[path])), 1e-3 * lr1)
        excess = np.abs(d_port - d_jax) - bound
        assert excess.max() <= 0, (path, float(excess.max()),
                                   int(tiny.sum()), tiny.size)
    m_port = convert.adamw_state_to_numpy(model, opt)["m"]
    m_tol = 1e-2 if bf16 or compress else 1e-3
    for path, w in _flat(jax.tree.map(np.asarray, jopt["m"])):
        m = dict(_flat(m_port))[path]
        assert np.abs(m - w).max() <= m_tol * np.abs(w).max() + 1e-12, path
    if compress:
        res = convert.adamw_state_to_numpy(model, opt)["ef_residual"]
        assert [p for p, _ in _flat(res)] == [
            p for p, _ in _flat(jax.tree.map(np.asarray, jopt["ef_residual"]))]


def test_microbatches_split_in_order_and_accumulate_in_grad_dtype():
    """nm = 2 on a batch whose halves are the same rows: the step equals
    nm = 1 on one half (the mean of two equal microbatches); and a batch
    that does not split raises."""
    jcfg = jax_smoke_config("featinsight-fraud")
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    half = {k: np.array(v) for k, v in _batch_for(jcfg, B=2).items()}
    twice = {k: torch.from_numpy(np.concatenate([v, v])) for k, v in half.items()}
    runs = []
    for nm, batch in ((1, {k: torch.from_numpy(v) for k, v in half.items()}),
                      (2, twice)):
        from repro_torch.models import build_model

        model = build_model(cfg, seed=3, device="cpu")
        s = TrainSettings(num_microbatches=nm, grad_dtype="float32",
                          opt=AdamWConfig(**OPT))
        opt, metrics = build_train_step(model, cfg, s)(
            init_opt_state(model, s), batch)
        runs.append((convert.decoder_to_numpy(model), metrics))
    (p1, m1), (p2, m2) = runs
    np.testing.assert_allclose(float(m2["loss"]), float(m1["loss"]),
                               rtol=1e-6)
    for (path, a), (_, b) in zip(_flat(p1), _flat(p2)):
        np.testing.assert_allclose(b, a, rtol=0, atol=1e-7, err_msg=path)
    from repro_torch.models import build_model

    model = build_model(cfg, seed=3, device="cpu")
    s = TrainSettings(num_microbatches=3, opt=AdamWConfig(**OPT))
    with pytest.raises(ValueError, match="microbatches"):
        build_train_step(model, cfg, s)(init_opt_state(model, s), twice)
