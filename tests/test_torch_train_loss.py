"""The port's training losses and their gradients against the JAX
package, on the CPU: every family's smoke config -- dense with a
frontend (featinsight-fraud), ``moe`` (moonshot-v1-16b-a3b), RWKV6,
RecurrentGemma and the seamless encoder-decoder.

The same weights (the JAX model's ``init(0)``, carried by the
``*_from_numpy`` converters) and the same batch
(``test_arch_smoke._batch_for``) go to both; the port's gradients come
back in the reference's tree layout through
:func:`repro_torch.convert.reference_tree`.  Tolerances (float32):

* the loss and every metric within ``rtol = 1e-5`` (``tokens`` and the
  MoE dropped fraction exactly: they count);
* each gradient leaf within ``2e-4`` of that leaf's largest |g| (JAX's
  jitted XLA and PyTorch's eager kernels sum products, softmaxes and the
  backward's transposed products in other orders; over a few layers and
  a 512-entry vocabulary that stays near 1e-5 of the leaf's scale, and
  the bound leaves a margin for the MoE router's and RWKV6's decay
  gradients, which pass through exp of exp).

The JAX side runs ``jax.value_and_grad(model.loss)`` under ``jax.jit``.
The port's losses rematerialize every block with
``torch.utils.checkpoint``; the recomputation must give the same
gradients as a pass that keeps its activations, which is checked too.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke_config
from repro.models import build_model as jax_build_model
from repro_torch import convert
from repro_torch.models.config import ModelConfig
from test_arch_smoke import _batch_for

ARCHS = ["featinsight-fraud", "moonshot-v1-16b-a3b", "rwkv6-3b",
         "recurrentgemma-9b", "seamless-m4t-medium"]
FROM_NUMPY = {"dense": convert.decoder_from_numpy,
              "moe": convert.decoder_from_numpy,
              "rwkv": convert.rwkv6_from_numpy,
              "griffin": convert.griffin_from_numpy,
              "encdec": convert.encdec_from_numpy}
LOSS_RTOL = 1e-5
GRAD_TOL = 2e-4


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), np.asarray(tree, np.float32)


def _setup(arch):
    jcfg = jax_smoke_config(arch)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jm = jax_build_model(jcfg)
    params = jm.init(0)
    model = FROM_NUMPY[cfg.family](cfg, jax.tree.map(np.asarray, params),
                                   device="cpu")
    batch = _batch_for(jcfg)
    tbatch = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    return jm, params, batch, model, tbatch


def _port_grads(model, tbatch):
    names = convert.reference_names(model)
    own = dict(model.named_parameters())
    loss, metrics = model.loss(tbatch)
    gs = torch.autograd.grad(loss, [own[n] for n in names])
    tree = convert.tree_to_numpy(
        convert.reference_tree(model, dict(zip(names, gs))))
    return loss, metrics, tree


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_jax(arch):
    jm, params, batch, model, tbatch = _setup(arch)
    (jloss, jmetrics), jgrads = jax.jit(
        jax.value_and_grad(jm.loss, has_aux=True))(params, batch)
    loss, metrics, grads = _port_grads(model, tbatch)
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=LOSS_RTOL)
    assert set(metrics) == set(jmetrics)
    for k, v in jmetrics.items():
        if k in ("tokens", "moe_dropped_frac"):
            assert float(metrics[k]) == float(v), k
        else:
            np.testing.assert_allclose(float(metrics[k]), float(v),
                                       rtol=LOSS_RTOL, err_msg=k)
    want = dict(_flat(jax.tree.map(np.asarray, jgrads)))
    got = dict(_flat(grads))
    assert list(got) == list(want)
    for path, w in want.items():
        g = got[path]
        assert g.shape == w.shape, path
        scale = float(np.abs(w).max())
        err = float(np.abs(g - w).max())
        assert err <= GRAD_TOL * scale + 1e-12, (path, err, scale)
    assert any(float(np.abs(w).max()) > 0 for w in want.values())


@pytest.mark.parametrize("arch", ["featinsight-fraud", "seamless-m4t-medium"])
def test_rematerialized_blocks_give_the_kept_pass_gradients(arch,
                                                            monkeypatch):
    """``checkpoint`` recomputes each block in the backward pass; with it
    replaced by a plain call the gradients are the same bits."""
    import repro_torch.models.encdec as encdec
    import repro_torch.models.transformer as transformer

    _, _, _, model, tbatch = _setup(arch)
    remat = dict(_flat(_port_grads(model, tbatch)[2]))
    for mod in (transformer, encdec):
        monkeypatch.setattr(mod, "checkpoint",
                            lambda fn, *a, use_reentrant: fn(*a))
    kept = dict(_flat(_port_grads(model, tbatch)[2]))
    assert list(remat) == list(kept)
    for path in remat:
        np.testing.assert_array_equal(remat[path], kept[path], err_msg=path)


def test_cross_entropy_loss_matches_jax():
    """Ignored labels (-1), an all-ignored batch (denominator 1) and the
    z-loss, against the reference's ``cross_entropy_loss``."""
    from repro.models.layers import cross_entropy_loss as jax_ce
    from repro_torch.models.layers import cross_entropy_loss

    rng = np.random.default_rng(3)
    logits = rng.normal(size=(3, 7, 11)).astype(np.float32) * 4
    labels = rng.integers(-1, 11, (3, 7)).astype(np.int32)
    for lab in (labels, np.full_like(labels, -1)):
        for z in (0.0, 1e-3):
            jl, jm = jax_ce(logits, lab, z_loss=z)
            tl, tm = cross_entropy_loss(torch.from_numpy(logits),
                                        torch.from_numpy(lab), z_loss=z)
            np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
            assert set(tm) == set(jm)
            assert int(tm["tokens"]) == int(jm["tokens"])
            for k in jm:
                np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                           rtol=1e-6, err_msg=k)
