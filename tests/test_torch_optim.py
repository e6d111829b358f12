"""The port's AdamW, cosine schedule and int8 error-feedback compression
against the JAX package, on the CPU.

* ``cosine_lr`` over warmup, decay and the floor within 1 float32 ulp-ish
  (``rtol = 1e-6``: the same float32 formula; ``cos`` may round its last
  bit differently).
* ``adamw_update`` over 3 steps on the same numpy gradients, with the
  global-norm clip active and inactive: parameters, master, m and v
  within ``rtol = 1e-5`` plus ``1e-6`` of the leaf's largest |value|
  (float32, the same formula in the same order; ``b ** step`` and the
  global norm's sum may round differently, and ``m`` cancels where
  successive gradients change sign), the metrics within ``rtol = 1e-5``;
  ``step`` exactly.
* ``quantize_int8`` / ``dequantize_int8`` / ``ef_compress_tree`` bit for
  bit (both round half to even): a leaf not a multiple of 256, zeros,
  huge and tiny values, and three steps of error feedback.
* The error-feedback contract: after T steps the dequantized gradients
  plus the last residual add up to the raw gradients' sum (to float32
  rounding), and every residual is within half a quantization step of
  its block.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro_torch.optim import adamw, compress


def _tree(rng):
    return {
        "embed": {"table": rng.normal(size=(37, 16)).astype(np.float32)},
        "layers": {"w": rng.normal(size=(3, 16, 24)).astype(np.float32),
                   "ln": {"scale": np.ones((3, 16), np.float32)}},
        "out": rng.normal(size=(5,)).astype(np.float32),
    }


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], prefix + (k,))
    else:
        yield "/".join(prefix), tree


def _t(tree):
    return {p: torch.from_numpy(np.array(v, np.float32)) for p, v in _flat(tree)}


def test_cosine_lr_matches_jax():
    cfg = adamw.AdamWConfig(warmup_steps=20, decay_steps=100)
    jcfg = jadamw.AdamWConfig(warmup_steps=20, decay_steps=100)
    steps = np.arange(0, 140, dtype=np.float32)
    want = np.array([float(jadamw.cosine_lr(jcfg, jnp.float32(s)))
                     for s in steps])
    got = np.array([float(adamw.cosine_lr(cfg, torch.tensor(s)))
                    for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got[0] == 0.0
    np.testing.assert_allclose(got[-1], cfg.lr_min, rtol=1e-6)  # the floor


@pytest.mark.parametrize("clip", [1.0, 1e9])
def test_adamw_update_matches_jax(clip):
    rng = np.random.default_rng(5)
    params = _tree(rng)
    kw = dict(warmup_steps=2, decay_steps=10, grad_clip=clip)
    jcfg, cfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    jstate = jadamw.adamw_init(jax.tree.map(jnp.asarray, params))
    state = adamw.adamw_init(_t(params))
    for step in range(3):
        grads = jax.tree.map(
            lambda x: (rng.normal(size=x.shape) * 3).astype(np.float32),
            params)
        jnew, jstate, jm = jadamw.adamw_update(
            jcfg, jax.tree.map(jnp.asarray, grads), jstate, jnp.float32)
        new, state, m = adamw.adamw_update(cfg, _t(grads), state,
                                           torch.float32)
        if clip == 1.0:
            assert float(jm["grad_norm"]) > clip  # the clip is active
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
        assert int(state["step"]) == int(jstate["step"]) == step + 1
        trees = [(new, jnew)] + [(state[k], jstate[k])
                                 for k in ("master", "m", "v")]
        for got, want in trees:
            want = dict(_flat(jax.tree.map(np.asarray, want)))
            assert list(got) == list(want)
            for p, w in want.items():
                np.testing.assert_allclose(
                    got[p].numpy(), w, rtol=1e-5,
                    atol=1e-6 * float(np.abs(w).max()), err_msg=p)


def test_adamw_writes_the_param_dtype_and_leaves_the_state_alone():
    rng = np.random.default_rng(1)
    params = _tree(rng)
    state = adamw.adamw_init(_t(params))
    before = {k: {p: t.clone() for p, t in state[k].items()}
              for k in ("master", "m", "v")}
    grads = {p: torch.ones_like(t) for p, t in _t(params).items()}
    new, new_state, _ = adamw.adamw_update(adamw.AdamWConfig(), grads, state,
                                           torch.bfloat16)
    assert all(t.dtype == torch.bfloat16 for t in new.values())
    assert all(t.dtype == torch.float32 for t in new_state["master"].values())
    for k, tree in before.items():
        for p, t in tree.items():
            assert torch.equal(state[k][p], t)
    assert int(state["step"]) == 0 and int(new_state["step"]) == 1


def test_adamw_update_in_place_by_groups_is_the_same_step(monkeypatch):
    """``adamw_update_`` (the train step's, in place) a group of leaves at
    a time gives the bits of ``adamw_update`` with every leaf in one group
    over 3 steps: master, m, v, step, the metrics, and the parameters
    written in their own dtypes (bf16 and float32 leaves)."""
    rng = np.random.default_rng(4)
    flat = dict(_flat(_tree(rng)))
    params = {k: torch.from_numpy(v).to(
        torch.float32 if "ln" in k else torch.bfloat16) for k, v in flat.items()}
    cfg = adamw.AdamWConfig(warmup_steps=2, decay_steps=5, grad_clip=0.5)
    pure = adamw.adamw_init(params)
    state = adamw.adamw_init(params)
    live = {n: p.clone() for n, p in params.items()}
    assert len(list(adamw._groups(list(live), live))) == 1
    for _ in range(3):
        grads = {n: torch.from_numpy(rng.normal(size=p.shape).astype(
            np.float32)) for n, p in params.items()}
        new, pure, pm = adamw.adamw_update(cfg, grads, pure, torch.bfloat16)
        with monkeypatch.context() as mp:
            mp.setattr(adamw, "GROUP_ELEMS", 600)
            assert len(list(adamw._groups(list(live), live))) == 4
            m = adamw.adamw_update_(cfg, grads, state, live, torch.bfloat16)
        for k in ("grad_norm", "lr"):
            assert torch.equal(m[k], pm[k])
        assert torch.equal(state["step"], pure["step"])
        for n in params:
            for k in ("master", "m", "v"):
                assert torch.equal(state[k][n], pure[k][n]), (k, n)
            assert torch.equal(live[n], new[n].to(live[n].dtype)), n


def _leaves(rng):
    return [
        rng.normal(size=(1000,)).astype(np.float32),         # 1000 % 256
        np.zeros((3, 256), np.float32),                      # all zero
        (rng.normal(size=(7, 33)) * 1e30).astype(np.float32),  # huge
        np.concatenate([np.full(5, 3.0e38, np.float32),
                        rng.normal(size=300).astype(np.float32) * 1e-30]),
        np.array([0.5, -0.5, 1.5, 2.5, -2.5, 127.0], np.float32) / 127,
    ]


def test_quantize_int8_bit_for_bit():
    rng = np.random.default_rng(2)
    for x in _leaves(rng):
        jq, js = jcompress.quantize_int8(jnp.asarray(x))
        q, s = compress.quantize_int8(torch.from_numpy(x))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(s.numpy().view(np.int32),
                                      np.asarray(js).view(np.int32))
        jd = jcompress.dequantize_int8(jq, js, x.shape)
        d = compress.dequantize_int8(q, s, x.shape)
        np.testing.assert_array_equal(d.numpy().view(np.int32),
                                      np.asarray(jd).view(np.int32))


def test_ef_compress_tree_bit_for_bit_and_the_feedback_contract():
    rng = np.random.default_rng(4)
    shapes = {"a": (1000,), "b": {"c": (3, 300)}, "d": (7,)}
    zeros = jax.tree.map(lambda s: np.zeros(s, np.float32), shapes,
                         is_leaf=lambda s: isinstance(s, tuple))
    jres = jax.tree.map(jnp.asarray, zeros)
    res = _t(zeros)
    raw_sum = {p: np.zeros(v.shape, np.float64) for p, v in _flat(zeros)}
    deq_sum = {p: np.zeros(v.shape, np.float64) for p, v in _flat(zeros)}
    for _ in range(3):
        g = jax.tree.map(lambda z: rng.normal(size=z.shape).astype(np.float32),
                         zeros)
        jdeq, jres = jcompress.ef_compress_tree(
            jax.tree.map(jnp.asarray, g), jres)
        deq, res = compress.ef_compress_tree(_t(g), res)
        for got, want in ((deq, jdeq), (res, jres)):
            for p, w in _flat(jax.tree.map(np.asarray, want)):
                np.testing.assert_array_equal(
                    got[p].numpy().view(np.int32), w.view(np.int32),
                    err_msg=p)
        for p, v in _flat(g):
            raw_sum[p] += v
            deq_sum[p] += deq[p].numpy()
            # the residual is what quantization dropped: at most half a
            # step (max |deq| / 127 of the leaf bounds every block's step)
            assert np.abs(res[p].numpy()).max() <= np.abs(
                deq[p].numpy()).max() / 127 + 1e-6
    for p in raw_sum:
        np.testing.assert_allclose(deq_sum[p] + res[p].numpy(), raw_sum[p],
                                   rtol=0, atol=1e-5, err_msg=p)
