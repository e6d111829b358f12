"""The PyTorch port's dense LM serving path against the JAX package, on the
CPU: ``DecoderLM.prefill`` and ``decode_step`` under both caches
(``FullKV`` and the ``SlidingKV`` ring), the per-layer cache updates, and
decode from a cache carried across with ``convert.kv_cache_from_numpy``.

The same numpy inputs go to both packages; weights reach the port through
:func:`repro_torch.convert.decoder_from_numpy`.  On the CPU the port's
self-attention is ``gqa_attention``, the reference model's own arithmetic.
Tolerances:

* float32 (``smoke_config()`` of nemotron-4-15b and qwen3-32b): logits and
  the cache's k and v within ``atol = rtol = 1e-5`` after prefill and
  after each of three decode steps (matrix products and reductions sum in
  a framework-chosen order; the largest difference seen is 3.1e-6 at
  logits up to 3.7); ``pos`` and ``k_pos`` exactly;
* bfloat16 (parameters and compute): logits, k and v within eight bf16
  steps (``8 * 2**-8``) of JAX's largest value, as
  ``tests/test_torch_rwkv6.py`` holds the bf16 RWKV6 (the two frameworks
  round activations at different places; about two steps seen);
* decode after prefill against prefill over the longer prompt, inside the
  port: ``atol = rtol = 5e-4`` (``tests/test_arch_smoke.py``'s).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import nemotron_4_15b as jax_nemotron
from repro.configs import qwen3_32b as jax_qwen3
from repro.models import kvcache as jkvc
from repro.models.transformer import DecoderLM as JaxDecoderLM
from repro_torch.convert import decoder_from_numpy, kv_cache_from_numpy
from repro_torch.models import kvcache as kvc
from repro_torch.models.config import ModelConfig

CASES = {
    "nemotron": (jax_nemotron, {}, 11),
    "qwen3": (jax_qwen3, {}, 11),            # qk_norm
    "nemotron_sliding": (jax_nemotron, dict(sliding_window=16), 40),
    "nemotron_bf16": (jax_nemotron, dict(param_dtype="bfloat16",
                                         compute_dtype="bfloat16"), 11),
}
F32_TOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _models(mod, kw, seed=0):
    jcfg = mod.smoke_config().replace(**kw)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jm = JaxDecoderLM(jcfg)
    params = jm.init(seed)
    model = decoder_from_numpy(cfg, jax.tree.map(np.asarray, params),
                               device="cpu")
    return jm, params, model, cfg


def _close(got, want, bf16, what):
    want = _np(want)
    if bf16:
        tol = 8 * 2.0 ** -8 * float(np.abs(want).max())
        np.testing.assert_allclose(_np(got), want, atol=tol, rtol=0,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(_np(got), want, atol=F32_TOL,
                                   rtol=F32_TOL, err_msg=what)


def _same_cache(cache, jcache, bf16, what):
    assert type(cache).__name__ == type(jcache).__name__
    for name in ("k", "v"):
        assert tuple(getattr(cache, name).shape) == getattr(jcache, name).shape
        _close(getattr(cache, name), getattr(jcache, name), bf16,
               f"{what}: cache.{name}")
    names = ("pos", "k_pos") if isinstance(cache, kvc.SlidingKV) else ("pos",)
    for name in names:
        np.testing.assert_array_equal(getattr(cache, name).numpy(),
                                      np.asarray(getattr(jcache, name)),
                                      err_msg=f"{what}: cache.{name}")


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_and_decode_match_jax(case):
    mod, kw, S = CASES[case]
    bf16 = "param_dtype" in kw
    jm, params, model, cfg = _models(mod, kw)
    rng = np.random.default_rng(21)
    B, steps = 2, 3
    prompt = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    toks = rng.integers(0, cfg.vocab, (steps, B, 1)).astype(np.int32)
    max_len = S + steps + 2
    jlog, jcache = jm.prefill(params, {"tokens": jnp.asarray(prompt)},
                              max_len=max_len)
    logits, cache = model.prefill({"tokens": torch.from_numpy(prompt)},
                                  max_len=max_len)
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == jlog.shape == (B, 1, cfg.vocab_padded)
    _close(logits, jlog, bf16, "prefill logits")
    _same_cache(cache, jcache, bf16, "prefill")
    if "sliding_window" in kw:
        assert cache.window == 16 and S > cache.window  # the ring wrapped
    for t in range(steps):
        jlog, jcache = jm.decode_step(params, jcache, jnp.asarray(toks[t]))
        logits, cache = model.decode_step(cache, torch.from_numpy(toks[t]))
        assert tuple(logits.shape) == jlog.shape
        _close(logits, jlog, bf16, f"decode step {t} logits")
        _same_cache(cache, jcache, bf16, f"decode step {t}")
    assert int(cache.pos[0]) == S + steps


@pytest.mark.parametrize("sliding", [False, True])
def test_decode_from_carried_jax_cache(sliding):
    """Both packages decode from one cache, JAX's prefill carried across
    by ``kv_cache_from_numpy``."""
    kw = dict(sliding_window=8) if sliding else {}
    jm, params, model, cfg = _models(jax_nemotron, kw, seed=3)
    rng = np.random.default_rng(22)
    prompt = rng.integers(0, cfg.vocab, (3, 13)).astype(np.int32)
    _, jcache = jm.prefill(params, {"tokens": jnp.asarray(prompt)}, max_len=20)
    cache = kv_cache_from_numpy(jcache, device="cpu")
    _same_cache(cache, jcache, False, "carried")
    for t in range(2):
        tok = rng.integers(0, cfg.vocab, (3, 1)).astype(np.int32)
        jlog, jcache = jm.decode_step(params, jcache, jnp.asarray(tok))
        logits, cache = model.decode_step(cache, torch.from_numpy(tok))
        _close(logits, jlog, False, f"decode step {t} logits")
        _same_cache(cache, jcache, False, f"decode step {t}")


def test_kv_cache_from_numpy_keeps_bf16_bits():
    jcfg = jax_nemotron.smoke_config().replace(compute_dtype="bfloat16")
    jc = jkvc.sliding_kv_init(jcfg, 2, 4)
    rng = np.random.default_rng(23)
    k = jnp.asarray(rng.normal(size=jc.k.shape), jnp.bfloat16)
    jc = jkvc.SlidingKV(k=k, v=-k, k_pos=jc.k_pos.at[:, 1].set(5), pos=jc.pos + 6)
    arrays = {n: np.asarray(getattr(jc, n)) for n in ("k", "v", "k_pos", "pos")}
    cache = kv_cache_from_numpy(arrays, device="cpu")
    assert isinstance(cache, kvc.SlidingKV) and cache.k.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(cache.k), _np(k))
    np.testing.assert_array_equal(cache.k_pos.numpy(), np.asarray(jc.k_pos))
    full = kv_cache_from_numpy({n: arrays[n] for n in ("k", "v", "pos")},
                               device="cpu")
    assert isinstance(full, kvc.FullKV) and full.max_len == 4


@pytest.mark.parametrize("start", [0, 5, 9])
def test_cache_layer_updates_match_jax(start):
    """The in-place per-layer writes against the reference's functional
    ones: FullKV at ``pos[0]`` for the whole batch (clamped so the write
    fits, as ``dynamic_update_slice`` does), the ring at ``pos % W`` per
    row."""
    rng = np.random.default_rng(start)
    B, Smax, Hkv, hd = 3, 10, 2, 4
    base = rng.normal(size=(B, Smax, Hkv, hd)).astype(np.float32)
    new = rng.normal(size=(B, 3, Hkv, hd)).astype(np.float32)
    pos = np.array([start, start + 4, 1], np.int32)
    want = jkvc.full_kv_update_layer(*(jnp.asarray(a) for a in (base, base, new, new, pos)))
    got = kvc.full_kv_update_layer(*(torch.from_numpy(a.copy()) for a in (base, base, new, new, pos)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))
    want = jkvc.sliding_kv_update_layer(*(jnp.asarray(a) for a in (base, base, new[:, :1], new[:, :1], pos)))
    got = kvc.sliding_kv_update_layer(*(torch.from_numpy(a.copy()) for a in (base, base, new[:, :1], new[:, :1], pos)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_np(g), _np(w))


@pytest.mark.parametrize("sliding", [False, True])
def test_decode_matches_longer_prefill(sliding):
    """Decode after prefill equals prefill over the prompt plus the decoded
    tokens (``atol = rtol = 5e-4``), the ring past its wrap included."""
    kw = dict(sliding_window=8) if sliding else {}
    _, _, model, cfg = _models(jax_nemotron, kw, seed=4)
    g = torch.Generator().manual_seed(5)
    seq = torch.randint(0, cfg.vocab, (2, 17), generator=g, dtype=torch.int32)
    _, cache = model.prefill({"tokens": seq[:, :12]}, max_len=17)
    for t in range(12, 17):
        logits, cache = model.decode_step(cache, seq[:, t:t + 1])
        want, _ = model.prefill({"tokens": seq[:, :t + 1]})
        torch.testing.assert_close(logits, want, atol=5e-4, rtol=5e-4)
