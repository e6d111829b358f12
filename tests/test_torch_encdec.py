"""The PyTorch port's encoder-decoder (``EncDecLM``, seamless-m4t-medium's
backbone) against the JAX package, on the CPU.

The same numpy frames and tokens go to both packages; weights reach the
port through :func:`repro_torch.convert.encdec_from_numpy`, a JAX serving
state through :func:`repro_torch.convert.encdec_state_from_numpy`.  On
the CPU the port's encoder and decoder self-attention is
``gqa_attention``, the reference's own; the JAX model runs under
``jax.jit``.  Tolerances (``smoke_config()``):
logits, the encoder output and the state's float leaves (``self.k`` /
``self.v``, ``cross_k`` / ``cross_v``) within ``atol = rtol = 1e-5`` in
float32 and eight bf16 steps of JAX's largest value in bf16, as
``tests/test_torch_decoder_lm.py`` holds the dense decoder; positions
(``self.pos``, ``enc_positions``) exactly — after prefill and after each
of three decode steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import seamless_m4t_medium as jax_seamless
from repro.models import encdec as jencdec
from repro_torch.convert import encdec_from_numpy, encdec_state_from_numpy
from repro_torch.models.config import ModelConfig

F32_TOL = 1e-5
BF16 = dict(param_dtype="bfloat16", compute_dtype="bfloat16")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, bf16, what):
    want = _np(want)
    if bf16:
        atol = 8 * 2.0 ** -8 * float(np.abs(want).max())
        np.testing.assert_allclose(_np(got), want, atol=atol, rtol=0,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(_np(got), want, atol=F32_TOL,
                                   rtol=F32_TOL, err_msg=what)


class _Jitted:
    """A JAX model whose ``encode``, ``prefill`` (``max_len`` static) and
    ``decode_step`` run under ``jax.jit``."""

    def __init__(self, model):
        self.model, self.cfg = model, model.cfg
        self.encode = jax.jit(model.encode)
        self.prefill = jax.jit(model.prefill, static_argnums=2)
        self.decode_step = jax.jit(model.decode_step)

    def __getattr__(self, name):
        return getattr(self.model, name)


def _models(kw, seed=0):
    jcfg = jax_seamless.smoke_config().replace(**kw)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jm = _Jitted(jencdec.EncDecLM(jcfg))
    params = jm.init(seed)
    model = encdec_from_numpy(cfg, jax.tree.map(np.asarray, params),
                              device="cpu")
    return jm, params, model, cfg


def _inputs(cfg, B=2, Se=24, S=11, steps=3, seed=51):
    rng = np.random.default_rng(seed)
    frames = rng.normal(size=(B, Se, cfg.d_model)).astype(np.float32)
    prompt = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    toks = rng.integers(0, cfg.vocab, (steps, B, 1)).astype(np.int32)
    return frames, prompt, toks


def _same_state(state, jstate, bf16, what):
    assert set(state) == set(jstate)
    cache, jcache = state["self"], jstate["self"]
    for name in ("k", "v"):
        assert tuple(getattr(cache, name).shape) == getattr(jcache, name).shape
        _close(getattr(cache, name), getattr(jcache, name), bf16,
               f"{what}: self.{name}")
    np.testing.assert_array_equal(cache.pos.numpy(), np.asarray(jcache.pos))
    for name in ("cross_k", "cross_v"):
        assert tuple(state[name].shape) == jstate[name].shape
        assert state[name].dtype == cache.k.dtype
        _close(state[name], jstate[name], bf16, f"{what}: {name}")
    np.testing.assert_array_equal(state["enc_positions"].numpy(),
                                  np.asarray(jstate["enc_positions"]))


@pytest.mark.parametrize("bf16", [False, True])
def test_encode_matches_jax(bf16):
    jm, params, model, cfg = _models(BF16 if bf16 else {})
    frames, _, _ = _inputs(cfg)
    want = jm.encode(params, jnp.asarray(frames))
    got = model.encode(torch.from_numpy(frames))
    assert got.dtype == cfg.cdtype and tuple(got.shape) == want.shape
    _close(got, want, bf16, "encoder output")


@pytest.mark.parametrize("bf16", [False, True])
def test_encdec_prefill_and_decode_match_jax(bf16):
    jm, params, model, cfg = _models(BF16 if bf16 else {})
    frames, prompt, toks = _inputs(cfg)
    B, S = prompt.shape
    steps, max_len = toks.shape[0], S + toks.shape[0] + 2
    jlog, jstate = jm.prefill(
        params, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(prompt)},
        max_len)
    logits, state = model.prefill(
        {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(prompt)},
        max_len)
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == jlog.shape == (B, 1, cfg.vocab_padded)
    _close(logits, jlog, bf16, "prefill logits")
    _same_state(state, jstate, bf16, "prefill")
    for t in range(steps):
        jlog, jstate = jm.decode_step(params, jstate, jnp.asarray(toks[t]))
        logits, state = model.decode_step(state, torch.from_numpy(toks[t]))
        _close(logits, jlog, bf16, f"decode step {t} logits")
        _same_state(state, jstate, bf16, f"decode step {t}")
    assert int(state["self"].pos[0]) == S + steps


def test_decode_from_carried_jax_state():
    """Both packages decode from one state: JAX's prefill carried across
    by ``encdec_state_from_numpy``."""
    jm, params, model, cfg = _models({}, seed=3)
    frames, prompt, toks = _inputs(cfg, B=3, Se=17, S=9, seed=52)
    _, jstate = jm.prefill(
        params, {"frames": jnp.asarray(frames), "tokens": jnp.asarray(prompt)},
        16)
    arrays = {n: np.asarray(v) for n, v in jstate.items() if n != "self"}
    arrays["self"] = jstate["self"]
    state = encdec_state_from_numpy(arrays, device="cpu")
    _same_state(state, jstate, False, "carried")
    for t in range(toks.shape[0]):
        jlog, jstate = jm.decode_step(params, jstate, jnp.asarray(toks[t]))
        logits, state = model.decode_step(state, torch.from_numpy(toks[t]))
        _close(logits, jlog, False, f"decode step {t} logits")
        _same_state(state, jstate, False, f"decode step {t}")


def test_decode_matches_longer_prefill():
    """Inside the port: decode after prefill equals prefill over the
    longer prompt (``atol = rtol = 5e-4``, ``tests/test_arch_smoke.py``'s)."""
    _, _, model, cfg = _models({}, seed=4)
    frames, _, _ = _inputs(cfg)
    frames = torch.from_numpy(frames)
    g = torch.Generator().manual_seed(5)
    seq = torch.randint(0, cfg.vocab, (2, 16), generator=g, dtype=torch.int32)
    _, state = model.prefill({"frames": frames, "tokens": seq[:, :10]}, 16)
    for t in range(10, 16):
        logits, state = model.decode_step(state, seq[:, t:t + 1])
        want, _ = model.prefill({"frames": frames, "tokens": seq[:, :t + 1]}, 16)
        torch.testing.assert_close(logits, want, atol=5e-4, rtol=5e-4)
