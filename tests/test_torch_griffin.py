"""The PyTorch port's RecurrentGemma (``GriffinLM``) against the JAX
package, on the CPU.

The same numpy inputs go to both packages; weights reach the port through
:func:`repro_torch.convert.griffin_from_numpy`, a JAX serving state through
:func:`repro_torch.convert.griffin_state_from_numpy`.  On the CPU the
port's prefill attention is ``gqa_attention``, the reference's own.  The
JAX model's ``prefill`` and ``decode_step`` run under ``jax.jit`` in
float32 and op by op in bf16: under ``jax.jit`` XLA's CPU fusion keeps
some bf16 results in float32 (the depthwise convolution's last add, which
feeds the float32 recurrence, for one), so the reference's own jitted and
op-by-op bf16 runs part by up to 13.5 bf16 steps of the largest value
over seeds 0-6 (``tests/griffin_bf16_gap.py``), while the port follows
the op-by-op arithmetic (each elementwise op rounded to bf16).
Tolerances:

* :func:`pair_scan` against ``jax.lax.associative_scan`` with the
  reference's combine: ``atol = rtol = 1e-6`` (the same pairing tree; XLA
  may contract ``a2 * b1 + b2`` into one FMA on the CPU), and against the
  sequential plain version ``atol = rtol = 1e-5`` (another association);
* ``causal_conv``: bit for bit (products and adds in the reference's
  order);
* the model (``smoke_config()``, a 40-token prompt over a window of 16, so
  the ring wraps): logits and every float leaf of the state within ``atol
  = rtol = 1e-5`` in float32 and within eight bf16 steps of JAX's largest
  value in bf16 (the float32 recurrence states ``h`` of a bf16 model are
  held the same way, since they integrate bf16 activations); ``k_pos``
  and ``pos`` exactly — after prefill and after each of three decode
  steps.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import recurrentgemma_9b as jax_griffin
from repro.models import griffin as jgriffin
from repro_torch.convert import griffin_from_numpy, griffin_state_from_numpy
from repro_torch.models import griffin
from repro_torch.models.config import ModelConfig

F32_TOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _close(got, want, bf16, what, tol=F32_TOL):
    """float32: ``atol = rtol = tol``.  bf16: eight bf16 steps of the
    largest value."""
    want = _np(want)
    if bf16:
        atol = 8 * 2.0 ** -8 * float(np.abs(want).max())
        np.testing.assert_allclose(_np(got), want, atol=atol, rtol=0,
                                   err_msg=what)
    else:
        np.testing.assert_allclose(_np(got), want, atol=tol, rtol=tol,
                                   err_msg=what)


def _comb(c1, c2):  # src/repro/models/griffin.py:106-109
    a1, b1 = c1
    a2, b2 = c2
    return a1 * a2, a2 * b1 + b2


@pytest.mark.parametrize("S", [1, 2, 3, 16, 40, 65])
def test_pair_scan_matches_associative_scan(S):
    rng = np.random.default_rng(S)
    a = rng.uniform(0.0, 1.0, (3, S, 8)).astype(np.float32)
    b = rng.normal(size=(3, S, 8)).astype(np.float32)
    _, want = jax.lax.associative_scan(_comb, (jnp.asarray(a), jnp.asarray(b)),
                                       axis=1)
    got = griffin.pair_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    plain = griffin.sequential_scan(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=F32_TOL,
                               rtol=F32_TOL)


@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_matches_jax(with_state, dtype):
    rng = np.random.default_rng(7)
    jd = jnp.dtype(dtype)
    x = jnp.asarray(rng.normal(size=(2, 9, 16)), jd)
    w = jnp.asarray(rng.normal(size=(4, 16)) * 0.5, jd)
    st = jnp.asarray(rng.normal(size=(2, 3, 16)), jd) if with_state else None
    want, want_state = jgriffin._causal_conv(x, w, st)
    tt = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(
        getattr(torch, dtype))
    got, got_state = griffin.causal_conv(tt(x), tt(w),
                                         None if st is None else tt(st))
    assert got.dtype == getattr(torch, dtype)
    for g, wnt in ((got, want), (got_state, want_state)):
        np.testing.assert_array_equal(_np(g), _np(wnt))


class _Jitted:
    """A JAX model whose ``prefill`` and ``decode_step`` run under
    ``jax.jit`` (one compile per shape, instead of op by op)."""

    def __init__(self, model):
        self.model, self.cfg = model, model.cfg
        self.prefill = jax.jit(model.prefill)
        self.decode_step = jax.jit(model.decode_step)

    def __getattr__(self, name):
        return getattr(self.model, name)


class _OpByOp:
    """A JAX model whose ``prefill`` and ``decode_step`` run under
    ``jax.disable_jit()``: every op on its own, layer scans included."""

    def __init__(self, model):
        self.model, self.cfg = model, model.cfg

    def __getattr__(self, name):
        fn = getattr(self.model, name)
        if name not in ("prefill", "decode_step"):
            return fn

        def op_by_op(*args):
            with jax.disable_jit():
                return fn(*args)
        return op_by_op


def _models(kw, seed=0, jit=True):
    jcfg = jax_griffin.smoke_config().replace(**kw)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jm = (_Jitted if jit else _OpByOp)(jgriffin.GriffinLM(jcfg))
    params = jm.init(seed)
    model = griffin_from_numpy(cfg, jax.tree.map(np.asarray, params),
                               device="cpu")
    return jm, params, model, cfg


def _same_state(state, jstate, bf16, what):
    assert set(state) == set(jstate), (sorted(state), sorted(jstate))
    for name, want in jstate.items():
        got = state[name]
        assert tuple(got.shape) == want.shape, name
        if name in ("k_pos", "pos"):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                          err_msg=f"{what}: {name}")
        else:
            assert got.dtype == (torch.bfloat16 if want.dtype == jnp.bfloat16
                                 else torch.float32), name
            # a bf16 model's float32 leaves (h) come from bf16 activations
            _close(got, want, bf16, f"{what}: {name}")


@pytest.mark.parametrize("bf16", [False, True])
def test_griffin_prefill_and_decode_match_jax(bf16):
    kw = dict(param_dtype="bfloat16", compute_dtype="bfloat16") if bf16 else {}
    jm, params, model, cfg = _models(kw, jit=not bf16)
    assert model.n_super == 2 and model.n_tail == 2
    rng = np.random.default_rng(41)
    B, S, steps = 2, 40, 3
    prompt = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    toks = rng.integers(0, cfg.vocab, (steps, B, 1)).astype(np.int32)
    jlog, jstate = jm.prefill(params, {"tokens": jnp.asarray(prompt)})
    logits, state = model.prefill({"tokens": torch.from_numpy(prompt)})
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == jlog.shape == (B, 1, cfg.vocab_padded)
    _close(logits, jlog, bf16, "prefill logits")
    _same_state(state, jstate, bf16, "prefill")
    assert S > cfg.sliding_window and int(state["k_pos"].max()) == S - 1
    for t in range(steps):
        jlog, jstate = jm.decode_step(params, jstate, jnp.asarray(toks[t]))
        logits, state = model.decode_step(state, torch.from_numpy(toks[t]))
        _close(logits, jlog, bf16, f"decode step {t} logits")
        _same_state(state, jstate, bf16, f"decode step {t}")
    assert int(state["pos"][0]) == S + steps


def test_decode_from_carried_jax_state():
    """Both packages decode from one state, JAX's prefill carried across
    by ``griffin_state_from_numpy``; and from ``init_state`` (position 0,
    empty ring)."""
    jm, params, model, cfg = _models({}, seed=3)
    rng = np.random.default_rng(42)
    prompt = rng.integers(0, cfg.vocab, (3, 21)).astype(np.int32)
    _, jstate = jm.prefill(params, {"tokens": jnp.asarray(prompt)})
    state = griffin_state_from_numpy(jax.tree.map(np.asarray, jstate),
                                     device="cpu")
    _same_state(state, jstate, False, "carried")
    jzero, zero = jm.init_state(3), model.init_state(3)
    _same_state(zero, jzero, False, "init_state")
    for t in range(2):
        tok = rng.integers(0, cfg.vocab, (3, 1)).astype(np.int32)
        jlog, jstate = jm.decode_step(params, jstate, jnp.asarray(tok))
        logits, state = model.decode_step(state, torch.from_numpy(tok))
        _close(logits, jlog, False, f"decode step {t} logits")
        _same_state(state, jstate, False, f"decode step {t}")
        jlog, jzero = jm.decode_step(params, jzero, jnp.asarray(tok))
        logits, zero = model.decode_step(zero, torch.from_numpy(tok))
        _close(logits, jlog, False, f"from init_state, step {t} logits")
        _same_state(zero, jzero, False, f"from init_state, step {t}")


def test_decode_matches_longer_prefill():
    """Inside the port: decode after prefill equals prefill over the
    longer prompt (``atol = rtol = 5e-4``, ``tests/test_arch_smoke.py``'s),
    the ring past its wrap."""
    _, _, model, cfg = _models({}, seed=4)
    g = torch.Generator().manual_seed(5)
    seq = torch.randint(0, cfg.vocab, (2, 24), generator=g, dtype=torch.int32)
    _, state = model.prefill({"tokens": seq[:, :18]})
    for t in range(18, 24):
        logits, state = model.decode_step(state, seq[:, t:t + 1])
        want, _ = model.prefill({"tokens": seq[:, :t + 1]})
        torch.testing.assert_close(logits, want, atol=5e-4, rtol=5e-4)
