"""The PyTorch port's RWKV6 serving path against the JAX package, on the
CPU: the WKV6 scan's plain versions, the model's ``prefill`` and
``decode_step``, the seeded init, and the config registry.

The same numpy inputs go to both packages; the JAX model's weights reach
the port through :func:`repro_torch.convert.rwkv6_from_numpy`, with
``mu``, ``u`` and ``w0`` replaced by seeded random values first (the
reference's init zeros the shift mixes and the bonus, which would drop
them out of every comparison).  Tolerances:

* WKV6: the port's recurrence ``wkv6_ref`` and its chunked plain version
  ``wkv6_chunked`` within ``atol = rtol = 5e-4`` of JAX's recurrence (the
  reference's own tolerance, ``tests/test_kernels.py``); ``wkv6_chunked``
  within ``atol = rtol = 2e-5`` of JAX's ``impl="xla"`` and of its Pallas
  kernel in interpret mode (the same factorization, products summed in
  another order; the largest difference seen is 1.7e-5 at outputs up to
  52);
* the model in float32 (``smoke_config()``): logits and every state array
  within ``atol = rtol = 1e-4`` (largest difference seen 1.1e-5);
* the model in bfloat16 (parameters and compute): each array within
  ``atol = 8 * 2**-8 * max|JAX's|`` — eight bf16 steps of its largest
  value (largest difference seen about four).  JAX runs the model inside
  ``lax.scan``, where XLA keeps float32 across bf16 round trips (the
  token shift's ``prev - x`` is not rounded to bf16); the port, like JAX
  op by op, rounds there (ROADMAP Queue C);
* decode after prefill against prefill over the longer prompt, inside the
  port: ``atol = rtol = 5e-4`` (``tests/test_arch_smoke.py``'s).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.kernels.wkv6.ops import wkv6 as jax_wkv6
from repro.kernels.wkv6.ref import wkv6_ref as jax_wkv6_ref
from repro.models import build_model as jax_build_model
from repro_torch.configs import registry
from repro_torch.convert import rwkv6_from_numpy
from repro_torch.kernels.wkv6.ops import (
    WKV6Plan,
    kernel_inputs,
    plan_wkv6,
    wkv6,
    wkv6_chunked,
)
from repro_torch.kernels.wkv6.ref import LOG_W_MIN, wkv6_ref
from repro_torch.models import build_model
from repro_torch.models.rwkv6 import RWKV6LM

WKV_SHAPES = [(2, 3, 64, 32), (1, 2, 100, 64), (2, 4, 128, 64), (1, 1, 16, 16)]


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(
        np.asarray(got, np.float32), np.asarray(want, np.float32),
        atol=tol, rtol=tol, err_msg=what,
    )


def _wkv_inputs(shape, seed):
    """(r, k, v, lw, u, s0) as numpy float32, scaled as
    ``tests/test_kernels.py`` scales them."""
    B, H, T, D = shape
    rng = np.random.default_rng(seed)
    f = np.float32
    return (
        (rng.normal(size=(B, H, T, D)) * 0.5).astype(f),
        (rng.normal(size=(B, H, T, D)) * 0.5).astype(f),
        rng.normal(size=(B, H, T, D)).astype(f),
        (-np.exp(rng.normal(size=(B, H, T, D)) - 1.0)).astype(f),
        (rng.normal(size=(H, D)) * 0.3).astype(f),
        (rng.normal(size=(B, H, D, D)) * 0.1).astype(f),
    )


def _port_and_jax(args, with_s0=True, pallas=True):
    """The port's two plain versions and JAX's recurrence, XLA chunked and
    (optionally) Pallas interpret outputs on the same inputs."""
    r, k, v, lw, u, s0 = args
    s0 = s0 if with_s0 else None
    j = [jnp.asarray(a) for a in (r, k, v, lw, u)]
    js0 = None if s0 is None else jnp.asarray(s0)
    t = [torch.from_numpy(a) for a in (r, k, v, lw, u)]
    ts0 = None if s0 is None else torch.from_numpy(s0)
    out = {
        "jax_ref": jax_wkv6_ref(*j, js0),
        "jax_xla": jax_wkv6(*j, js0, impl="xla"),
        "ref": wkv6_ref(*t, ts0),
        "chunked": wkv6_chunked(*t, ts0),
    }
    if pallas:
        out["jax_pallas"] = jax_wkv6(*j, js0, impl="pallas", interpret=True)
    return out


@pytest.mark.parametrize("shape,with_s0", [
    *[(s, True) for s in WKV_SHAPES],
    ((2, 3, 1, 64), True),    # a decode step
    ((2, 3, 1, 64), False),
    ((1, 2, 100, 64), False),
])
def test_wkv6_plain_versions_match_jax(shape, with_s0):
    out = _port_and_jax(_wkv_inputs(shape, hash(shape) % 2**31), with_s0)
    for name in ("ref", "chunked"):
        for i, part in enumerate(("y", "S")):
            _close(out[name][i], out["jax_ref"][i], 5e-4, f"{name} {part}")
    for twin in ("jax_xla", "jax_pallas"):
        for i, part in enumerate(("y", "S")):
            _close(out["chunked"][i], out[twin][i], 2e-5, f"{twin} {part}")
    assert out["chunked"][0].dtype == torch.float32
    assert out["chunked"][0].shape == shape


def _lw_edge(name, shape, rng, base):
    lw = base.copy()
    if name == "positive":          # clamped to 0
        lw[..., ::3] = rng.uniform(0.01, 2.0, lw[..., ::3].shape)
    elif name == "below_floor":     # clamped to -3.5
        lw[..., 1::3] = rng.uniform(-20.0, -3.6, lw[..., 1::3].shape)
    elif name == "zero":
        lw[:] = 0.0
    elif name == "chunk_at_floor":  # exp(-cum) reaches e^56 in chunk 1
        lw[:, :, 16:32] = LOG_W_MIN
    return lw


@pytest.mark.parametrize("edge", ["positive", "below_floor", "zero",
                                  "chunk_at_floor"])
def test_wkv6_lw_edges_match_jax(edge):
    shape = (1, 2, 48, 64)
    rng = np.random.default_rng(31)
    r, k, v, lw, u, s0 = _wkv_inputs(shape, 30)
    lw = _lw_edge(edge, shape, rng, lw)
    out = _port_and_jax((r, k, v, lw, u, s0), pallas=False)
    for name in ("ref", "chunked"):
        for i in (0, 1):
            _close(out[name][i], out["jax_ref"][i], 5e-4, name)
    for i in (0, 1):
        _close(out["chunked"][i], out["jax_xla"][i], 2e-5, "xla")
    # the clamp: positive lw decays nothing, lw below the floor decays by
    # exactly exp(-3.5), whichever side of the clamp it came from
    t = [torch.from_numpy(a) for a in (r, k, v, lw, u, s0)]
    clamped = torch.clamp(t[3], LOG_W_MIN, 0.0)
    y0, s0_ = wkv6_chunked(*t[:3], clamped, *t[4:])
    y1, s1_ = wkv6_chunked(*t)
    assert torch.equal(y0, y1) and torch.equal(s0_, s1_)


def test_wkv6_state_chaining():
    """Two halves with the state carried equal the whole sequence (twin of
    ``tests/test_kernels.py::test_wkv6_state_chaining``)."""
    r, k, v, lw, u, _ = (torch.from_numpy(a)
                         for a in _wkv_inputs((1, 2, 64, 32), 11))
    y_full, s_full = wkv6(r, k, v, lw, u)
    h = 24  # not a chunk multiple: the first half ends mid-chunk
    y1, s1 = wkv6(r[:, :, :h], k[:, :, :h], v[:, :, :h], lw[:, :, :h], u)
    y2, s2 = wkv6(r[:, :, h:], k[:, :, h:], v[:, :, h:], lw[:, :, h:], u, s1)
    _close(torch.cat([y1, y2], dim=2), y_full, 1e-4)
    _close(s2, s_full, 1e-4)


def test_wkv6_refuses_gradients_and_bad_shapes():
    r, k, v, lw, u, s0 = (torch.from_numpy(a)
                          for a in _wkv_inputs((1, 2, 16, 16), 4))
    with pytest.raises(NotImplementedError, match="training slice"):
        wkv6(r.requires_grad_(), k, v, lw, u)
    with torch.no_grad():
        wkv6(r, k, v, lw, u)           # no graph: fine
    with pytest.raises(ValueError, match="share one"):
        wkv6(r.detach(), k[:, :, :8], v, lw, u)
    with pytest.raises(ValueError, match="u must be"):
        wkv6(r.detach(), k, v, lw, u[:1])
    with pytest.raises(ValueError, match="s0 must be"):
        wkv6(r.detach(), k, v, lw, u, s0[:, :1])


def test_wkv6_zero_padded_head_dim_is_exact():
    """What the kernel's wrapper does to a head dim it is not built for:
    D = 48 zero-padded to 64 (r = k = v = 0, lw = 0 in the new channels,
    s0 and u padded with zeros), run and trimmed, equals the unpadded call
    and JAX's ``impl="xla"``.  The padded channels are exact zeros in y
    and S; the rest differs from the unpadded call only in the order the
    BLAS sums 64 products instead of 48 (``atol = rtol = 1e-6``, a few
    float32 ulps)."""
    args = _wkv_inputs((2, 3, 40, 48), 48)
    out = _port_and_jax(args, pallas=False)
    t = [torch.from_numpy(a) for a in args]
    pad = [torch.nn.functional.pad(x, (0, 16)) for x in t[:5]]
    s0 = torch.nn.functional.pad(t[5], (0, 16, 0, 16))
    y, s = wkv6_chunked(*pad, s0)
    assert not y[..., 48:].any() and not s[..., 48:, :].any()
    assert not s[..., :, 48:].any()
    _close(y[..., :48], out["chunked"][0], 1e-6, "y vs unpadded")
    _close(s[..., :48, :48], out["chunked"][1], 1e-6, "S vs unpadded")
    _close(y[..., :48], out["jax_xla"][0], 2e-5, "y")
    _close(s[..., :48, :48], out["jax_xla"][1], 2e-5, "S")


@pytest.mark.parametrize("T,with_s0", [(1, True), (5, False), (20, True)])
def test_wkv6_plain_versions_match_jax_above_256(T, with_s0):
    """A head dim above 256 (D = 272, the ``"wide"`` kernel's range on the
    card): the port's recurrence and chunked plain version against JAX's
    recurrence (``5e-4``) and ``impl="xla"`` (``2e-5``), as at D <= 256."""
    out = _port_and_jax(_wkv_inputs((1, 2, T, 272), 272 + T), with_s0,
                        pallas=False)
    for i, what in enumerate(("y", "S")):
        _close(out["ref"][i], out["jax_ref"][i], 5e-4, f"recurrence {what}")
        _close(out["chunked"][i], out["jax_ref"][i], 5e-4, f"chunked {what}")
        _close(out["chunked"][i], out["jax_xla"][i], 2e-5, f"xla {what}")


@pytest.mark.parametrize("T", [1, 37])
def test_wkv6_model_strided_views_match_contiguous(T):
    """r, k, v, lw as ``_time_mix`` hands them over -- (B, T, H, D)
    tensors viewed as (B, H, T, D) -- give the same y and state as the same
    values made contiguous."""
    B, H, D = 2, 3, 64
    rng = np.random.default_rng(T)
    f = np.float32
    made = [rng.normal(size=(B, T, H, D)).astype(f) * 0.5 for _ in range(3)]
    made.append((-np.exp(rng.normal(size=(B, T, H, D)) - 1.0)).astype(f))
    views = [torch.from_numpy(a).transpose(1, 2) for a in made]
    u = torch.from_numpy((rng.normal(size=(H, D)) * 0.3).astype(f))
    s0 = torch.from_numpy((rng.normal(size=(B, H, D, D)) * 0.1).astype(f))
    assert not views[0].is_contiguous() or T == 1
    y, s = wkv6(*views, u, s0)
    yc, sc = wkv6(*(x.contiguous() for x in views), u, s0)
    assert torch.equal(y, yc) and torch.equal(s, sc)


def test_wkv6_plan_takes_the_model_views_as_they_are():
    """``plan_wkv6`` (what the card would run): the model's (B, T, H, 64)
    views need no copy in either instantiation; D = 48 is padded to 64,
    bf16 and a view off the 16-byte grid are copied; D > 256 plans
    ``"wide"`` at any T, unpadded, copying only bf16 or a D stride."""
    B, H, D = 2, 40, 64
    for T, variant in ((1, "step"), (15, "step"), (16, "chunk"), (1024, "chunk")):
        x = torch.zeros(B, T, H, D).transpose(1, 2)
        plan = plan_wkv6(x, x, x, x)
        assert (plan.variant, plan.head_dim, plan.copy) == (
            variant, 64, (False,) * 4)
    x = torch.zeros(1, 2, 20, 48)
    plan = plan_wkv6(x, x, x, x)
    assert plan == WKV6Plan("chunk", 64, (True,) * 4)
    # what the plan launches: padded, float32, D contiguous and aligned,
    # and the padding carries zeros
    ins = kernel_inputs(plan, x + 1, x, x, x, torch.ones(2, 48),
                        torch.ones(1, 2, 48, 48))
    assert plan_wkv6(*ins[:4]).copy == (False,) * 4
    assert [t.shape[-1] for t in ins] == [64] * 6 and ins[5].shape[-2] == 64
    assert not ins[0][..., 48:].any() and not ins[4][:, 48:].any()
    assert not ins[5][..., 48:, :].any() and not ins[5][..., 48:].any()
    x = torch.zeros(1, 2, 20, 64)
    plan = plan_wkv6(x.bfloat16(), x, x, x)
    assert plan.copy == (True, False, False, False)
    ins = kernel_inputs(plan, x.bfloat16(), x, x, x, torch.zeros(2, 64))
    assert ins[0].dtype == torch.float32 and ins[1] is x and ins[5] is None
    base = torch.zeros(1, 2, 20, 65)
    plan = plan_wkv6(base[..., 1:], x, x, x)            # chunk: cp.async
    assert plan.copy == (True, False, False, False)
    ins = kernel_inputs(plan, base[..., 1:], x, x, x, torch.zeros(2, 64))
    assert ins[0].is_contiguous() and not any(plan_wkv6(*ins[:4]).copy)
    # a state off the 16-byte grid is copied onto it
    state = torch.zeros(1 + 2 * 64 * 64)[1:].view(1, 2, 64, 64)
    s_in = kernel_inputs(plan_wkv6(x, x, x, x), x, x, x, x,
                         torch.zeros(2, 64), state)[5]
    assert s_in.data_ptr() % 16 == 0 and torch.equal(s_in, state)
    assert not plan_wkv6(base[:, :, :3, 1:], *(t[:, :, :3] for t in (x, x, x))).copy[0]
    for T in (1, 15, 16, 100):
        x = torch.zeros(2, T, 3, 272).transpose(1, 2)
        assert plan_wkv6(x, x, x, x) == WKV6Plan("wide", 272, (False,) * 4)
    x = torch.zeros(1, 2, 20, 1000)
    assert plan_wkv6(x.bfloat16(), x, x[..., ::1], x) == WKV6Plan(
        "wide", 1000, (True, False, False, False))
    base = torch.zeros(1, 2, 20, 1001)
    assert plan_wkv6(base[..., 1:], x, x, x).copy == (False,) * 4  # no cp.async
    strided = torch.zeros(1, 2, 1000, 20).transpose(2, 3)   # D not contiguous
    assert plan_wkv6(strided, x, x, x) == WKV6Plan(
        "wide", 1000, (True, False, False, False))
    # what "wide" launches: nothing padded, u and s0 contiguous float32
    ins = kernel_inputs(plan_wkv6(x.bfloat16(), x, x, x), x.bfloat16(), x,
                        x, x, torch.zeros(2, 1000, dtype=torch.float64),
                        torch.zeros(1, 2, 1000, 1000))
    assert [t.shape[-1] for t in ins] == [1000] * 6
    assert ins[0].dtype == ins[4].dtype == torch.float32 and ins[1] is x


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------


def _models(dtype, seed=0, **shape):
    """(JAX model, its params with mu / u / w0 randomized, the port's model
    holding the same weights), at ``smoke_config()`` (with ``shape``'s
    fields replaced) in ``dtype``."""
    jcfg = jax_registry.get_smoke_config("rwkv6-3b").replace(
        param_dtype=dtype, compute_dtype=dtype, **shape)
    cfg = registry.get_smoke_config("rwkv6-3b").replace(
        param_dtype=dtype, compute_dtype=dtype, **shape)
    jm = jax_build_model(jcfg)
    params = jm.init(seed=seed)
    rng = np.random.default_rng(seed + 100)
    L, D = cfg.n_layers, cfg.d_model
    layers = dict(params["layers"])
    tm, cm = dict(layers["tm"]), dict(layers["cm"])
    f32 = jnp.float32
    tm["mu"] = jnp.asarray(rng.uniform(0.0, 1.0, (L, 5, D)), f32)
    tm["u"] = jnp.asarray(rng.normal(0.0, 0.5, tm["u"].shape), f32)
    tm["w0"] = jnp.asarray(rng.normal(-0.5, 1.0, (L, D)), f32)
    cm["mu"] = jnp.asarray(rng.uniform(0.0, 1.0, (L, 2, D)), f32)
    layers["tm"], layers["cm"] = tm, cm
    params = {**params, "layers": layers}
    model = rwkv6_from_numpy(cfg, jax.tree.map(np.asarray, params),
                             device="cpu")
    return jm, params, model


def _state_tol(dtype, want):
    if dtype == "float32":
        return 1e-4
    return 8 * 2.0 ** -8 * float(np.abs(np.asarray(want, np.float32)).max())


def _compare(dtype, logits, state, jlogits, jstate, where):
    _close(logits, jlogits, _state_tol(dtype, jlogits), f"{where} logits")
    assert set(state) == set(jstate)
    for name in jstate:
        assert tuple(state[name].shape) == tuple(jstate[name].shape), name
        assert str(state[name].dtype).split(".")[-1] == str(jstate[name].dtype)
        if name == "pos":
            np.testing.assert_array_equal(state[name].numpy(), jstate[name])
        else:
            _close(state[name].float(), jstate[name],
                   _state_tol(dtype, jstate[name]), f"{where} {name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_prefill_and_decode_match_jax(dtype):
    jm, params, model = _models(dtype)
    rng = np.random.default_rng(7)
    B, S = 2, 20
    tokens = rng.integers(0, model.cfg.vocab, (B, S)).astype(np.int32)
    jl, js = jm.prefill(params, {"tokens": jnp.asarray(tokens)})
    tl, ts = model.prefill({"tokens": torch.from_numpy(tokens)})
    assert tl.shape == (B, 1, model.cfg.vocab_padded)
    assert tl.dtype == torch.float32
    _compare(dtype, tl, ts, jl, js, "prefill")
    for step in range(3):
        tok = rng.integers(0, model.cfg.vocab, (B, 1)).astype(np.int32)
        jl, js = jm.decode_step(params, js, jnp.asarray(tok))
        tl, ts = model.decode_step(ts, torch.from_numpy(tok))
        _compare(dtype, tl, ts, jl, js, f"decode {step}")


def test_rwkv6_decode_after_prefill_matches_longer_prefill():
    """Twin of ``tests/test_arch_smoke.py::test_rwkv_decode_matches_prefill``,
    inside the port, with randomized mu / u / w0."""
    _, _, model = _models("float32", seed=1)
    rng = np.random.default_rng(1)
    B, S, prefix = 1, 10, 5
    tokens = torch.from_numpy(
        rng.integers(0, model.cfg.vocab, (B, S)).astype(np.int32))
    _, state = model.prefill({"tokens": tokens[:, :prefix]})
    for i in range(prefix, S):
        lg, state = model.decode_step(state, tokens[:, i:i + 1])
        ref, ref_state = model.prefill({"tokens": tokens[:, :i + 1]})
        _close(lg[:, 0], ref[:, 0], 5e-4, f"position {i}")
        _close(state["wkv"], ref_state["wkv"], 5e-4, f"wkv at {i}")
        assert int(state["pos"][0]) == i + 1


def _bf16_steps(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / (2.0 ** -8 * np.abs(want).max()))


@pytest.mark.parametrize("shape", [
    {},                                                   # smoke_config()
    dict(d_model=512, n_heads=8, n_kv_heads=8, d_ff=1792),
])
def test_rwkv6_bf16_decode_gap_matches_jax(shape):
    """bf16 decode after 1 and 8 steps against a prefill over the longer
    prompt, in both packages on the same weights: the port's gap (max
    |diff| of the last logits in bf16 steps of the largest) within the
    JAX package's plus one bf16 step.  At the smoke width both gaps are 0;
    at d_model 512 the CPU's bf16 GEMMs round a 1-row and a 40-row product
    differently (about 0.3 steps).  The same gap grows with width and
    depth: ``tests/rwkv6_bf16_gap.py`` measures it at full width."""
    jm, params, model = _models("bfloat16", seed=3, **shape)
    rng = np.random.default_rng(3)
    B, T = 2, 32
    seq = rng.integers(0, model.cfg.vocab, (B, T + 8)).astype(np.int32)
    _, js = jm.prefill(params, {"tokens": jnp.asarray(seq[:, :T])})
    _, ts = model.prefill({"tokens": torch.from_numpy(seq[:, :T])})
    jdec, tdec = [], []
    for i in range(8):
        tok = seq[:, T + i:T + i + 1]
        jl, js = jm.decode_step(params, js, jnp.asarray(tok))
        tl, ts = model.decode_step(ts, torch.from_numpy(tok))
        jdec.append(np.asarray(jl[:, -1], np.float32))
        tdec.append(tl[:, -1].float().numpy())
    for steps in (1, 8):
        jl, _ = jm.prefill(params, {"tokens": jnp.asarray(seq[:, :T + steps])})
        tl, _ = model.prefill({"tokens": torch.from_numpy(seq[:, :T + steps])})
        jgap = _bf16_steps(jdec[steps - 1], jl[:, -1])
        tgap = _bf16_steps(tdec[steps - 1], tl[:, -1].float().numpy())
        assert tgap <= jgap + 1.0, (steps, tgap, jgap)


def test_rwkv6_seeded_init_is_deterministic_and_scaled():
    cfg = registry.get_smoke_config("rwkv6-3b").replace(
        param_dtype="bfloat16", compute_dtype="bfloat16", d_model=256,
        d_ff=512)
    a, b = RWKV6LM(cfg, seed=3, device="cpu"), RWKV6LM(cfg, seed=3, device="cpu")
    c = build_model(cfg, seed=4, device="cpu")
    wa, wb, wc = (m.layers[1]["tm"]["w_k"] for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert wa.dtype == torch.bfloat16
    D, Fd = cfg.d_model, cfg.d_ff
    assert abs(float(wa.detach().float().std()) - D ** -0.5) < 0.1 * D ** -0.5
    w_v = a.layers[0]["cm"]["w_v"]
    assert abs(float(w_v.detach().float().std()) - Fd ** -0.5) < 0.1 * Fd ** -0.5
    table = a.embed["table"]
    assert table.shape == (cfg.vocab_padded, D)
    assert abs(float(table.detach().float().std()) - D ** -0.5) < 0.1 * D ** -0.5
    tm = a.layers[0]["tm"]
    for p in (tm["mu"], tm["w0"], tm["u"], tm["gn"]["scale"],
              a.layers[0]["cm"]["mu"], a.layers[0]["ln_tm"]["scale"],
              a.ln_out["scale"]):
        assert p.dtype == torch.float32
    assert torch.all(tm["mu"] == 0) and torch.all(tm["u"] == 0)
    assert torch.all(tm["w0"] == -1.0)
    # the JAX tree's leaves, name for name and shape for shape
    jm = jax_build_model(jax_registry.get_smoke_config("rwkv6-3b").replace(
        param_dtype="bfloat16", compute_dtype="bfloat16", d_model=256,
        d_ff=512))
    shapes = jax.eval_shape(lambda: jm.init(seed=0))
    flat = jax.tree_util.tree_flatten_with_path(shapes)[0]
    jax_names = {".".join(str(getattr(k, "key", k)) for k in path): leaf.shape
                 for path, leaf in flat}
    own = {n: tuple(p.shape) for n, p in a.named_parameters()}
    for name, shape in jax_names.items():
        if name.startswith("layers."):
            assert own[f"layers.0.{name[7:]}"] == tuple(shape[1:]), name
        else:
            assert own[name] == tuple(shape), name
    assert sum(p.numel() for p in a.parameters()) == sum(
        int(np.prod(s)) for s in jax_names.values())


def test_rwkv6_loss_waits_for_training():
    model = build_model(registry.get_smoke_config("rwkv6-3b"), device="cpu")
    with pytest.raises(NotImplementedError, match="training"):
        model.loss({})
    state = model.init_state(3)
    assert set(state) == {"att_shift", "cm_shift", "wkv", "pos"}
    assert state["wkv"].shape == (2, 3, 2, 64, 64)
    assert state["wkv"].dtype == torch.float32
    assert state["pos"].dtype == torch.int32


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------


def test_registry_matches_jax():
    """Every arch's full and smoke config field for field, param_count,
    the shapes and the cell matrix (twin of
    ``test_full_configs_match_assignment``)."""
    assert list(registry.ARCHS) == list(jax_registry.ARCHS)
    for arch in registry.ARCHS:
        for get in ("get_config", "get_smoke_config"):
            a = getattr(jax_registry, get)(arch)
            b = getattr(registry, get)(arch)
            assert dataclasses.asdict(a) == dataclasses.asdict(b), (arch, get)
            assert a.hd == b.hd and a.vocab_padded == b.vocab_padded
            assert a.d_rnn == b.d_rnn
            for active in (False, True):
                assert a.param_count(active) == b.param_count(active), arch
    assert {k: dataclasses.astuple(v) for k, v in registry.SHAPES.items()} == {
        k: dataclasses.astuple(v) for k, v in jax_registry.SHAPES.items()}
    assert registry.cells() == jax_registry.cells()
    assert registry.cells(False) == jax_registry.cells(False)
    full = registry.get_config("rwkv6-3b")
    assert (full.n_layers, full.d_model, full.n_heads, full.hd, full.d_ff,
            full.vocab, full.tie_embeddings) == (32, 2560, 40, 64, 8960,
                                                 65536, True)
    assert full.pdtype == torch.bfloat16
    # the reference's rwkv formula (ROADMAP Queue C): 3,428,843,520 where
    # the parameter tree holds 2,900,298,240
    assert full.param_count() == 3_428_843_520
