"""B7's backward on the CPU: the plain version ``wkv6_bwd_ref`` against
``jax.vjp`` of the reference's ``wkv6(..., impl="xla")`` (the function its
model differentiates), against autograd of the port's two forward plain
versions, the clamp's end rule, a float64 replay of the backward
kernel's chunked algorithm (``kernels/csrc/wkv6_bwd.cu``) and the kernel's
plan.

Inputs are drawn with ``np.random.default_rng`` and scaled as
``tests/test_kernels.py`` scales the forward's.  Tolerance: each gradient
within ``2e-5`` of its largest |value| + ``1e-6`` (float32 formulas summed
in other orders; the chunked forward's exp(±cum) reach e^56 inside a
chunk, yet its gradient stays within 2.5e-6 of the recurrence's).  The
lw drawn for the JAX comparison keep away from the clamp's ends, where
the packages part by design: ``jnp.clip``'s gradient is 0.5 there,
``torch.clamp``'s (and the port's) 1 (``test_clamp_end_rule``).

Cost: one ``jax.jit`` compile of the vjp per case of ``JAX_CASES`` (the
clamp test reuses the first case's); everything else is PyTorch at small
sizes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.wkv6.ops import wkv6 as jax_wkv6
from repro_torch.kernels.wkv6.ops import (
    plan_wkv6_bwd,
    wkv6_bwd,
    wkv6_chunked,
)
from repro_torch.kernels.wkv6.ref import LOG_W_MIN, wkv6_bwd_ref, wkv6_ref

REL, ABS = 2e-5, 1e-6
NAMES = ("dr", "dk", "dv", "dlw", "du", "ds0")

# (B, H, T, D), s0 given, ds_fin given: T = 1 and T = 17 (not a multiple
# of the chunk), D = 64 and D = 32, s0 and ds_fin present and absent; the
# "wide" backward's head dims, D = 128 and D = 288
JAX_CASES = [
    ((2, 2, 17, 64), True, True),
    ((1, 3, 1, 32), False, False),
    ((2, 2, 40, 32), True, False),
    ((1, 2, 33, 64), False, True),
    ((1, 2, 20, 128), True, True),
    ((1, 1, 17, 288), False, True),
]


def _inputs(shape, seed, with_s0=True, with_dsf=True, lw_scale=1.0):
    """(r, k, v, lw, u, s0, dy, ds_fin) as numpy float32 (s0 / ds_fin
    None when not given); lw = -exp(N(0, 1) - 1) * ``lw_scale``."""
    B, H, T, D = shape
    rng = np.random.default_rng(seed)
    f = np.float32

    def n(*s):
        return rng.normal(size=s)

    lw = (-np.exp(n(B, H, T, D) - 1.0) * lw_scale).astype(f)
    return ((n(B, H, T, D) * 0.5).astype(f), (n(B, H, T, D) * 0.5).astype(f),
            n(B, H, T, D).astype(f), lw, (n(H, D) * 0.3).astype(f),
            (n(B, H, D, D) * 0.1).astype(f) if with_s0 else None,
            n(B, H, T, D).astype(f),
            (n(B, H, D, D) * 0.1).astype(f) if with_dsf else None)


def _torch(xs):
    return [None if x is None else torch.from_numpy(x) for x in xs]


def _close(got, want, what):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) if got.size else 0.0
    bound = REL * (float(np.abs(want).max()) if want.size else 0.0) + ABS
    assert err <= bound, f"{what}: max |diff| {err:.3e} > {bound:.3e}"


_JAX_VJP = {}


def _jax_grads(r, k, v, lw, u, s0, dy, ds_fin):
    """The reference's gradients of ``wkv6(..., impl="xla")`` (one jit of
    the whole vjp per argument structure and shape)."""
    with_s0 = s0 is not None
    fn = _JAX_VJP.get(with_s0)
    if fn is None:
        def vjp(args, cot):
            def f(*a):
                return jax_wkv6(*a[:5], a[5] if with_s0 else None, impl="xla")
            return jax.vjp(f, *args)[1](cot)
        fn = _JAX_VJP[with_s0] = jax.jit(vjp)
    B, H, T, D = r.shape
    args = [jnp.asarray(x) for x in (r, k, v, lw, u) + ((s0,) if with_s0 else ())]
    dsf = np.zeros((B, H, D, D), np.float32) if ds_fin is None else ds_fin
    out = [np.asarray(g) for g in fn(args, (jnp.asarray(dy), jnp.asarray(dsf)))]
    return out + ([] if with_s0 else [None])


def _check_all(got, want, where):
    for name, g, w in zip(NAMES, got, want):
        if w is None:
            assert g is None, f"{where}: {name} should be None"
            continue
        _close(g, w, f"{where}: {name}")


@pytest.mark.parametrize("shape,with_s0,with_dsf", JAX_CASES)
def test_bwd_ref_matches_jax_vjp(shape, with_s0, with_dsf):
    xs = _inputs(shape, sum(shape), with_s0, with_dsf)
    r, k, v, lw, u, s0, dy, dsf = xs
    # keep lw away from the clamp's ends (the packages' rules differ there)
    assert not np.any(np.isin(lw, [LOG_W_MIN, 0.0]))
    want = _jax_grads(*xs)
    got = wkv6_bwd_ref(*_torch(xs))
    _check_all([None if g is None else g.numpy() for g in got], want,
               f"wkv6_bwd_ref vs jax.vjp {shape}")


def _autograd(forward, r, k, v, lw, u, s0, dy, ds_fin):
    """Gradients of ``forward`` (wkv6_ref or wkv6_chunked) by autograd,
    with cotangents dy and ds_fin (zero when None)."""
    leaves = [x.clone().requires_grad_() for x in (r, k, v, lw, u)]
    s0l = None if s0 is None else s0.clone().requires_grad_()
    y, s_fin = forward(*leaves, s0l)
    outs, cots = [y], [dy]
    if ds_fin is not None:
        outs.append(s_fin)
        cots.append(ds_fin)
    wrt = leaves + ([s0l] if s0l is not None else [])
    grads = torch.autograd.grad(outs, wrt, cots, allow_unused=True)
    grads = [torch.zeros_like(x) if g is None else g for g, x in zip(grads, wrt)]
    return grads + ([] if s0l is not None else [None])


@pytest.mark.parametrize("shape,with_s0,with_dsf,lw_scale", [
    ((2, 2, 17, 64), True, True, 1.0),
    ((1, 3, 1, 32), False, False, 1.0),
    ((2, 2, 40, 32), True, False, 4.0),    # many lw below the floor
    ((1, 2, 64, 16), False, True, 0.05),   # little decay: the state grows
])
def test_bwd_matches_autograd_of_the_forward_plain_versions(
        shape, with_s0, with_dsf, lw_scale):
    """``wkv6_bwd`` on CPU tensors (its plain version) against autograd of
    the recurrence ``wkv6_ref`` and of the chunked ``wkv6_chunked``."""
    xs = _torch(_inputs(shape, 3 + sum(shape), with_s0, with_dsf, lw_scale))
    got = wkv6_bwd(*xs[:6], xs[6], xs[7])
    for forward in (wkv6_ref, wkv6_chunked):
        want = _autograd(forward, *xs)
        _check_all(got, want, f"wkv6_bwd vs autograd of {forward.__name__} {shape}")


def test_bwd_needs_dtypes_and_no_rows():
    """``needs`` leaves the gradients not asked for None; each gradient
    comes back in its input's dtype; T = 0 passes ds_fin through."""
    r, k, v, lw, u, s0, dy, dsf = _torch(_inputs((1, 2, 9, 64), 5))
    got = wkv6_bwd(r, k, v, lw, u, s0, dy, dsf,
                   needs=(True, False, True, False, True, False))
    assert [g is None for g in got] == [False, True, False, True, False, True]
    bf = wkv6_bwd(r.bfloat16(), k, v, lw, u.double(), s0, dy, None)
    assert bf[0].dtype == torch.bfloat16 and bf[4].dtype == torch.float64
    assert bf[1].dtype == torch.float32 and bf[5].dtype == torch.float32
    # no rows: empty gradients, du = 0, ds0 = ds_fin
    r, k, v, lw, u, s0, dy, dsf = _torch(_inputs((1, 2, 0, 64), 6))
    dr, dk, dv, dlw, du, ds0 = wkv6_bwd(r, k, v, lw, u, s0, dy, dsf)
    assert dr.shape == (1, 2, 0, 64) and not du.any()
    assert torch.equal(ds0, dsf)


def test_clamp_end_rule():
    """At lw = -3.5 and lw = 0 exactly the port's dlw follows
    ``torch.clamp`` (gradient 1: equal to autograd of ``wkv6_ref``), while
    the reference's ``jnp.clip`` gives half of it there; beyond the ends
    both give 0, inside they agree."""
    shape, with_s0, with_dsf = JAX_CASES[0]  # the first case's compile
    xs = list(_inputs(shape, 77, with_s0, with_dsf))
    lw = xs[3]
    lw[..., 0::4] = LOG_W_MIN
    lw[..., 1::4] = 0.0
    lw[..., 2, :] = -5.0                      # beyond the floor
    lw[..., 3, :8] = 0.25                     # above 0
    ends = np.zeros(lw.shape, bool)
    ends[..., 0::4] = ends[..., 1::4] = True
    ends[..., 2, :] = False
    ends[..., 3, :8] = False
    got = wkv6_bwd_ref(*_torch(xs))
    dlw = got[3].numpy()
    want = _autograd(wkv6_ref, *_torch(xs))
    _close(dlw, want[3].numpy(), "dlw vs torch.clamp's autograd")
    assert np.all(dlw[..., 2, :] == 0.0) and np.all(dlw[..., 3, :8] == 0.0)
    assert np.abs(dlw[ends]).min() > 0.0
    jax_dlw = _jax_grads(*xs)[3]
    _close(jax_dlw[ends], 0.5 * dlw[ends], "JAX's dlw at the ends (half)")
    _close(jax_dlw[~ends], dlw[~ends], "JAX's dlw elsewhere")
    for g, w in zip(got[:3] + got[4:], want[:3] + want[4:]):
        _close(g.numpy(), w.numpy(), "the other gradients")


def _replay_kernel(r, k, v, lw, u, s0, dy, ds_fin):
    """float64 torch replay of ``wkv6_bwd.cu``'s chunked algorithm, chunk by
    chunk: the forward sweep from s0 (dr, q_t left in dlw's row t, P_fin =
    Σ_j ds_fin S_{T-1} in its row 0, du), then the reverse sweep from
    ds_fin, which needs no state (dk, dv, ds0, and dlw from the suffix
    sums dlw_t = P_t - k_t dk'_t, P_{t-1} = dlw_t + q_t).  Rows past T are
    identity rows (r = k = v = dy = 0, lw = 0), as the kernel stages them."""
    f = torch.float64
    r, k, v, lw, dy = (torch.from_numpy(x).to(f) for x in (r, k, v, lw, dy))
    u = torch.from_numpy(u).to(f)
    B, H, T, D = r.shape
    C = 16
    nc = -(-T // C)

    def chunks(x):  # (B, H, T, D) -> (B, H, nc, C, D), identity rows padded
        return torch.nn.functional.pad(x, (0, 0, 0, nc * C - T)).view(
            B, H, nc, C, D)

    rc, kc, vc, dyc, lwc = (chunks(x) for x in (r, k, v, dy, lw))
    g = torch.clamp(lwc, LOG_W_MIN, 0.0)
    cum = g.cumsum(3)
    cp = cum - g
    last = cum[:, :, :, -1:]                       # L, (B, H, nc, 1, D)
    rt, kt = rc * torch.exp(cp), kc * torch.exp(-cum)
    ke = kc * torch.exp(last - cum)
    vdy = (vc * dyc).sum(-1, keepdim=True)
    bonus = (rc * u[:, None, None] * kc).sum(-1, keepdim=True)
    tril = torch.tril(torch.ones(C, C, dtype=f), -1)
    triu = tril.T

    def tr(x):
        return x.transpose(-1, -2)

    zeros = torch.zeros((B, H, D, D), dtype=f)
    S = zeros if s0 is None else torch.from_numpy(s0).to(f)
    dr = torch.zeros_like(rc)
    slot = torch.zeros_like(rc)                    # dlw's rows
    du = torch.zeros((B, H, D), dtype=f)
    for c in range(nc):
        x = dyc[:, :, c] @ tr(S) + (tril * (dyc[:, :, c] @ tr(vc[:, :, c]))) @ kt[:, :, c]
        drp = torch.exp(cp[:, :, c]) * x
        dr[:, :, c] = drp + u[:, None] * kc[:, :, c] * vdy[:, :, c]
        slot[:, :, c] = rc[:, :, c] * drp          # q
        du += (rc[:, :, c] * kc[:, :, c] * vdy[:, :, c]).sum(2)
        S = tr(torch.exp(last[:, :, c])) * (S + tr(kt[:, :, c]) @ vc[:, :, c])
    dS = zeros if ds_fin is None else torch.from_numpy(ds_fin).to(f)
    slot = slot.view(B, H, nc * C, D)
    if T:
        slot[:, :, 0] = (dS * S).sum(-1)           # P_fin over q_0
    dk, dv, dlw = (torch.zeros_like(rc) for _ in range(3))
    P = slot[:, :, 0].clone()
    for c in reversed(range(nc)):
        x1 = vc[:, :, c] @ tr(dS)
        x2 = (triu * (vc[:, :, c] @ tr(dyc[:, :, c]))) @ rt[:, :, c]
        dkp = torch.exp(last[:, :, c] - cum[:, :, c]) * x1 + torch.exp(-cum[:, :, c]) * x2
        dk[:, :, c] = dkp + u[:, None] * rc[:, :, c] * vdy[:, :, c]
        dv[:, :, c] = ((triu * (kt[:, :, c] @ tr(rt[:, :, c]))) @ dyc[:, :, c]
                       + ke[:, :, c] @ dS + bonus[:, :, c] * dyc[:, :, c])
        dS = tr(torch.exp(last[:, :, c])) * dS + tr(rt[:, :, c]) @ dyc[:, :, c]
        for t in reversed(range(min(C, T - c * C))):
            row = c * C + t
            glw = P - kc[:, :, c, t] * dkp[:, :, t]
            P = glw + slot[:, :, row]
            inside = (lwc[:, :, c, t] >= LOG_W_MIN) & (lwc[:, :, c, t] <= 0.0)
            dlw[:, :, c, t] = torch.where(inside, glw, 0.0)

    def rows(x):
        return x.reshape(B, H, nc * C, D)[:, :, :T].numpy()

    return (rows(dr), rows(dk), rows(dv), rows(dlw), du.sum(0).numpy(),
            None if s0 is None else dS.numpy())


# (lw_scale, s0 given, ds_fin given, T, lw edge): little decay (the state
# grows), typical decay and lw mostly at the floor over 100 rows; T on both
# sides of a chunk; a whole chunk at the floor (e^56 inside it)
REPLAY_CASES = [
    (1.0, True, True, 100, None), (0.02, False, True, 100, None),
    (8.0, True, False, 100, "ends"),
    *[(1.0, True, True, T, None) for T in (1, 15, 16, 17, 33)],
    (1.0, True, True, 48, "chunk_at_floor"),
]


@pytest.mark.parametrize("lw_scale,with_s0,with_dsf,T,edge", REPLAY_CASES)
def test_kernel_sweeps_replay_matches_bwd_ref(lw_scale, with_s0, with_dsf, T,
                                              edge):
    """The kernel's chunked algorithm (replayed in float64 torch): the two
    sweeps, the per-chunk products and dlw without the states, from the
    suffix sums, equal ``wkv6_bwd_ref``."""
    xs = _inputs((2, 2, T, 64), 11, with_s0, with_dsf, lw_scale)
    if edge == "ends":
        xs[3][..., ::5] = LOG_W_MIN             # on the end: kept
        xs[3][..., 1::7] = 0.0
    elif edge == "chunk_at_floor":
        xs[3][:, :, 16:32] = LOG_W_MIN          # e^{-cum} reaches e^56
    got = _replay_kernel(*xs)
    want = wkv6_bwd_ref(*_torch(xs))
    _check_all(got, [None if w is None else w.numpy() for w in want],
               f"replay T={T} lw_scale={lw_scale} edge={edge}")


def _bwd_views(D, T=40):
    return [torch.randn(2, T, 3, D).transpose(1, 2) for _ in range(5)]


def test_bwd_plan():
    """What the kernel takes as it is: the model's (B, T, H, 64) views
    viewed as (B, H, T, 64); D < 64 is padded (every input copied), a
    bf16 dy, a D-strided or 4-byte-offset view is copied; D > 64 plans
    ``"wide"`` as it is on the model's views."""
    plan = plan_wkv6_bwd(*_bwd_views(64))
    assert (plan.variant, plan.head_dim) == ("chunk", 64)
    assert plan.copy == (False,) * 5
    assert plan_wkv6_bwd(*_bwd_views(48)).copy == (True,) * 5
    r, k, v, lw, dy = _bwd_views(64)
    assert plan_wkv6_bwd(r, k, v, lw, dy.bfloat16()).copy == (False,) * 4 + (True,)
    base = torch.randn(2, 3, 40, 65)
    assert plan_wkv6_bwd(base[..., 1:], k, v, lw, dy).copy[0]
    v_strided = torch.randn(2, 3, 64, 40).transpose(2, 3)   # D not contiguous
    assert plan_wkv6_bwd(r, k, v_strided, lw, dy).copy == (
        False, False, True, False, False)
    assert plan_wkv6_bwd(*_bwd_views(128)) == ("wide", 128, (False,) * 5)


# D > 64 and the "wide" plan: (head dim, inputs copied) -- D padded to a
# multiple of 4 (16-byte rows for cp.async), nothing else
WIDE_PLANS = [(65, (68, True)), (96, (96, False)), (128, (128, False)),
              (200, (200, False)), (254, (256, True)), (256, (256, False)),
              (288, (288, False)), (1000, (1000, False)),
              (2048, (2048, False)), (2100, (2100, False)),
              (4097, (4100, True))]


@pytest.mark.parametrize("D,want", WIDE_PLANS)
def test_bwd_plan_wide(D, want):
    """Above D = 64 the plan is ``"wide"``, D padded only to a multiple of
    4; a view the kernel reads as it is goes in uncopied, a D-strided one
    is copied."""
    x = torch.empty((1, 2, 3, D), device="meta")
    p = plan_wkv6_bwd(x, x, x, x, x)
    assert (p.variant, p.head_dim, p.copy[0]) == ("wide",) + want
    assert len(set(p.copy)) == 1
    if not want[1]:
        views = _bwd_views(D, T=5)
        assert plan_wkv6_bwd(*views).copy == (False,) * 5
        strided = torch.randn(2, 3, D, 5).transpose(2, 3)
        assert plan_wkv6_bwd(*views[:2], strided, *views[3:]).copy == (
            False, False, True, False, False)


def _replay_wide(r, k, v, lw, u, s0, dy, ds_fin, cols=16, chans=2048):
    """float64 torch replay of ``wkv6_bwd.cu``'s "wide" schedule: the value
    columns in groups of ``cols`` and the channels in passes of ``chans``,
    each (group, pass) running both sweeps over its own columns J and
    channels I -- S[I, J] and dS[I, J] carried, dr, dk, dlw (its own
    P_fin and suffix sums) and du as the group's partials over J, dv[:, J]
    as the pass's partial over I -- then the partials added in group
    (pass) order.  Rows and columns past T and D are the kernel's zeros
    (identity rows)."""
    f = torch.float64
    r, k, v, lw, dy = (torch.from_numpy(x).to(f) for x in (r, k, v, lw, dy))
    u = torch.from_numpy(u).to(f)
    B, H, T, D = r.shape
    C = 16
    nc = -(-T // C)

    def chunks(x):
        return torch.nn.functional.pad(x, (0, 0, 0, nc * C - T)).view(
            B, H, nc, C, D)

    rc, kc, vc, dyc, lwc = (chunks(x) for x in (r, k, v, dy, lw))
    g = torch.clamp(lwc, LOG_W_MIN, 0.0)
    cum = g.cumsum(3)
    cp = cum - g
    last = cum[:, :, :, -1:]
    rt, kt = rc * torch.exp(cp), kc * torch.exp(-cum)
    ke = kc * torch.exp(last - cum)
    inside = (lwc >= LOG_W_MIN) & (lwc <= 0.0)
    tril = torch.tril(torch.ones(C, C, dtype=f), -1)
    triu = tril.T

    def tr(x):
        return x.transpose(-1, -2)

    S0 = None if s0 is None else torch.from_numpy(s0).to(f)
    DSF = None if ds_fin is None else torch.from_numpy(ds_fin).to(f)
    outs = [torch.zeros_like(rc) for _ in range(4)]  # dr, dk, dv, dlw
    du = torch.zeros((B, H, D), dtype=f)
    ds0 = torch.zeros((B, H, D, D), dtype=f)
    for j0 in range(0, D, cols):
        J = slice(j0, min(D, j0 + cols))
        vJ, dyJ = vc[..., J], dyc[..., J]
        vdy = (vJ * dyJ).sum(-1, keepdim=True)       # the group's share
        for i0 in range(0, D, chans):
            I = slice(i0, min(D, i0 + chans))
            rI, kI, rtI, ktI, keI = (x[..., I] for x in (rc, kc, rt, kt, ke))
            cpI, cumI, lastI = cp[..., I], cum[..., I], last[..., I]
            uI = u[:, None, I]
            S = torch.zeros((B, H, I.stop - I.start, J.stop - J.start),
                            dtype=f) if S0 is None else S0[:, :, I, J]
            qs = torch.zeros_like(rI)
            for c in range(nc):
                x = dyJ[:, :, c] @ tr(S) + (tril * (dyJ[:, :, c] @ tr(vJ[:, :, c]))) @ ktI[:, :, c]
                drp = torch.exp(cpI[:, :, c]) * x
                outs[0][:, :, c, :, I] += drp + uI * kI[:, :, c] * vdy[:, :, c]
                qs[:, :, c] = rI[:, :, c] * drp
                du[..., I] += (rI[:, :, c] * kI[:, :, c] * vdy[:, :, c]).sum(2)
                S = tr(torch.exp(lastI[:, :, c])) * (S + tr(ktI[:, :, c]) @ vJ[:, :, c])
            dS = (torch.zeros_like(S) if DSF is None else DSF[:, :, I, J])
            P = (dS * S).sum(-1)                      # P_fin's share
            qs = qs.view(B, H, nc * C, -1)
            for c in reversed(range(nc)):
                x1 = vJ[:, :, c] @ tr(dS)
                x2 = (triu * (vJ[:, :, c] @ tr(dyJ[:, :, c]))) @ rtI[:, :, c]
                dkp = torch.exp(lastI[:, :, c] - cumI[:, :, c]) * x1 + torch.exp(-cumI[:, :, c]) * x2
                outs[1][:, :, c, :, I] += dkp + uI * rI[:, :, c] * vdy[:, :, c]
                bonus = (rI[:, :, c] * uI * kI[:, :, c]).sum(-1, keepdim=True)
                outs[2][:, :, c, :, J] += (
                    (triu * (ktI[:, :, c] @ tr(rtI[:, :, c]))) @ dyJ[:, :, c]
                    + keI[:, :, c] @ dS + bonus * dyJ[:, :, c])
                dS = tr(torch.exp(lastI[:, :, c])) * dS + tr(rtI[:, :, c]) @ dyJ[:, :, c]
                for t in reversed(range(min(C, T - c * C))):
                    glw = P - kI[:, :, c, t] * dkp[:, :, t]
                    P = glw + (qs[:, :, c * C + t] if c * C + t > 0 else 0.0)
                    outs[3][:, :, c, t, I] += torch.where(
                        inside[:, :, c, t, I], glw, 0.0)
            ds0[:, :, I, J] = dS

    def rows(x):
        return x.reshape(B, H, nc * C, D)[:, :, :T].numpy()

    return (*(rows(x) for x in outs), du.sum(0).numpy(),
            None if s0 is None else ds0.numpy())


# (B, H, T, D), s0, ds_fin, lw_scale, channels a pass: the wide variant's
# padded head dims, T on both sides of a chunk, lw on the clamp's ends and
# beyond, and channel passes (a pass of 48 channels stands for 2,048)
WIDE_REPLAY_CASES = [
    ((1, 2, 33, 128), True, True, 1.0, 2048),
    ((2, 1, 17, 96), False, True, 8.0, 2048),
    ((1, 2, 1, 288), True, False, 1.0, 2048),
    ((1, 1, 20, 96), True, True, 1.0, 48),
]


@pytest.mark.parametrize("shape,with_s0,with_dsf,lw_scale,chans",
                         WIDE_REPLAY_CASES)
def test_wide_kernel_replay_matches_bwd_ref(shape, with_s0, with_dsf,
                                            lw_scale, chans):
    """The "wide" backward's schedule (replayed in float64 torch): the
    value-column groups' partials of dr, dk, dlw, du and the channel
    passes' partials of dv, added in order, equal ``wkv6_bwd_ref``."""
    xs = _inputs(shape, 5 + sum(shape), with_s0, with_dsf, lw_scale)
    got = _replay_wide(*xs, chans=chans)
    want = wkv6_bwd_ref(*_torch(xs))
    _check_all(got, [None if w is None else w.numpy() for w in want],
               f"wide replay {shape} passes of {chans}")
