"""The PyTorch port's MoE FFN and the ``moe`` family of ``DecoderLM``
against the JAX package, on the CPU.

The same numpy inputs go to both packages; expert weights are the
reference's ``moe_init`` draws, decoder weights reach the port through
:func:`repro_torch.convert.decoder_from_numpy`.  The reference's
``moe_apply`` returns only its output and aux, so its intermediates are
recomputed here with its own lines (``src/repro/models/moe.py:77-147``,
``_capacity`` and ``_seg_rank`` called as they are); the JAX side runs
under ``jax.jit``, as a served model does.  Tolerances:

* routing — ``topi``, the stable sort ``order``, ``keep``, ``dest`` — and
  ``moe_dropped_frac``: exact;
* the combine (``.at[src].add`` there, :func:`moe_combine` here) on the
  reference's own contributions: bit for bit, float32 and bf16, with
  ``top_k = 6`` (three or more adds per token, so the fold order shows;
  ``test_reversed_fold_differs`` shows it does) and with dropped tokens;
* ``moe_apply``'s output: float32 ``rtol = 1e-5`` and ``atol = 1e-5``
  times JAX's largest value (a layer's output is O(100) at the smoke
  configs' expert init, whose fan-in is the expert count; the expert
  products sum in another order: about 6e-7 of the largest value seen),
  bf16 within eight bf16 steps of JAX's largest value, as
  ``tests/test_torch_decoder_lm.py`` holds the dense decoder; the lb / z
  losses ``atol = rtol = 1e-5``;
* ``DecoderLM`` prefill + 3 decode steps on the moonshot and mixtral
  (MoE + sliding ring) smoke configs, float32 and bf16: logits and cache
  at ``tests/test_torch_decoder_lm.py``'s tolerances, positions exactly.
  Both packages' routings are recorded layer by layer: in float32 every
  decision must agree; in bf16 a decision may differ only where the two
  packages' router inputs agree within the bf16 tolerance (the two
  frameworks round the bf16 residual at different places: a flip at a
  margin of 5.0e-3 relative, above 2^-8, was seen at the moonshot smoke
  config), and the sequence it belongs to is then left out of the
  comparison from its position on (one expert more or less changes that
  token's output outright).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import mixtral_8x7b as jax_mixtral
from repro.configs import moonshot_v1_16b_a3b as jax_moonshot
from repro.models import moe as jmoe
from repro.models.transformer import DecoderLM as JaxDecoderLM
from repro_torch.convert import decoder_from_numpy
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig

F32_TOL = 1e-5


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def _t(a):
    """A reference array as a tensor in its own dtype (bf16 kept)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _close(got, want, bf16, what, scaled=False):
    """bf16: within 8 bf16 steps of the largest value; float32: ``atol =
    rtol = 1e-5``, the atol times the largest value when ``scaled`` (one
    layer's output at the smoke configs' expert init is O(100))."""
    want = _np(want)
    big = float(np.abs(want).max())
    if bf16:
        np.testing.assert_allclose(_np(got), want, atol=8 * 2.0 ** -8 * big,
                                   rtol=0, err_msg=what)
    else:
        atol = F32_TOL * max(big, 1.0) if scaled else F32_TOL
        np.testing.assert_allclose(_np(got), want, atol=atol, rtol=F32_TOL,
                                   err_msg=what)


_jax_moe_apply = jax.jit(jmoe.moe_apply, static_argnums=2)


def _jax_pieces(p, x, cfg):
    """:func:`_jax_lines` under ``jax.jit``, with its static sizes."""
    N = x.shape[0] * x.shape[1]
    G = cfg.moe_groups if N % max(cfg.moe_groups, 1) == 0 else 1
    G = max(G, 1)
    out = _jax_lines_jit(p, x, cfg)
    return dict(out, G=G, cap=jmoe._capacity(N // G, cfg))


def _jax_lines(p, x, cfg):
    """The reference's ``moe_apply`` up to its combine, line for line
    (``src/repro/models/moe.py:77-147``): routing, dispatch, the experts'
    outputs, the contributions, and the combined output."""
    B, S, D = x.shape
    N = B * S
    E, k = cfg.num_experts, cfg.top_k
    G = cfg.moe_groups if N % max(cfg.moe_groups, 1) == 0 else 1
    G = max(G, 1)
    Ng = N // G
    cap = jmoe._capacity(Ng, cfg)
    xf = x.reshape(G, Ng, D)
    logits = jnp.einsum("gnd,de->gne", xf.astype(jnp.float32), p["router"])
    probs = jax.nn.softmax(logits, axis=-1)
    topw, topi = jax.lax.top_k(probs, k)
    topw = topw / jnp.maximum(topw.sum(-1, keepdims=True), 1e-9)
    M = Ng * k
    flat_e = topi.reshape(G, M)
    order = jnp.argsort(flat_e, axis=1, stable=True)
    sorted_e = jnp.take_along_axis(flat_e, order, axis=1)
    pos_in_e = jmoe._seg_rank(sorted_e)
    keep = pos_in_e < cap
    dest = jnp.where(keep, sorted_e * cap + pos_in_e, E * cap)
    src_token = order // k
    gathered_in = jax.vmap(lambda t, s: t[s])(xf, src_token)
    buf = jax.vmap(
        lambda vals, idx: jnp.zeros((E * cap, D), x.dtype)
        .at[idx].set(vals, mode="drop"))(gathered_in, dest)
    buf = buf.reshape(G, E, cap, D)
    h = jnp.einsum("gecd,edf->gecf", buf, p["w_in"])
    if cfg.mlp == "swiglu":
        h = jax.nn.silu(jnp.einsum("gecd,edf->gecf", buf, p["w_gate"])) * h
    elif cfg.mlp == "geglu":
        h = jax.nn.gelu(jnp.einsum("gecd,edf->gecf", buf, p["w_gate"]),
                        approximate=True) * h
    else:
        h = jax.nn.relu(h)
    out_buf = jnp.einsum("gecf,efd->gecd", h, p["w_out"]).reshape(G, E * cap, D)
    out_buf = jnp.concatenate([out_buf, jnp.zeros((G, 1, D), out_buf.dtype)],
                              axis=1)
    gathered = jax.vmap(lambda t, d: t[d])(out_buf, dest)
    w = (jnp.take_along_axis(topw.reshape(G, M), order, axis=1)
         * keep).astype(x.dtype)
    contrib = gathered * w[..., None]
    out = jax.vmap(lambda c, s: jnp.zeros((Ng, D), x.dtype).at[s].add(c))(
        contrib, src_token)
    return dict(topi=topi, order=order, keep=keep, dest=dest,
                contrib=contrib, src_token=src_token, out=out)


_jax_lines_jit = jax.jit(_jax_lines, static_argnums=2)


# name -> (config module, overrides, (B, S), router skew)
CASES = {
    "moonshot_k6": (jax_moonshot, dict(top_k=6), (2, 48), 0.0),
    "moonshot_k6_bf16": (jax_moonshot, dict(top_k=6, param_dtype="bfloat16",
                                            compute_dtype="bfloat16"), (2, 48), 0.0),
    # E = 16, k = 6, N = 96 with a router skewed toward expert 0: drops
    "dropped": (jax_moonshot, dict(num_experts=16, top_k=6), (2, 48), 4.0),
    "dropped_bf16": (jax_moonshot, dict(num_experts=16, top_k=6,
                                        param_dtype="bfloat16",
                                        compute_dtype="bfloat16"), (2, 48), 4.0),
    "groups2": (jax_moonshot, dict(top_k=3, moe_groups=2), (2, 48), 0.0),
    # 96 tokens do not split into 5 groups: one group
    "groups_fallback": (jax_moonshot, dict(top_k=3, moe_groups=5), (2, 48), 0.0),
    "mixtral": (jax_mixtral, {}, (2, 40), 0.0),
    "geglu": (jax_moonshot, dict(top_k=4, mlp="geglu"), (3, 20), 0.0),
    "relu": (jax_moonshot, dict(top_k=3, mlp="relu"), (3, 20), 0.0),
}


def _case(name, seed=0):
    mod, kw, (B, S), skew = CASES[name]
    jcfg = mod.smoke_config().replace(**kw)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    p = jmoe.moe_init(jax.random.PRNGKey(seed), jcfg)
    if skew:
        p = dict(p, router=p["router"].at[:, 0].add(skew))
    rng = np.random.default_rng(seed + 1)
    x = rng.normal(size=(B, S, jcfg.d_model)).astype(np.float32)
    if skew:
        x += 1.0  # a common direction, so the skewed column wins often
    jx = jnp.asarray(x, jcfg.cdtype)
    return jcfg, cfg, p, jx, {n: _t(v) for n, v in p.items()}, _t(jx)


@pytest.mark.parametrize("name", list(CASES))
def test_moe_apply_matches_jax(name):
    jcfg, cfg, p, jx, tp, x = _case(name)
    bf16 = cfg.compute_dtype == "bfloat16"
    J = _jax_pieces(p, jx, jcfg)
    jout, jaux = _jax_moe_apply(p, jx, jcfg)
    # the lines above are the reference's own
    np.testing.assert_array_equal(_np(J["out"]).reshape(jout.shape), _np(jout))

    G = J["G"]
    xf = x.reshape(G, -1, cfg.d_model)
    route = moe.moe_route(tp["router"], xf, cfg.top_k)
    np.testing.assert_array_equal(route.topi.numpy(), np.asarray(J["topi"]))
    assert moe.capacity(xf.shape[1], cfg) == J["cap"]
    d = moe.moe_dispatch(route.topi, J["cap"], cfg.num_experts)
    for f in ("order", "keep", "dest", "src_token"):
        np.testing.assert_array_equal(getattr(d, f).numpy(), np.asarray(J[f]),
                                      err_msg=f)
    if name.startswith("dropped"):
        assert not bool(np.asarray(J["keep"]).all())  # tokens do drop

    # the combine on the reference's own contributions: bit for bit
    got = moe.moe_combine(_t(J["contrib"]), d.order, cfg.top_k)
    np.testing.assert_array_equal(_np(got).view(np.int32),
                                  _np(J["out"]).view(np.int32))

    out, aux = moe.moe_apply(tp, x, cfg)
    assert out.dtype == x.dtype and tuple(out.shape) == jout.shape
    _close(out, jout, bf16, "moe_apply out", scaled=True)
    # the reference's expression (moe.py:152) on its own keep flags, run
    # eagerly as its tests do: under jax.jit XLA rounds 1 - keep.mean() to
    # -7.45e-9 where nothing drops
    want_dropped = float(1.0 - J["keep"].mean())
    assert float(aux["moe_dropped_frac"]) == want_dropped
    assert abs(float(jaux["moe_dropped_frac"]) - want_dropped) < 1e-7
    for n in ("moe_lb_loss", "moe_z_loss"):
        np.testing.assert_allclose(float(aux[n]), float(jaux[n]),
                                   rtol=F32_TOL, atol=F32_TOL, err_msg=n)


@pytest.mark.parametrize("name", ["moonshot_k6", "dropped_bf16"])
def test_combine_plain_version_equals_reference(name):
    """The plain version (one add a contribution, in update order) equals
    the reference's ``.at[src].add`` bit for bit."""
    jcfg, cfg, p, jx, tp, x = _case(name)
    J = _jax_pieces(p, jx, jcfg)
    got = moe.moe_combine_ref(_t(J["contrib"]), _t(J["src_token"]).long(),
                              J["out"].shape[1])
    np.testing.assert_array_equal(_np(got).view(np.int32),
                                  _np(J["out"]).view(np.int32))


def test_reversed_fold_differs():
    """The inputs tell fold orders apart: each token's k contributions
    added in descending sorted position give other bits than the
    reference's."""
    jcfg, cfg, p, jx, tp, x = _case("moonshot_k6")
    J = _jax_pieces(p, jx, jcfg)
    order = _t(J["order"]).long()
    # fold each token's contributions from its last sorted position down
    contrib = _t(J["contrib"])
    G, M, D = contrib.shape
    k = cfg.top_k
    inv = torch.argsort(order, dim=1)
    pos = torch.sort(inv.reshape(G, M // k, k), dim=-1, descending=True).values
    rev = torch.zeros((G, M // k, D))
    for j in range(k):
        rev = rev + torch.gather(contrib, 1, pos[..., j:j + 1].expand(-1, -1, D))
    want = _np(J["out"])
    np.testing.assert_allclose(rev.numpy(), want, rtol=1e-5, atol=1e-4)
    assert not np.array_equal(rev.numpy().view(np.int32), want.view(np.int32))


def test_topk_tie_picks_lower_expert():
    """Two equal router columns: where the tie sits at the k-th place,
    both packages keep the lower expert."""
    jcfg, cfg, p, jx, tp, x = _case("moonshot_k6")
    router = p["router"].at[:, 5].set(p["router"][:, 2])
    p = dict(p, router=router)
    J = _jax_pieces(p, jx, jcfg)
    route = moe.moe_route(_t(router), x.reshape(1, -1, cfg.d_model), cfg.top_k)
    topi = route.topi.numpy()
    np.testing.assert_array_equal(topi, np.asarray(J["topi"]))
    at_boundary = (topi == 2).any(-1) & ~(topi == 5).any(-1)
    assert at_boundary.sum() > 0          # the tie decided a k-th place
    assert not ((topi == 5).any(-1) & ~(topi == 2).any(-1)).any()


LM_CASES = {
    "moonshot": (jax_moonshot, {}, 11),
    "moonshot_bf16": (jax_moonshot, dict(param_dtype="bfloat16",
                                         compute_dtype="bfloat16"), 11),
    # MoE + a sliding window of 16 over a 40-token prompt: the ring wraps
    "mixtral": (jax_mixtral, {}, 40),
    "mixtral_bf16": (jax_mixtral, dict(param_dtype="bfloat16",
                                       compute_dtype="bfloat16"), 40),
}
# float32: a flipped top-k decision is allowed only where the k-th and
# the (k+1)-th router probability lie within this share of the k-th
F32_FLIP_MARGIN = 1e-4


def _keep_by_token(topi, cap):
    """(G, Ng, k) kept flags of each (token, slot), the reference's rule."""
    G, Ng, k = topi.shape
    flat = topi.reshape(G, -1)
    order = np.argsort(flat, axis=1, kind="stable")
    sorted_e = np.take_along_axis(flat, order, axis=1)
    start = np.concatenate([np.ones((G, 1), bool),
                            sorted_e[:, 1:] != sorted_e[:, :-1]], axis=1)
    iota = np.broadcast_to(np.arange(flat.shape[1]), flat.shape)
    rank = iota - np.maximum.accumulate(np.where(start, iota, 0), axis=1)
    keep = np.empty_like(rank, dtype=bool)
    np.put_along_axis(keep, order, rank < cap, axis=1)
    return keep.reshape(G, Ng, k)


def _record_routes(monkeypatch, jtr_mod, ttr_mod, log):
    """Wrap both packages' ``moe_apply`` as their decoders call it: each
    call appends (topi, probs, keep, x) as (B, S, ·) float32 / int numpy
    to log["jax"] / log["port"]."""
    jax_apply, port_apply = jtr_mod.moe_apply, ttr_mod.moe_apply

    def note(key, shape, topi, probs, x, cap):
        topi, probs = np.asarray(topi), np.asarray(probs)
        keep = _keep_by_token(topi.reshape(1, -1, topi.shape[-1]), cap)
        log[key].append(tuple(
            np.asarray(a).reshape(tuple(shape[:2]) + a.shape[-1:])
            for a in (topi, probs, keep, np.asarray(x))))

    def jax_wrapped(p, x, cfg):
        xf = x.reshape(1, -1, x.shape[-1]).astype(jnp.float32)
        probs = jax.nn.softmax(jnp.einsum("gnd,de->gne", xf, p["router"]), -1)
        cap = jmoe._capacity(xf.shape[1], cfg)
        jax.debug.callback(
            lambda t, pr, xx: note("jax", x.shape, t, pr, xx, cap),
            jax.lax.top_k(probs, cfg.top_k)[1], probs, xf, ordered=True)
        return jax_apply(p, x, cfg)

    def port_wrapped(p, x, cfg):
        r = moe.moe_route(p["router"], x.reshape(1, -1, x.shape[-1]), cfg.top_k)
        note("port", tuple(x.shape), r.topi, r.probs, x.float(),
             moe.capacity(r.topi.shape[1], cfg))
        return port_apply(p, x, cfg)

    monkeypatch.setattr(jtr_mod, "moe_apply", jax_wrapped)
    monkeypatch.setattr(ttr_mod, "moe_apply", port_wrapped)


def _flips(log, k, bf16, positions):
    """Walk the two packages' routings call by call (layer by layer,
    prefill then each decode step; ``positions[c]`` the positions of call
    c) with :func:`moe.routing_flips`.  A top-k difference at a position
    still routed alike must come from the rounding of the router input:
    the two packages' inputs there agree within the dtype's tolerance
    (``_close``, of that token's own largest value), and in float32 the
    k-th and (k+1)-th probabilities lie within ``F32_FLIP_MARGIN`` of each
    other.  Returns the sequences routed alike throughout and the flips
    (call, sequence, position, margin)."""
    assert len(log["jax"]) == len(log["port"]) == len(positions)
    B = log["jax"][0][0].shape[0]
    run = lambda key: [(torch.tensor(t), torch.tensor(kp.sum(-1)))
                       for t, _, kp, _ in log[key]]
    found, first = moe.routing_flips(run("jax"), run("port"), positions)
    flips = []
    for c, b, t in found:
        (_, jp, _, jx), (_, tp, _, tx) = log["jax"][c], log["port"][c]
        _close(tx[b, t], jx[b, t], bf16, f"call {c}: router input of a "
               f"flipped token, sequence {b} position {positions[c][t]}")
        for pr in (jp[b, t], tp[b, t]):
            rel = float(moe.top_k_margin(torch.tensor(pr), k))
            flips.append((c, b, int(positions[c][t]), rel))
            assert bf16 or rel <= F32_FLIP_MARGIN, flips[-1]
    return [b for b in range(B) if b not in first], flips


def test_routing_flips_walk():
    """:func:`moe.routing_flips` on hand-made routings of 3 sequences of 4
    tokens over 3 calls (layers): a flip is reported only at a position
    still routed alike, a kept-count difference reroutes its sequence from
    there too, and a kept count that differs with no top-k set is
    refused."""
    k = 2
    base = torch.arange(3 * 4 * k).reshape(3, 4, k) % 7
    kept = torch.full((3, 4), k)
    a = [(base.clone(), kept.clone()) for _ in range(3)]
    b = [(base.clone(), kept.clone()) for _ in range(3)]
    b[0][0][0, 2] = torch.tensor([5, 6])      # call 0: sequence 0 at 2
    b[1][0][0, 3] = torch.tensor([5, 6])      # after 2: a consequence
    b[1][0][0, 1] = base[0, 1].flip(-1)      # the same set: no flip
    b[1][1][1, 1] = 1                         # call 1: sequence 1 drops at 1
    b[1][0][2, 0] = torch.tensor([0, 6])      # sequence 2 at 0
    b[2][0][1, 1] = torch.tensor([0, 6])      # at 1, rerouted at call 1
    b[2][0][1, 0] = torch.tensor([0, 6])      # at 0: still alike
    positions = [torch.arange(4)] * 3
    flips, first = moe.routing_flips(a, b, positions)
    assert flips == [(0, 0, 2), (1, 2, 0), (2, 1, 0)]
    assert first == {0: 2, 1: 0, 2: 0}
    # a later call at positions 4..7: sequence 0, rerouted from 2, flips
    # there as a consequence; sequence 1 is still routed alike
    dec = (b[2][0].clone(), kept.clone())
    dec[0][0, 0] = torch.tensor([5, 6])
    flips, _ = moe.routing_flips(a[:2], [b[0], dec],
                                 [torch.arange(4), torch.arange(4, 8)])
    assert flips == [(0, 0, 2), (1, 1, 0), (1, 1, 1)]
    c = [(base.clone(), kept.clone())]
    c[0][1][2, 3] = 0
    with pytest.raises(ValueError):
        moe.routing_flips(a[:1], c, positions[:1])
    assert torch.allclose(
        moe.top_k_margin(torch.tensor([0.5, 0.2, 0.3]), 2),
        torch.tensor(1.0 / 3.0, dtype=torch.float64))


@pytest.mark.parametrize("case", list(LM_CASES))
def test_moe_decoder_prefill_and_decode_match_jax(case, monkeypatch):
    """Prefill + 3 decode steps against JAX's.  Logits and caches are
    compared on the sequences whose routing matched JAX's throughout; any
    decision that differs must be a near-tie (:func:`_flips`)."""
    from repro.models import transformer as jtr
    from repro_torch.models import transformer as ttr

    mod, kw, S = LM_CASES[case]
    bf16 = "param_dtype" in kw
    jcfg = mod.smoke_config().replace(**kw)
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    jm = JaxDecoderLM(jcfg)
    params = jm.init(0)
    model = decoder_from_numpy(cfg, jax.tree.map(np.asarray, params),
                               device="cpu")
    jprefill = jax.jit(jm.prefill, static_argnames="max_len")
    jdecode = jax.jit(jm.decode_step)
    assert "moe" in model.blocks[0]._modules
    assert "mlp" not in model.blocks[0]._modules
    log = {"jax": [], "port": []}
    _record_routes(monkeypatch, jtr, ttr, log)
    rng = np.random.default_rng(31)
    B, steps = 4, 3
    prompt = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    toks = rng.integers(0, cfg.vocab, (steps, B, 1)).astype(np.int32)
    max_len = S + steps + 2
    jlog, jcache = jprefill(params, {"tokens": jnp.asarray(prompt)},
                            max_len=max_len)
    logits, cache = model.prefill({"tokens": torch.from_numpy(prompt)},
                                  max_len=max_len)
    assert tuple(logits.shape) == jlog.shape == (B, 1, cfg.vocab_padded)
    # the port's cache is updated in place: keep each step's copy
    snap = lambda lg, jl, c, jc: (lg, jl, c.k.clone(), c.v.clone(), jc.k, jc.v)
    outs = [snap(logits, jlog, cache, jcache)]
    for t in range(steps):
        jlog, jcache = jdecode(params, jcache, jnp.asarray(toks[t]))
        logits, cache = model.decode_step(cache, torch.from_numpy(toks[t]))
        outs.append(snap(logits, jlog, cache, jcache))
        np.testing.assert_array_equal(cache.pos.numpy(), np.asarray(jcache.pos))
        if jcfg.sliding_window is not None:
            np.testing.assert_array_equal(cache.k_pos.numpy(),
                                          np.asarray(jcache.k_pos))
    jax.effects_barrier()
    L = cfg.n_layers
    positions = ([np.arange(S)] * L
                 + [np.array([S + t]) for t in range(steps) for _ in range(L)])
    clean, flips = _flips(log, cfg.top_k, bf16, positions)
    if not bf16:
        assert clean == list(range(B)), flips
    assert clean, f"every sequence routed differently somewhere: {flips}"
    rows = torch.tensor(clean)
    for t, (logits, jlog, *kv) in enumerate(outs):
        _close(logits[rows], np.asarray(jlog)[clean], bf16, f"step {t} logits")
        for name, got, want in zip(("k", "v"), kv[:2], kv[2:]):
            _close(got[:, rows], np.asarray(want)[:, clean], bf16,
                   f"step {t}: cache.{name}")
