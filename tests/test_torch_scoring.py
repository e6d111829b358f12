"""The PyTorch port's scoring path against the JAX package, on the CPU: the
model layers, the dense decoder's prefill, ``ScoringService.handle`` end
to end, and the serve launcher.

The same numpy inputs go to both packages; the JAX model's weights reach
the port through :func:`repro_torch.convert.decoder_from_numpy`, and the
JAX store's warm state through ``online_state_from_numpy``.  Tolerances:

* every layer, and the last-token logits and cache of
  ``DecoderLM.prefill`` on ``smoke_config()`` (float32): ``rtol=1e-5,
  atol=1e-5`` — matrix products and reductions sum in a
  framework-chosen order;
* the same prefill in bfloat16 (parameters and compute): logits within
  ``atol=0.05`` (logits up to 3.6, largest difference seen 0.031; bf16
  keeps 8 bits, and the two frameworks round activations at different
  places, e.g. inside SiLU);
* ``ScoringService.handle`` (float32 model and table): scores within
  ``atol=1e-4``.  The embeddings differ from JAX's in the last bits,
  since JAX on the CPU fuses each probe's multiply-add
  (``tests/test_torch_signature.py``), and the features within the
  tolerances of ``tests/test_torch_slice.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.featinsight_fraud import smoke_config as jax_smoke_config
from repro.models import layers as jl
from repro.models.transformer import DecoderLM as JaxDecoderLM
from repro.scenarios import fraud_view as jax_fraud_view
from repro.serve.service import FeatureService as JaxService
from repro.serve.service import ScoringService as JaxScoringService
from repro_torch.configs.featinsight_fraud import config, smoke_config
from repro_torch.convert import (
    STATE_ARRAYS,
    decoder_from_numpy,
    online_state_from_numpy,
)
from repro_torch.models import build_model
from repro_torch.models import layers as tl
from repro_torch.models.config import ModelConfig
from repro_torch.models.transformer import DecoderLM
from repro_torch.scenarios import fraud_view
from repro_torch.serve.service import FeatureService, ScoringService

RTOL = ATOL = 1e-5


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _np(x):
    return np.asarray(x.detach().to(torch.float32) if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _cfgs(**kw):
    """(JAX config, port config) built from the same fields."""
    jcfg = jax_smoke_config().replace(**kw)
    return jcfg, ModelConfig(**dataclasses.asdict(jcfg))


def test_config_copies_match():
    for name in ("config", "smoke_config"):
        import repro.configs.featinsight_fraud as jf
        import repro_torch.configs.featinsight_fraud as tf

        a, b = getattr(jf, name)(), getattr(tf, name)()
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert a.vocab_padded == b.vocab_padded and a.hd == b.hd
    assert str(config().pdtype) == "torch.bfloat16"
    assert smoke_config().cdtype == torch.float32


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_apply(kind):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 16)).astype(np.float32) * 3
    p = {"scale": rng.normal(size=16).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.normal(size=16).astype(np.float32)
    want = jl.norm_apply({k: jnp.asarray(v) for k, v in p.items()},
                         jnp.asarray(x), kind)
    got = tl.norm_apply({k: _t(v) for k, v in p.items()}, _t(x), kind)
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


def test_rope():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(2, 7, 3, 8)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32) * 5, (2, 7)).copy()
    want = jl.rope(jnp.asarray(x), jnp.asarray(pos), 10000.0)
    got = tl.rope(_t(x), _t(pos), 10000.0)
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("qk_norm", [False, True])
def test_attention_qkv(qk_norm):
    jcfg, cfg = _cfgs(qk_norm=qk_norm, n_kv_heads=2)
    rng = np.random.default_rng(2)
    D, H, Hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": rng.normal(size=(D, H * hd)), "wk": rng.normal(size=(D, Hkv * hd)),
         "wv": rng.normal(size=(D, Hkv * hd)), "wo": rng.normal(size=(H * hd, D))}
    p = {k: (v * D ** -0.5).astype(np.float32) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    if qk_norm:
        s = rng.normal(size=hd).astype(np.float32)
        jp["q_norm"] = jp["k_norm"] = {"scale": jnp.asarray(s)}
        tp["q_norm"] = tp["k_norm"] = {"scale": _t(s)}
    x = rng.normal(size=(2, 6, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(6, dtype=np.int32), (2, 6)).copy()
    want = jl.attention_qkv(jp, jnp.asarray(x), jnp.asarray(pos), jcfg)
    got = tl.attention_qkv(tp, _t(x), _t(pos), cfg)
    for w, g in zip(want, got):
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(_np(g), _np(w), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["causal", "window", "kv_valid", "full"])
def test_gqa_attention(case, dtype):
    rng = np.random.default_rng(3)
    B, Sq, Sk, H, Hkv, hd = 2, 5, 9, 4, 2, 8
    q = rng.normal(size=(B, Sq, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, Sk, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, Sk, Hkv, hd)).astype(np.float32)
    qp = np.broadcast_to(np.arange(Sk - Sq, Sk, dtype=np.int32), (B, Sq)).copy()
    kp = np.broadcast_to(np.arange(Sk, dtype=np.int32), (B, Sk)).copy()
    valid = rng.random((B, Sk)) < 0.7
    valid[:, 0] = True
    kw = dict(causal=case in ("causal", "window", "kv_valid"),
              window=3 if case == "window" else None)
    jv = jnp.asarray(valid) if case == "kv_valid" else None
    tv = _t(valid) if case == "kv_valid" else None
    want = jl.gqa_attention(
        *(jnp.asarray(a).astype(dtype) for a in (q, k, v)),
        jnp.asarray(qp), jnp.asarray(kp), kv_valid=jv, **kw)
    got = tl.gqa_attention(
        *(_t(a).to(getattr(torch, dtype)) for a in (q, k, v)),
        _t(qp), _t(kp), kv_valid=tv, **kw)
    assert str(got.dtype) == f"torch.{dtype}"
    # bf16: the same f32 softmax, one bf16 rounding of p and of the output
    tol = RTOL if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("mlp", ["swiglu", "geglu", "squared_relu", "relu"])
def test_mlp_apply(mlp):
    jcfg, cfg = _cfgs(mlp=mlp)
    rng = np.random.default_rng(4)
    D, F = cfg.d_model, cfg.d_ff
    p = {"w_in": rng.normal(size=(D, F)) * D ** -0.5,
         "w_out": rng.normal(size=(F, D)) * F ** -0.5}
    if mlp in ("swiglu", "geglu"):
        p["w_gate"] = rng.normal(size=(D, F)) * D ** -0.5
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.normal(size=(3, 4, D)).astype(np.float32)
    want = jl.mlp_apply({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), jcfg)
    got = tl.mlp_apply({k: _t(v) for k, v in p.items()}, _t(x), cfg)
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("case", ["tied", "untied_padded_softcap"])
def test_embed_lookup_and_logits(case):
    kw = {} if case == "tied" else dict(tie_embeddings=False, vocab=200,
                                        logit_softcap=5.0)
    jcfg, cfg = _cfgs(**kw)
    rng = np.random.default_rng(5)
    p = {"table": rng.normal(size=(cfg.vocab_padded, cfg.d_model))
         .astype(np.float32) * 0.1}
    if not cfg.tie_embeddings:
        p["head"] = rng.normal(size=(cfg.d_model, cfg.vocab_padded)).astype(
            np.float32) * 0.1
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    tp = {k: _t(v) for k, v in p.items()}
    tok = rng.integers(0, cfg.vocab, (2, 6)).astype(np.int32)
    np.testing.assert_array_equal(
        _np(tl.embed_lookup(tp, _t(tok), cfg)),
        _np(jl.embed_lookup(jp, jnp.asarray(tok), jcfg)))
    x = rng.normal(size=(2, 3, cfg.d_model)).astype(np.float32)
    want = jl.logits_from_embedding(jp, jnp.asarray(x), jcfg)
    got = tl.logits_from_embedding(tp, _t(x), cfg)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), rtol=RTOL, atol=ATOL)


def _prefill_inputs(cfg, B=3, T=2, seed=6):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)
    fe = rng.normal(size=(B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return tokens, fe


def _both_models(dtype):
    kw = {} if dtype == "float32" else dict(param_dtype="bfloat16",
                                            compute_dtype="bfloat16")
    jcfg, cfg = _cfgs(**kw)
    jm = JaxDecoderLM(jcfg)
    params = jm.init(0)
    model = decoder_from_numpy(cfg, jax.tree.map(np.asarray, params),
                               device="cpu")
    return jm, params, model, cfg


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_jax(dtype):
    jm, params, model, cfg = _both_models(dtype)
    tokens, fe = _prefill_inputs(cfg)
    jlog, jcache = jm.prefill(
        params, {"tokens": jnp.asarray(tokens),
                 "frontend_embeds": jnp.asarray(fe)}, max_len=16)
    batch = {"tokens": _t(tokens), "frontend_embeds": _t(fe)}
    with torch.inference_mode():
        logits, cache = model.prefill(batch, max_len=16)
        fwd = model(batch)
    assert logits.dtype == torch.float32
    assert tuple(logits.shape) == jlog.shape == (3, 1, cfg.vocab_padded)
    # the cache-free forward is the same computation
    np.testing.assert_array_equal(_np(fwd).view(np.int32),
                                  _np(logits).view(np.int32))
    want = _np(jlog)[..., :cfg.vocab]
    got = _np(logits)[..., :cfg.vocab]
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        for a, b in ((cache.k, jcache.k), (cache.v, jcache.v)):
            assert tuple(a.shape) == b.shape
            np.testing.assert_allclose(_np(a), _np(b), rtol=RTOL, atol=ATOL)
    else:
        np.testing.assert_allclose(got, want, atol=0.05)
    np.testing.assert_array_equal(cache.pos.numpy(), np.asarray(jcache.pos))
    assert np.all(_np(logits)[..., cfg.vocab:] == -1e30)


def _jax_state(store):
    s = store.state
    return dict(zip(
        [n for n, _ in STATE_ARRAYS],
        [np.asarray(a) for a in (s.ring.ts, s.ring.vals, s.ring.cursor,
                                 s.bagg.stats, s.bagg.bitmap, s.bagg.bucket)],
    ))


def _fraud_rows(rng, n, t_lo, t_hi, cards):
    card = rng.integers(0, cards, n).astype(np.int32)
    ts = rng.integers(t_lo, t_hi, n).astype(np.int32)
    o = np.lexsort((ts, card))
    return dict(card=card[o], ts=ts[o],
                amount=rng.gamma(1.5, 60.0, n).astype(np.float32),
                mcc=rng.integers(0, 32, n).astype(np.int32),
                device=rng.integers(0, 8, n).astype(np.int32),
                geo=rng.integers(0, 16, n).astype(np.int32))


@pytest.mark.parametrize("num_shards", [None, 4])
def test_scoring_service_matches_jax(num_shards):
    cards = 128
    store_kw = dict(num_keys=cards, capacity=32, num_buckets=32,
                    bucket_size=1024, sharded=num_shards is not None,
                    num_shards=num_shards)
    rng = np.random.default_rng(8)
    jfs = JaxService.build("fraud", jax_fraud_view(), **store_kw)
    jfs.store.ingest(_fraud_rows(rng, 1200, 0, 40_000, cards))
    fs = FeatureService.build("fraud", fraud_view(), device="cpu", **store_kw)
    fs.store.state = online_state_from_numpy(
        _jax_state(jfs.store), device="cpu", bucket_size=1024)

    jm, params, model, cfg = _both_models("float32")
    table = rng.normal(0, 0.02, (1000, 96)).astype(np.float32)  # D < d_model
    jsvc = JaxScoringService(jfs, jm, params, jnp.asarray(table))
    svc = ScoringService(fs, model, torch.as_tensor(table))
    for step in range(2):
        req = _fraud_rows(rng, 24, 40_000 + 600 * step, 40_600 + 600 * step,
                          cards)
        perm = rng.permutation(24)
        req = {c: v[perm] for c, v in req.items()}
        want = jsvc.handle(dict(req))
        got = svc.handle(dict(req))
        assert got.shape == (24,) and got.dtype == np.float32
        assert np.all((got >= 0) & (got <= 1))
        np.testing.assert_allclose(got, want, atol=1e-4)
        # scores depend on the rows: not one constant
        assert np.ptp(got) > 0
    # the store still ingests after scoring (no inference-mode tensors in
    # its state) and scores again
    fs.request(dict(req), ingest=True)
    assert np.all(np.isfinite(svc.handle(dict(req))))


def test_launch_serve_main_on_cpu():
    from repro_torch.launch.serve import main

    out = main(["--device", "cpu", "--requests", "48", "--batch", "16",
                "--history", "400", "--cards", "32"])
    assert out["requests"] == 48 and out["batches"] == 3
    assert out["device"] == "cpu" and out["p50_ms"] > 0


def test_build_model_builds_every_family():
    """Every family of the reference has its model: ``DecoderLM`` for
    dense and moe, ``GriffinLM``, ``EncDecLM``; an unknown family and a
    non-decoder family handed to ``DecoderLM`` raise ``ValueError``."""
    from repro_torch.configs.moonshot_v1_16b_a3b import smoke_config as moe_cfg
    from repro_torch.configs.recurrentgemma_9b import smoke_config as griffin_cfg
    from repro_torch.configs.seamless_m4t_medium import smoke_config as encdec_cfg
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.models.griffin import GriffinLM

    for make, cls in ((moe_cfg, DecoderLM), (griffin_cfg, GriffinLM),
                      (encdec_cfg, EncDecLM)):
        model = build_model(make(), device="cpu")
        assert type(model) is cls, (make().family, type(model))
        assert model.device == torch.device("cpu")
    assert "moe" in build_model(moe_cfg(), device="cpu").blocks[0]._modules
    _, cfg = _cfgs()
    with pytest.raises(ValueError, match="unknown family"):
        build_model(cfg.replace(family="nope"), device="cpu")
    with pytest.raises(ValueError, match="not a decoder"):
        DecoderLM(cfg.replace(family="griffin"), device="cpu")


def test_seeded_init_is_deterministic_and_scaled():
    _, cfg = _cfgs()
    a, b = DecoderLM(cfg, seed=3, device="cpu"), DecoderLM(cfg, seed=3, device="cpu")
    c = DecoderLM(cfg, seed=4, device="cpu")
    wa, wb, wc = (m.blocks[1].attn["wq"] for m in (a, b, c))
    assert torch.equal(wa, wb) and not torch.equal(wa, wc)
    assert abs(float(wa.detach().std()) - cfg.d_model ** -0.5) < 0.01
    assert a.ln_out["scale"].dtype == torch.float32


def test_entry_points_refuse_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU behaviour")
    from repro_torch.launch.serve import main

    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        DecoderLM(smoke_config())
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        build_model(smoke_config())
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        main(["--requests", "1"])
