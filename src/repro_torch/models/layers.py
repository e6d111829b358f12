"""Shared model layers: norms, RoPE, grouped-query attention, MLPs and the
embedding / logits pair.

The same functions as the reference package's ``repro.models.layers``,
with parameters passed as mappings of tensors under the reference's names
(``p["scale"]``, ``p["wq"]``, ``p["table"]``, ...) and the reference's
layouts (weights ``(in, out)``, activations ``(B, S, H, hd)``).  Where the
reference computes in float32 from bf16 operands — norms, RoPE, the
attention scores and softmax, tied logits — the operands are upcast here
too: a bf16 ``torch.matmul`` would round its result to bf16.

:func:`self_attention` is a block's attention over its own whole sequence,
causal (prefill, scoring, a decoder's self-attention) or not (an
encoder's): on CUDA tensors it launches flash attention kernel B6, on CPU
tensors it is :func:`gqa_attention`, the reference model's own
arithmetic.  The two differ in one rounding: B6 keeps the
attention weights in float32 for the PV product, where ``gqa_attention``
rounds them to the value dtype first (ROADMAP Queue C); in float32 they
are the same function.

:func:`cross_entropy_loss` is the training loss of every family.  The
reference's ``logical_constraint`` (mesh sharding hints) has no meaning on
one GPU.
"""

from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import attention
from repro_torch.models.config import ModelConfig

__all__ = [
    "norm_init", "norm_apply", "rope", "attention_init", "attention_qkv",
    "gqa_attention", "self_attention", "mlp_init", "gelu_tanh", "mlp_apply",
    "embed_init", "embed_lookup", "logits_from_embedding", "dense_init",
    "cross_entropy_loss",
]

Params = Mapping[str, torch.Tensor]

_MASKED = -1e30


def norm_init(
    cfg: ModelConfig, device: torch.device, d: Optional[int] = None
) -> Dict[str, torch.Tensor]:
    """A norm's parameters (``scale``, and ``bias`` for LayerNorm) over
    ``d`` (default d_model): float32 whatever the parameter dtype."""
    d = d or cfg.d_model
    p = {"scale": torch.ones(d, dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(d, dtype=torch.float32, device=device)
    return p


def norm_apply(p: Params, x: torch.Tensor, kind: str = "rmsnorm") -> torch.Tensor:
    """RMSNorm or LayerNorm over the last axis, in float32, cast back."""
    xf = x.to(torch.float32)
    if kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + 1e-6) * p["scale"]
        if "bias" in p:
            y = y + p["bias"]
    else:
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + 1e-6) * p["scale"]
    return y.to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary position embedding.  x: (..., S, H, hd), positions: (..., S)."""
    half = x.shape[-1] // 2
    log_theta = torch.log(torch.tensor(theta, dtype=torch.float32))
    freqs = torch.exp(
        -log_theta.to(x.device)
        * torch.arange(half, dtype=torch.float32, device=x.device) / half
    )
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, half)
    cos = torch.cos(ang)[..., None, :]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)


def attention_init(
    cfg: ModelConfig, generator: torch.Generator
) -> Dict[str, torch.Tensor]:
    """An attention block's ``wq``, ``wk``, ``wv``, ``wo`` (and the
    ``q_norm`` / ``k_norm`` scales with ``qk_norm``), as the reference's
    ``attention_qkv_init`` shapes them."""
    D, hd, H, Hkv = cfg.d_model, cfg.hd, cfg.n_heads, cfg.n_kv_heads
    pd = cfg.pdtype
    p = {
        "wq": dense_init((D, H * hd), pd, generator),
        "wk": dense_init((D, Hkv * hd), pd, generator),
        "wv": dense_init((D, Hkv * hd), pd, generator),
        "wo": dense_init((H * hd, D), pd, generator),
    }
    if cfg.qk_norm:
        p["q_norm"] = norm_init(cfg, generator.device, hd)
        p["k_norm"] = norm_init(cfg, generator.device, hd)
    return p


def attention_qkv(
    p: Params,
    x: torch.Tensor,          # (B, S, D)
    positions: torch.Tensor,  # (B, S)
    cfg: ModelConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Project and rotate: q (B, S, H, hd), k and v (B, S, Hkv, hd)."""
    B, S, _ = x.shape
    hd, H, Hkv = cfg.hd, cfg.n_heads, cfg.n_kv_heads
    q = (x @ p["wq"]).reshape(B, S, H, hd)
    k = (x @ p["wk"]).reshape(B, S, Hkv, hd)
    v = (x @ p["wv"]).reshape(B, S, Hkv, hd)
    if cfg.qk_norm:
        q = norm_apply(p["q_norm"], q, cfg.norm)
        k = norm_apply(p["k_norm"], k, cfg.norm)
    if cfg.rope_theta > 0:
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    return q, k, v


def _and(a: Optional[torch.Tensor], b: torch.Tensor) -> torch.Tensor:
    return b if a is None else a & b


def gqa_attention(
    q: torch.Tensor,                 # (B, Sq, H, hd)
    k: torch.Tensor,                 # (B, Sk, Hkv, hd)
    v: torch.Tensor,                 # (B, Sk, Hkv, hd)
    q_positions: torch.Tensor,       # (B, Sq)
    k_positions: torch.Tensor,       # (B, Sk)
    *,
    causal: bool,
    window: Optional[int],
    kv_valid: Optional[torch.Tensor] = None,  # (B, Sk) bool
) -> torch.Tensor:
    """Grouped-query attention, (B, Sq, H, hd) in ``q``'s dtype.

    Scores, mask and softmax in float32 (the reference's einsums ask for
    float32 results from storage-dtype operands); the attention weights are
    rounded to the value dtype for the PV product, which again sums in
    float32.  Broadcast KV is never materialized."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    scale = hd ** -0.5

    qg = q.reshape(B, Sq, Hkv, G, hd)
    s = torch.einsum(
        "bqhgd,bkhd->bhgqk", qg.to(torch.float32), k.to(torch.float32)
    ) * scale  # (B, Hkv, G, Sq, Sk)

    qp = q_positions[:, None, None, :, None]
    kp = k_positions[:, None, None, None, :]
    # the mask broadcasts against s; None is the reference's all-true mask
    mask = None
    if causal:
        mask = kp <= qp
    if window is not None:
        mask = _and(mask, kp > qp - window)
    if kv_valid is not None:
        mask = _and(mask, kv_valid[:, None, None, None, :])
    if mask is not None:
        s = torch.where(mask, s, _MASKED)
    m = s.amax(dim=-1, keepdim=True)
    p_ = torch.exp(s - m)
    if mask is not None:
        p_ = torch.where(mask, p_, 0.0)
    denom = torch.clamp(p_.sum(-1, keepdim=True), min=1e-30)
    p_ = p_ / denom
    o = torch.einsum(
        "bhgqk,bkhd->bqhgd",
        p_.to(v.dtype).to(torch.float32), v.to(torch.float32),
    )
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def self_attention(
    q: torch.Tensor,          # (B, S, H, hd)
    k: torch.Tensor,          # (B, S, Hkv, hd)
    v: torch.Tensor,          # (B, S, Hkv, hd)
    positions: torch.Tensor,  # (B, S): 0 .. S - 1 in every row
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    """Attention of a sequence over itself — causal (optionally within a
    sliding window) or, with ``causal=False``, over all of it — (B, S, H,
    hd) in ``q``'s dtype.  CUDA tensors go through kernel B6 as transposed
    views (no copy; the kernel reads positions as the sequence index), CPU
    tensors through :func:`gqa_attention`."""
    if q.is_cuda:
        o = attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                      causal=causal, window=window)
        return o.transpose(1, 2)
    return gqa_attention(q, k, v, positions, positions, causal=causal,
                         window=window)


def mlp_init(
    cfg: ModelConfig, generator: torch.Generator
) -> Dict[str, torch.Tensor]:
    """A feed-forward block's ``w_in``, ``w_out`` (and ``w_gate`` for the
    gated kinds), as the reference's ``mlp_init`` shapes them."""
    D, F_, pd = cfg.d_model, cfg.d_ff, cfg.pdtype
    p = {
        "w_in": dense_init((D, F_), pd, generator),
        "w_out": dense_init((F_, D), pd, generator),
    }
    if cfg.mlp in ("swiglu", "geglu"):
        p["w_gate"] = dense_init((D, F_), pd, generator)
    return p


def _in_dtype(v: float, dtype: torch.dtype) -> float:
    """The Python float ``v`` rounded to ``dtype``: a weakly typed
    constant in the reference, which JAX casts to the array's dtype."""
    return float(torch.tensor(v, dtype=dtype))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x, approximate=True)`` op by op in ``x``'s dtype::

        x * (0.5 * (1 + tanh(sqrt(2 / pi) * (x + 0.044715 * x * x * x))))

    with every constant and every intermediate rounded to that dtype, as
    the reference computes it (``F.gelu`` rounds only its result: in bf16
    the two part in about four elements of ten)."""
    c = _in_dtype(math.sqrt(2.0 / math.pi), x.dtype)
    inner = x + _in_dtype(0.044715, x.dtype) * (x * x * x)
    return x * (0.5 * (1.0 + torch.tanh(c * inner)))


def mlp_apply(p: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """The feed-forward block: swiglu, geglu, squared_relu or relu."""
    h = x @ p["w_in"]
    if cfg.mlp == "swiglu":
        h = F.silu(x @ p["w_gate"]) * h
    elif cfg.mlp == "geglu":
        h = gelu_tanh(x @ p["w_gate"]) * h
    elif cfg.mlp == "squared_relu":
        r = F.relu(h)
        h = r * r
    elif cfg.mlp == "relu":
        h = F.relu(h)
    else:
        raise ValueError(f"unknown mlp {cfg.mlp!r}")
    return h @ p["w_out"]


def embed_init(
    cfg: ModelConfig, generator: torch.Generator
) -> Dict[str, torch.Tensor]:
    """The (vocab_padded, D) table of std 1/sqrt(D), which keeps tied-head
    logits at O(1) scale at init, and the (D, vocab_padded) head when the
    embeddings are untied."""
    Vp, D = cfg.vocab_padded, cfg.d_model
    p = {"table": dense_init((Vp, D), cfg.pdtype, generator, scale=D ** -0.5)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init((D, Vp), cfg.pdtype, generator)
    return p


def embed_lookup(p: Params, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Token embeddings (…, D) in the compute dtype."""
    return p["table"][tokens.long()].to(cfg.cdtype)


def logits_from_embedding(
    p: Params, x: torch.Tensor, cfg: ModelConfig
) -> torch.Tensor:
    """float32 logits (…, vocab_padded): the tied table or the head, padded
    vocab entries masked to -1e30, then the optional soft cap."""
    xf = x.to(torch.float32)
    if cfg.tie_embeddings:
        logits = xf @ p["table"].to(torch.float32).T
    else:
        logits = xf @ p["head"].to(torch.float32)
    if cfg.vocab_padded != cfg.vocab:
        pad = torch.arange(cfg.vocab_padded, device=x.device) >= cfg.vocab
        logits = torch.where(pad, _MASKED, logits)
    if cfg.logit_softcap:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


def cross_entropy_loss(
    logits: torch.Tensor,  # (B, S, V) float32
    labels: torch.Tensor,  # (B, S) int, -1 = ignore
    z_loss: float = 0.0,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Mean next-token NLL over the labelled positions (label -1 ignored,
    the denominator ``max(valid, 1)``), plus ``z_loss`` times the mean
    squared log-normalizer when it is positive.  Metrics: ``nll``,
    ``tokens`` and, with a z-loss, ``z_loss``."""
    valid = labels >= 0
    safe = torch.where(valid, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, safe[..., None])[..., 0]
    nll = (lse - ll) * valid
    denom = torch.clamp(valid.sum(), min=1)
    loss = nll.sum() / denom
    metrics = {"nll": loss, "tokens": denom}
    if z_loss > 0:
        zl = z_loss * ((lse * valid) ** 2).sum() / denom
        loss = loss + zl
        metrics["z_loss"] = zl
    return loss, metrics


def dense_init(
    shape: Tuple[int, ...],
    dtype: torch.dtype,
    generator: torch.Generator,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Normal weights of std ``scale`` (default fan_in ** -0.5, fan_in the
    first axis), drawn in float32 on the generator's device, then cast."""
    std = scale if scale is not None else (
        shape[0] ** -0.5 if len(shape) >= 2 else 1.0
    )
    w = torch.randn(shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    return (w * std).to(dtype)
