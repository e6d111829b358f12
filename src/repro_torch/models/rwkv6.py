"""RWKV6 "Finch": attention-free LM with data-dependent decay.

The reference package's ``repro.models.rwkv6.RWKV6LM`` as an ``nn.Module``
that holds its weights: per layer a :class:`~repro_torch.models.
transformer.ParamTree` under the reference's names (``ln_tm``, ``tm``,
``ln_cm``, ``cm``), run in a Python loop (the reference's layer scan and
rematerialization have no counterpart; nor has its ``logical_constraint``).
:func:`repro_torch.convert.rwkv6_from_numpy` carries a JAX parameter tree
across.

Structure per layer:
  time mix:    token shift -> r, k, v, g, w projections (w through a LoRA),
               the WKV6 scan per 64-dim head, an RMSNorm over all of D
               (whatever ``cfg.norm`` says), gated output
  channel mix: token shift -> squared-ReLU MLP with a receptance gate

**The WKV6 scan** goes through :func:`repro_torch.kernels.wkv6.ops.wkv6`:
on the card it always launches the hand-written kernel B7 (one launch per
layer per ``prefill`` or ``decode_step``), on the CPU it runs the chunked
plain version.  The reference picks between its Pallas kernel and an XLA
lowering of the same factorization with ``cfg.attn_impl``; the port keeps
that field so configs carry across and does not read it.

**Types.**  The shift mixes multiply the compute-dtype activations by
float32 ``mu``, so under JAX's promotion every projection after them is a
float32 product, bf16 weights included, and the WKV6 inputs are float32.
:func:`_mm` reproduces that: the weight is upcast (exact), the activation
never narrowed; the time mix's and channel mix's outputs are cast back to
the residual stream's dtype, as in the reference.

``prefill`` and ``decode_step`` run under ``torch.inference_mode()``: the
parameters build no autograd graph, and the scan has no backward yet.
``loss`` waits for the training slice.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.kernels.wkv6.ops import wkv6
from repro_torch.kernels.wkv6.ref import LOG_W_MIN
from repro_torch.models import kvcache as kvc
from repro_torch.models.config import ModelConfig
from repro_torch.models.kvcache import RWKV_HEAD_DIM
from repro_torch.models.layers import (
    dense_init,
    embed_init,
    embed_lookup,
    logits_from_embedding,
    norm_apply,
    norm_init,
)
from repro_torch.models.transformer import ParamTree

__all__ = ["RWKV6LM", "RWKV_HEAD_DIM", "LORA_R"]

LORA_R = 32

State = Dict[str, torch.Tensor]


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the promoted dtype of the two, as ``jnp.matmul``
    computes it (``torch.matmul`` raises on float32 @ bf16)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt)


def _shift(x: torch.Tensor, state: Optional[torch.Tensor]) -> torch.Tensor:
    """The previous token's x (B, S, D): zeros before the first token, or
    the carried state."""
    if state is None:
        return F.pad(x, (0, 0, 1, 0))[:, :-1]
    return torch.cat([state[:, None, :], x[:, :-1]], dim=1)


def _mix(x: torch.Tensor, prev: torch.Tensor, mu: torch.Tensor) -> torch.Tensor:
    return x + (prev - x) * mu  # lerp token shift


def _time_mix(
    p, x: torch.Tensor, cfg: ModelConfig,
    shift_state: Optional[torch.Tensor],
    wkv_state: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(output (B, S, D) in x's dtype, the last normed input (B, D), the
    final WKV6 state (B, H, 64, 64))."""
    B, S, D = x.shape
    H = D // RWKV_HEAD_DIM
    prev = _shift(x, shift_state)
    mu = p["mu"]
    xr, xk, xv, xw, xg = (_mix(x, prev, mu[i]) for i in range(5))

    r = _mm(xr, p["w_r"]).reshape(B, S, H, RWKV_HEAD_DIM)
    k = _mm(xk, p["w_k"]).reshape(B, S, H, RWKV_HEAD_DIM)
    v = _mm(xv, p["w_v"]).reshape(B, S, H, RWKV_HEAD_DIM)
    g = F.silu(_mm(xg, p["w_g"]))

    w_log = p["w0"] + _mm(torch.tanh(_mm(xw, p["w_lora_a"])), p["w_lora_b"])
    lw = -torch.exp(w_log.to(torch.float32))           # (B, S, D), <= 0
    lw = torch.clamp(lw, LOG_W_MIN, 0.0).reshape(B, S, H, RWKV_HEAD_DIM)

    def to_bhsd(t):
        return t.transpose(1, 2)                        # (B, H, S, hd)

    y, s_fin = wkv6(to_bhsd(r), to_bhsd(k), to_bhsd(v), to_bhsd(lw),
                    p["u"], wkv_state)
    y = y.transpose(1, 2).reshape(B, S, D)
    y = norm_apply(p["gn"], y, "rmsnorm") * g
    out = _mm(y, p["w_o"]).to(x.dtype)
    return out, x[:, -1, :], s_fin


def _channel_mix(
    p, x: torch.Tensor, cfg: ModelConfig,
    shift_state: Optional[torch.Tensor],
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(output (B, S, D) in x's dtype, the last normed input (B, D))."""
    prev = _shift(x, shift_state)
    xk = _mix(x, prev, p["mu"][0])
    xr = _mix(x, prev, p["mu"][1])
    kk = F.relu(_mm(xk, p["w_k"]))
    kk = kk * kk
    out = torch.sigmoid(_mm(xr, p["w_r"])) * _mm(kk, p["w_v"])
    return out.to(x.dtype), x[:, -1, :]


def _layer_tree(cfg: ModelConfig, gen: torch.Generator) -> Dict:
    """One layer's parameters with the reference's init: shift mixes and
    the bonus zero, base log-log decay -1, dense weights of std
    fan_in ** -0.5; norm scales, ``mu``, ``w0`` and ``u`` float32."""
    D, Fd = cfg.d_model, cfg.d_ff
    H = D // RWKV_HEAD_DIM
    pd, dev, f32 = cfg.pdtype, gen.device, torch.float32
    tm = {
        "mu": torch.zeros((5, D), dtype=f32, device=dev),  # r,k,v,w,g
        "w_r": dense_init((D, D), pd, gen),
        "w_k": dense_init((D, D), pd, gen),
        "w_v": dense_init((D, D), pd, gen),
        "w_g": dense_init((D, D), pd, gen),
        "w_o": dense_init((D, D), pd, gen),
        "w0": torch.full((D,), -1.0, dtype=f32, device=dev),
        "w_lora_a": dense_init((D, LORA_R), pd, gen),
        "w_lora_b": dense_init((LORA_R, D), pd, gen),
        "u": torch.zeros((H, RWKV_HEAD_DIM), dtype=f32, device=dev),
        "gn": norm_init(cfg, dev),
    }
    cm = {
        "mu": torch.zeros((2, D), dtype=f32, device=dev),  # k, r
        "w_k": dense_init((D, Fd), pd, gen),
        "w_v": dense_init((Fd, D), pd, gen),
        "w_r": dense_init((D, D), pd, gen),
    }
    return {"ln_tm": norm_init(cfg, dev), "tm": tm,
            "ln_cm": norm_init(cfg, dev), "cm": cm}


class RWKV6LM(nn.Module):
    """RWKV6 LM; weights drawn on ``device`` from a ``torch.Generator``
    seeded with ``seed``."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device="cuda"):
        super().__init__()
        if cfg.family != "rwkv":
            raise ValueError(f"RWKV6LM: family {cfg.family!r} is not 'rwkv'")
        if cfg.d_model % RWKV_HEAD_DIM:
            raise ValueError(
                f"RWKV6LM: d_model {cfg.d_model} is not a multiple of the "
                f"head dim {RWKV_HEAD_DIM}"
            )
        self.cfg = cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.embed = ParamTree(embed_init(cfg, gen))
        self.layers = nn.ModuleList(
            ParamTree(_layer_tree(cfg, gen)) for _ in range(cfg.n_layers)
        )
        self.ln_out = ParamTree(norm_init(cfg, dev))

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    def _apply_layer(
        self, lp, x: torch.Tensor, states: Optional[State]
    ) -> Tuple[torch.Tensor, State]:
        """One layer; ``states`` None (from position 0) or the layer's
        ``att_shift`` / ``cm_shift`` / ``wkv``."""
        cfg = self.cfg
        tm_in = norm_apply(lp["ln_tm"], x, cfg.norm)
        tm_out, att_shift, wkv_s = _time_mix(
            lp["tm"], tm_in, cfg,
            None if states is None else states["att_shift"],
            None if states is None else states["wkv"],
        )
        x = x + tm_out
        cm_in = norm_apply(lp["ln_cm"], x, cfg.norm)
        cm_out, cm_shift = _channel_mix(
            lp["cm"], cm_in, cfg,
            None if states is None else states["cm_shift"],
        )
        x = x + cm_out
        return x, {"att_shift": att_shift, "cm_shift": cm_shift, "wkv": wkv_s}

    def _run(
        self, x: torch.Tensor, state: Optional[State]
    ) -> Tuple[torch.Tensor, State]:
        """All layers over x (B, S, D): the last hidden state and the
        stacked per-layer states (without ``pos``)."""
        outs = []
        for i, lp in enumerate(self.layers):
            layer_state = None if state is None else {
                name: state[name][i] for name in ("att_shift", "cm_shift", "wkv")
            }
            x, ns = self._apply_layer(lp, x, layer_state)
            outs.append(ns)
        return x, {name: torch.stack([o[name] for o in outs])
                   for name in ("att_shift", "cm_shift", "wkv")}

    def init_state(self, batch_size: int) -> State:
        return kvc.rwkv6_state_init(self.cfg, batch_size, self.device)

    @torch.inference_mode()
    def prefill(self, batch: Dict) -> Tuple[torch.Tensor, State]:
        """Run the prompts ``batch["tokens"]`` (B, S) from position 0:
        last-token logits (B, 1, vocab_padded) float32 and the state."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        x, state = self._run(embed_lookup(self.embed, tokens, cfg), None)
        # the norm is per position: normalizing the last one alone equals
        # the reference's norm over all positions followed by the slice
        x = norm_apply(self.ln_out, x[:, -1:], cfg.norm)
        logits = logits_from_embedding(self.embed, x, cfg)
        state["pos"] = torch.full((B,), S, dtype=torch.int32, device=x.device)
        return logits, state

    @torch.inference_mode()
    def decode_step(
        self, state: State, tokens: torch.Tensor
    ) -> Tuple[torch.Tensor, State]:
        """Feed ``tokens`` (B, S') after ``state``: logits (B, S',
        vocab_padded) float32 and the new state (``pos`` + 1, as in the
        reference)."""
        cfg = self.cfg
        x, new_state = self._run(embed_lookup(self.embed, tokens, cfg), state)
        x = norm_apply(self.ln_out, x, cfg.norm)
        logits = logits_from_embedding(self.embed, x, cfg)
        new_state["pos"] = state["pos"] + 1
        return logits, new_state

    def loss(self, batch: Dict):
        raise NotImplementedError(
            "RWKV6LM.loss is not ported yet (ROADMAP, next slices: training)"
        )
