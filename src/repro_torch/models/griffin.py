"""RecurrentGemma / Griffin hybrid: RG-LRU recurrence and local attention.

The reference package's ``repro.models.griffin.GriffinLM`` as an
``nn.Module`` holding its weights.  Blocks come in super-blocks of
(recurrent, recurrent, local attention), each followed by an MLP, and
``n_layers % attn_every`` tail recurrent blocks: recurrentgemma-9b's 38
layers are 12 super-blocks and 2 tails.  Parameters keep the reference's
names (``supers.<i>.ln_r1.scale``, ``tails.t0.rec.w_in``, ...), so
:func:`repro_torch.convert.griffin_from_numpy` carries a JAX tree across;
the reference's layer scan, rematerialization and ``logical_constraint``
have no counterpart.

RG-LRU, per channel of the d_rnn-wide branch (after a depthwise causal
convolution of ``conv_width`` taps)::

    r_t = sigmoid(W_a x_t + b_a),  i_t = sigmoid(W_x x_t + b_x)
    a_t = exp(-8 softplus(lam) r_t)
    h_t = a_t h_{t-1} + sqrt(max(1 - a_t^2, 1e-12)) (i_t x_t)

in float32.  Over a sequence the linear recurrence runs as
:func:`pair_scan`, the odd/even pairing tree of ``jax.lax.associative_scan``
written out in PyTorch (the same association, about 2 log2 S steps on the
card); :func:`sequential_scan` is its plain version, one step a position.
A decode step is one step of the recurrence.

**Attention.**  Multi-query local attention over a window
``W = cfg.sliding_window or 2048``: in ``prefill`` through
:func:`~repro_torch.models.layers.self_attention` (kernel B6 on the card),
in ``decode_step`` through :func:`~repro_torch.models.layers.gqa_attention`
over a ring of the last W keys (the reference computes both outside any
Pallas kernel).

**State** (:meth:`GriffinLM.init_state`, returned by ``prefill``) is a
dict under the reference's keys and layouts: ``conv1``, ``h1``, ``conv2``,
``h2`` (each super-block's two recurrent blocks), ``k``, ``v``, ``k_pos``
(its ring), all with a leading super-block axis; ``tail_conv{t}``,
``tail_h{t}``; ``pos``.  ``decode_step`` updates it in place.
``prefill`` and ``decode_step`` run under ``torch.inference_mode()``.
:meth:`GriffinLM.loss` is the training loss: the super-blocks
rematerialized with ``torch.utils.checkpoint`` (the reference's
``jax.checkpoint`` over its super-block scan), the tails not, the local
attention's window ``cfg.sliding_window or S`` as in the reference's loss.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.models import kvcache as kvc
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    attention_init,
    attention_qkv,
    cross_entropy_loss,
    dense_init,
    embed_init,
    embed_lookup,
    gelu_tanh,
    gqa_attention,
    logits_from_embedding,
    mlp_apply,
    mlp_init,
    norm_apply,
    norm_init,
)
from repro_torch.models.transformer import ParamTree

__all__ = ["GriffinLM", "pair_scan", "sequential_scan", "causal_conv",
           "rg_lru"]

_LRU_C = 8.0

State = Dict[str, torch.Tensor]


def _rec_init(cfg: ModelConfig, gen: torch.Generator) -> Dict[str, torch.Tensor]:
    D, R, pd, dev = cfg.d_model, cfg.d_rnn, cfg.pdtype, gen.device
    zeros = lambda: torch.zeros(R, dtype=torch.float32, device=dev)
    return {
        "w_in": dense_init((D, R), pd, gen),
        "w_gate": dense_init((D, R), pd, gen),
        "conv_w": dense_init((cfg.conv_width, R), pd, gen, scale=0.5),
        "w_a": dense_init((R, R), pd, gen),
        "b_a": zeros(),
        "w_x": dense_init((R, R), pd, gen),
        "b_x": zeros(),
        "lam": torch.full((R,), 1.0, dtype=torch.float32, device=dev),
        "w_out": dense_init((R, D), pd, gen),
    }


def causal_conv(
    x: torch.Tensor,                # (B, S, R)
    w: torch.Tensor,                # (CW, R) depthwise taps
    state: Optional[torch.Tensor],  # (B, CW - 1, R) previous inputs
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal convolution: (out (B, S, R), the last CW - 1
    inputs).  Taps summed in the reference's order, from 0."""
    CW = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], CW - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    S = x.shape[1]
    out = sum(xp[:, i:i + S] * w[i] for i in range(CW))
    new_state = xp[:, -(CW - 1):] if CW > 1 else pad
    return out, new_state


def _combine(first, second):
    """(a1, b1) then (a2, b2): the composition of h -> a h + b."""
    a1, b1 = first
    a2, b2 = second
    return a1 * a2, a2 * b1 + b2


def pair_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """All prefixes h_t = a_t h_{t-1} + b_t (h_{-1} = 0) along axis 1, by
    ``jax.lax.associative_scan``'s recursion: combine adjacent pairs, scan
    the half, then fill in the even positions."""
    return _pair_scan(a, b)[1]


def _pair_scan(a: torch.Tensor, b: torch.Tensor):
    """:func:`pair_scan` of the pairs (a, b): both halves of each prefix's
    composition."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd = _pair_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]),
                               (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        even = _combine((odd[0][:, :-1], odd[1][:, :-1]),
                        (a[:, 2::2], b[:, 2::2]))
    else:
        even = _combine(odd, (a[:, 2::2], b[:, 2::2]))
    outs = []
    for x, ev, od in zip((a, b), even, odd):
        r = x.new_empty(x.shape)
        r[:, 0::2] = torch.cat([x[:, :1], ev], dim=1)
        r[:, 1::2] = od
        outs.append(r)
    return outs[0], outs[1]


def sequential_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`pair_scan`: one step a position."""
    h = torch.zeros_like(b[:, 0])
    out = torch.empty_like(b)
    for t in range(b.shape[1]):
        h = a[:, t] * h + b[:, t]
        out[:, t] = h
    return out


def rg_lru(
    x: torch.Tensor,            # (B, S, R) conv output
    p,
    h0: Optional[torch.Tensor],  # (B, R) float32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RG-LRU over ``x``: (h (B, S, R) in x's dtype, the last h (B, R)
    float32).  One step when S == 1 and a carry is given."""
    xf = x.to(torch.float32)
    r = torch.sigmoid(xf @ p["w_a"].to(torch.float32) + p["b_a"])
    i = torch.sigmoid(xf @ p["w_x"].to(torch.float32) + p["b_x"])
    # jax.nn.softplus is logaddexp(x, 0)
    softplus = torch.logaddexp(p["lam"], torch.zeros_like(p["lam"]))
    a = torch.exp(-_LRU_C * softplus * r)
    gated = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * xf)
    if x.shape[1] == 1 and h0 is not None:  # decode
        h = a[:, 0] * h0 + gated[:, 0]
        return h[:, None].to(x.dtype), h
    if h0 is not None:  # the carry folded into the first step
        gated[:, 0] = gated[:, 0] + a[:, 0] * h0
    h_seq = pair_scan(a, gated)
    return h_seq.to(x.dtype), h_seq[:, -1].to(torch.float32)


def _rec_apply(p, x: torch.Tensor, cfg: ModelConfig,
               state: Optional[Dict]) -> Tuple[torch.Tensor, Dict]:
    """A recurrent block; ``state`` {conv (B, CW-1, R), h (B, R)} or None
    (from zero)."""
    gate = gelu_tanh(x @ p["w_gate"])
    u = x @ p["w_in"]
    u, conv_state = causal_conv(u, p["conv_w"],
                                None if state is None else state["conv"])
    h, h_last = rg_lru(u, p, None if state is None else state["h"])
    out = ((gate * h) @ p["w_out"]).to(x.dtype)
    return out, {"conv": conv_state.to(x.dtype), "h": h_last}


def _mlp_res(ln, mlp, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return x + mlp_apply(mlp, norm_apply(ln, x, cfg.norm), cfg).to(x.dtype)


class GriffinLM(nn.Module):
    """RecurrentGemma.  Weights are drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device="cuda"):
        super().__init__()
        if cfg.n_kv_heads not in (1, cfg.n_heads):
            raise ValueError("GriffinLM: n_kv_heads must be 1 or n_heads")
        self.cfg = cfg
        self.n_super = cfg.n_layers // cfg.attn_every
        self.n_tail = cfg.n_layers - self.n_super * cfg.attn_every
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.embed = ParamTree(embed_init(cfg, gen))
        norm = lambda: norm_init(cfg, dev)
        self.supers = nn.ModuleList(ParamTree({
            "ln_r1": norm(), "rec1": _rec_init(cfg, gen),
            "ln_m1": norm(), "mlp1": mlp_init(cfg, gen),
            "ln_r2": norm(), "rec2": _rec_init(cfg, gen),
            "ln_m2": norm(), "mlp2": mlp_init(cfg, gen),
            "ln_a": norm(), "attn": attention_init(cfg, gen),
            "ln_m3": norm(), "mlp3": mlp_init(cfg, gen),
        }) for _ in range(self.n_super))
        self.tails = ParamTree({
            f"t{t}": {"ln_r": norm(), "rec": _rec_init(cfg, gen),
                      "ln_m": norm(), "mlp": mlp_init(cfg, gen)}
            for t in range(self.n_tail)
        })
        self.ln_out = ParamTree(norm())

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    @property
    def window(self) -> int:
        return self.cfg.sliding_window or 2048

    def _recurrent_pair(self, sp, x, states):
        """The super-block's two recurrent blocks and their MLPs."""
        cfg = self.cfg
        new = {}
        for j in ("1", "2"):
            st = None if states is None else {"conv": states[f"conv{j}"],
                                              "h": states[f"h{j}"]}
            r_out, ns = _rec_apply(sp[f"rec{j}"],
                                   norm_apply(sp[f"ln_r{j}"], x, cfg.norm),
                                   cfg, st)
            x = _mlp_res(sp[f"ln_m{j}"], sp[f"mlp{j}"], x + r_out, cfg)
            new[f"conv{j}"], new[f"h{j}"] = ns["conv"], ns["h"]
        return x, new

    def _attn_out(self, sp, x, o):
        B, S, H, hd = o.shape
        x = x + (o.reshape(B, S, H * hd) @ sp["attn"]["wo"]).to(x.dtype)
        return _mlp_res(sp["ln_m3"], sp["mlp3"], x, self.cfg)

    def _tail_fwd(self, tp, x, state):
        cfg = self.cfg
        r_out, ns = _rec_apply(tp["rec"], norm_apply(tp["ln_r"], x, cfg.norm),
                               cfg, state)
        return _mlp_res(tp["ln_m"], tp["mlp"], x + r_out, cfg), ns

    def _super_train(self, sp, x, positions, window: int) -> torch.Tensor:
        """A super-block over the whole sequence from zero state."""
        cfg = self.cfg
        x, _ = self._recurrent_pair(sp, x, None)
        q, k, v = attention_qkv(sp["attn"], norm_apply(sp["ln_a"], x, cfg.norm),
                                positions, cfg)
        o = layers.self_attention(q, k, v, positions, window=window)
        return self._attn_out(sp, x, o)

    def loss(self, batch: Dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss of ``batch`` (``tokens``, ``labels`` (B, S))
        and its metrics (``nll``, ``tokens``)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = embed_lookup(self.embed, tokens, cfg)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        window = cfg.sliding_window or S
        for sp in self.supers:
            x = checkpoint(self._super_train, sp, x, positions, window,
                           use_reentrant=False)
        for t in range(self.n_tail):
            x, _ = self._tail_fwd(self.tails[f"t{t}"], x, None)
        x = norm_apply(self.ln_out, x, cfg.norm)
        return cross_entropy_loss(logits_from_embedding(self.embed, x, cfg),
                                  batch["labels"])

    def init_state(self, batch_size: int) -> State:
        """The state at position 0 on the model's device: zeros, every
        ring slot empty (``k_pos`` -1)."""
        cfg, dev = self.cfg, self.device
        R, CW, W, NS = cfg.d_rnn, cfg.conv_width, self.window, self.n_super
        mk = lambda *s: torch.zeros(s, dtype=cfg.cdtype, device=dev)
        f32 = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)
        state = {
            "conv1": mk(NS, batch_size, CW - 1, R),
            "h1": f32(NS, batch_size, R),
            "conv2": mk(NS, batch_size, CW - 1, R),
            "h2": f32(NS, batch_size, R),
            "k": mk(NS, batch_size, W, cfg.n_kv_heads, cfg.hd),
            "v": mk(NS, batch_size, W, cfg.n_kv_heads, cfg.hd),
            "k_pos": torch.full((NS, batch_size, W), -1, dtype=torch.int32,
                                device=dev),
            "pos": torch.zeros((batch_size,), dtype=torch.int32, device=dev),
        }
        for t in range(self.n_tail):
            state[f"tail_conv{t}"] = mk(batch_size, CW - 1, R)
            state[f"tail_h{t}"] = f32(batch_size, R)
        return state

    @torch.inference_mode()
    def prefill(self, batch: Dict, max_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, State]:
        """Run the prompt once: last-token logits (B, 1, vocab_padded)
        float32 and the serving state, each ring holding the last
        ``min(S, W)`` keys and values in slots ``position % W``
        (``max_len`` is not read)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        B, S = tokens.shape
        x = embed_lookup(self.embed, tokens, cfg)
        dev = x.device
        positions = torch.arange(S, dtype=torch.int32, device=dev).expand(B, S)
        W = self.window
        take = min(S, W)
        abs_pos = torch.arange(S - take, S, dtype=torch.int32, device=dev)
        slots = (abs_pos % W).long()
        state = self.init_state(B)
        state["k_pos"][:, :, slots] = abs_pos
        for i, sp in enumerate(self.supers):
            x, new = self._recurrent_pair(sp, x, None)
            for name, t in new.items():
                state[name][i] = t
            q, k, v = attention_qkv(sp["attn"], norm_apply(sp["ln_a"], x, cfg.norm),
                                    positions, cfg)
            o = layers.self_attention(q, k, v, positions, window=W)
            state["k"][i][:, slots] = k[:, S - take:].to(cfg.cdtype)
            state["v"][i][:, slots] = v[:, S - take:].to(cfg.cdtype)
            x = self._attn_out(sp, x, o)
        for t in range(self.n_tail):
            x, ns = self._tail_fwd(self.tails[f"t{t}"], x, None)
            state[f"tail_conv{t}"] = ns["conv"].contiguous()
            state[f"tail_h{t}"] = ns["h"]
        state["pos"].fill_(S)
        x = norm_apply(self.ln_out, x[:, -1:], cfg.norm)
        return logits_from_embedding(self.embed, x, cfg), state

    @torch.inference_mode()
    def decode_step(self, state: State, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, State]:
        """One token for every sequence: ``tokens`` (B, 1) at positions
        ``state["pos"]``.  Returns logits (B, 1, vocab_padded) float32 and
        the state, updated in place."""
        cfg = self.cfg
        B = tokens.shape[0]
        x = embed_lookup(self.embed, tokens, cfg)
        pos = state["pos"]
        positions = pos[:, None]
        W = self.window
        rows = torch.arange(B, device=pos.device)
        slot = (pos % W).long()
        for i, sp in enumerate(self.supers):
            x, new = self._recurrent_pair(
                sp, x, {n: state[n][i] for n in ("conv1", "h1", "conv2", "h2")})
            for name, t in new.items():
                state[name][i] = t
            q, k_new, v_new = attention_qkv(
                sp["attn"], norm_apply(sp["ln_a"], x, cfg.norm), positions, cfg)
            k_layer, v_layer = kvc.sliding_kv_update_layer(
                state["k"][i], state["v"][i], k_new, v_new, pos)
            k_pos = state["k_pos"][i]
            k_pos[rows, slot] = pos
            valid = (k_pos >= 0) & (k_pos > positions - W)
            o = gqa_attention(q, k_layer, v_layer, positions, k_pos,
                              causal=True, window=W, kv_valid=valid)
            x = self._attn_out(sp, x, o)
        for t in range(self.n_tail):
            st = {"conv": state[f"tail_conv{t}"], "h": state[f"tail_h{t}"]}
            x, ns = self._tail_fwd(self.tails[f"t{t}"], x, st)
            state[f"tail_conv{t}"].copy_(ns["conv"])
            state[f"tail_h{t}"].copy_(ns["h"])
        x = norm_apply(self.ln_out, x, cfg.norm)
        state["pos"] = pos + 1
        return logits_from_embedding(self.embed, x, cfg), state
