"""Encoder-decoder backbone (seamless-m4t-medium).

The reference package's ``repro.models.encdec.EncDecLM`` as an
``nn.Module`` holding its weights: ``n_encoder_layers`` bidirectional
encoder blocks over precomputed frame embeddings (B, S_enc, D) — the
speech frontend is a stub in the reference too — and ``n_layers`` causal
decoder blocks, each with self-attention, cross-attention to the encoder
output and an MLP.  Parameters keep the reference's names
(``enc_layers.<i>.attn.wq``, ``dec_layers.<i>.cross_attn.wk``, ...), so
:func:`repro_torch.convert.encdec_from_numpy` carries a JAX tree across;
the layer scan, rematerialization and ``logical_constraint`` have no
counterpart.

**Attention.**  The encoder's self-attention (not causal) and the
decoder's causal self-attention in ``prefill`` go through
:func:`~repro_torch.models.layers.self_attention` (kernel B6 on the card);
cross-attention (queries and keys of different lengths) and every
attention of ``decode_step`` through
:func:`~repro_torch.models.layers.gqa_attention`, as the reference computes
them all outside Pallas.

**State** (returned by ``prefill``): ``self``, a
:class:`~repro_torch.models.kvcache.FullKV` of the decoder's
self-attention; ``cross_k`` / ``cross_v`` (L, B, S_enc, Hkv, hd), each
layer's keys and values of the encoder output, computed once; and
``enc_positions`` (B, S_enc).  ``decode_step`` updates it in place.  Both
run under ``torch.inference_mode()``.  :meth:`EncDecLM.loss` is the
training loss: every encoder and decoder block rematerialized with
``torch.utils.checkpoint``, as the reference's encoder and decoder scans
are.
"""

from __future__ import annotations

from typing import Dict, Tuple

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
    embed_init,
    embed_lookup,
    gqa_attention,
    logits_from_embedding,
    mlp_apply,
    mlp_init,
    norm_apply,
    norm_init,
)
from repro_torch.models.transformer import ParamTree

__all__ = ["EncDecLM"]

State = Dict[str, object]


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


class EncDecLM(nn.Module):
    """Encoder-decoder LM.  Weights are drawn on ``device`` from a
    ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device="cuda"):
        super().__init__()
        if cfg.n_encoder_layers <= 0:
            raise ValueError("EncDecLM: n_encoder_layers must be positive")
        self.cfg = cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        norm = lambda: norm_init(cfg, dev)
        self.embed = ParamTree(embed_init(cfg, gen))
        self.enc_layers = nn.ModuleList(ParamTree({
            "ln_attn": norm(), "attn": attention_init(cfg, gen),
            "ln_mlp": norm(), "mlp": mlp_init(cfg, gen),
        }) for _ in range(cfg.n_encoder_layers))
        self.dec_layers = nn.ModuleList(ParamTree({
            "ln_self": norm(), "self_attn": attention_init(cfg, gen),
            "ln_cross": norm(), "cross_attn": attention_init(cfg, gen),
            "ln_mlp": norm(), "mlp": mlp_init(cfg, gen),
        }) for _ in range(cfg.n_layers))
        self.ln_enc = ParamTree(norm())
        self.ln_out = ParamTree(norm())

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    def _out(self, wo, x: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
        B, S, H, hd = o.shape
        return x + (o.reshape(B, S, H * hd) @ wo).to(x.dtype)

    def _mlp(self, lp, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        return x + mlp_apply(lp["mlp"], norm_apply(lp["ln_mlp"], x, cfg.norm),
                             cfg).to(x.dtype)

    def _enc_block(self, lp, x: torch.Tensor, positions: torch.Tensor
                   ) -> torch.Tensor:
        cfg = self.cfg
        q, k, v = attention_qkv(lp["attn"],
                                norm_apply(lp["ln_attn"], x, cfg.norm),
                                positions, cfg)
        o = layers.self_attention(q, k, v, positions, causal=False)
        return self._mlp(lp, self._out(lp["attn"]["wo"], x, o))

    def _encode(self, frames: torch.Tensor, remat: bool) -> torch.Tensor:
        cfg = self.cfg
        x = frames.to(self.device, cfg.cdtype)
        B, S, _ = x.shape
        positions = _positions(B, S, x.device)
        for lp in self.enc_layers:
            if remat:
                x = checkpoint(self._enc_block, lp, x, positions,
                               use_reentrant=False)
            else:
                x = self._enc_block(lp, x, positions)
        return norm_apply(self.ln_enc, x, cfg.norm)

    @torch.inference_mode()
    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        """frames (B, S_enc, D) -> the normed encoder output in the compute
        dtype."""
        return self._encode(frames, remat=False)

    def _dec_block(self, lp, x, positions, enc_out, enc_positions
                   ) -> torch.Tensor:
        """A decoder block over the whole sequence (training)."""
        cfg = self.cfg
        B, Se, _ = enc_out.shape
        q, k, v = attention_qkv(lp["self_attn"],
                                norm_apply(lp["ln_self"], x, cfg.norm),
                                positions, cfg)
        o = layers.self_attention(q, k, v, positions, causal=True)
        x = self._out(lp["self_attn"]["wo"], x, o)
        ca = lp["cross_attn"]
        shape = (B, Se, cfg.n_kv_heads, cfg.hd)
        x = self._cross(lp, x, positions, (enc_out @ ca["wk"]).reshape(shape),
                        (enc_out @ ca["wv"]).reshape(shape), enc_positions)
        return self._mlp(lp, x)

    def loss(self, batch: Dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss of ``batch`` (``frames`` (B, S_enc, D),
        ``tokens``, ``labels`` (B, S)) and its metrics (``nll``,
        ``tokens``)."""
        cfg = self.cfg
        enc_out = self._encode(batch["frames"], remat=True)
        B, Se, _ = enc_out.shape
        enc_positions = _positions(B, Se, enc_out.device)
        tokens = batch["tokens"]
        x = embed_lookup(self.embed, tokens, cfg)
        positions = _positions(B, tokens.shape[1], x.device)
        for lp in self.dec_layers:
            x = checkpoint(self._dec_block, lp, x, positions, enc_out,
                           enc_positions, use_reentrant=False)
        x = norm_apply(self.ln_out, x, cfg.norm)
        return cross_entropy_loss(logits_from_embedding(self.embed, x, cfg),
                                  batch["labels"])

    def _cross(self, lp, x, positions, kc, vc, enc_positions):
        """Cross-attention to the encoder's keys and values, added to x."""
        cfg = self.cfg
        B, S, _ = x.shape
        c_in = norm_apply(lp["ln_cross"], x, cfg.norm)
        qc = (c_in @ lp["cross_attn"]["wq"]).reshape(B, S, cfg.n_heads, cfg.hd)
        oc = gqa_attention(qc, kc, vc, positions, enc_positions,
                           causal=False, window=None)
        return self._out(lp["cross_attn"]["wo"], x, oc)

    @torch.inference_mode()
    def prefill(self, batch: Dict, max_len: int) -> Tuple[torch.Tensor, State]:
        """Encode ``batch["frames"]`` and run the decoder over
        ``batch["tokens"]`` (B, S): last-token logits (B, 1, vocab_padded)
        float32 and the state, its ``self`` cache of ``max_len`` positions
        holding the prompt's keys and values (written as each layer is
        reached)."""
        cfg = self.cfg
        enc_out = self.encode(batch["frames"])
        B, Se, _ = enc_out.shape
        enc_positions = _positions(B, Se, enc_out.device)
        tokens = batch["tokens"]
        S = tokens.shape[1]
        x = embed_lookup(self.embed, tokens, cfg)
        positions = _positions(B, S, x.device)
        cache = kvc.full_kv_init(cfg, B, max_len, x.device)
        cshape = (cfg.n_layers, B, Se, cfg.n_kv_heads, cfg.hd)
        cross_k = torch.empty(cshape, dtype=enc_out.dtype, device=x.device)
        cross_v = torch.empty_like(cross_k)
        for i, lp in enumerate(self.dec_layers):
            q, k, v = attention_qkv(lp["self_attn"],
                                    norm_apply(lp["ln_self"], x, cfg.norm),
                                    positions, cfg)
            cache.k[i, :, :S] = k
            cache.v[i, :, :S] = v
            o = layers.self_attention(q, k, v, positions, causal=True)
            x = self._out(lp["self_attn"]["wo"], x, o)
            ca = lp["cross_attn"]
            shape = (B, Se, cfg.n_kv_heads, cfg.hd)
            cross_k[i] = (enc_out @ ca["wk"]).reshape(shape)
            cross_v[i] = (enc_out @ ca["wv"]).reshape(shape)
            x = self._cross(lp, x, positions, cross_k[i], cross_v[i],
                            enc_positions)
            x = self._mlp(lp, x)
        cache.pos.fill_(S)
        x = norm_apply(self.ln_out, x[:, -1:], cfg.norm)
        state = {"self": cache, "cross_k": cross_k, "cross_v": cross_v,
                 "enc_positions": enc_positions}
        return logits_from_embedding(self.embed, x, cfg), state

    @torch.inference_mode()
    def decode_step(self, state: State, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, State]:
        """One token for every sequence: ``tokens`` (B, 1) at positions
        ``state["self"].pos``.  Returns logits (B, 1, vocab_padded) float32
        and the state, its cache updated in place and ``pos`` advanced."""
        cfg = self.cfg
        cache: kvc.FullKV = state["self"]
        B = tokens.shape[0]
        x = embed_lookup(self.embed, tokens, cfg)
        positions = cache.pos[:, None]
        k_positions = _positions(B, cache.max_len, x.device)
        valid = k_positions <= positions
        for i, lp in enumerate(self.dec_layers):
            q, k_new, v_new = attention_qkv(
                lp["self_attn"], norm_apply(lp["ln_self"], x, cfg.norm),
                positions, cfg)
            k_l, v_l = kvc.full_kv_update_layer(cache.k[i], cache.v[i], k_new,
                                                v_new, cache.pos)
            o = gqa_attention(q, k_l, v_l, positions, k_positions,
                              causal=True, window=None, kv_valid=valid)
            x = self._out(lp["self_attn"]["wo"], x, o)
            x = self._cross(lp, x, positions, state["cross_k"][i],
                            state["cross_v"][i], state["enc_positions"])
            x = self._mlp(lp, x)
        x = norm_apply(self.ln_out, x, cfg.norm)
        cache.pos = cache.pos + 1
        return logits_from_embedding(self.embed, x, cfg), state
