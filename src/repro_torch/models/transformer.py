"""Decoder-only transformer LM, dense family.

The reference package's ``repro.models.transformer.DecoderLM`` as an
``nn.Module`` that holds its weights: one :class:`DecoderBlock` per layer,
run in a Python loop (the reference's layer scan and rematerialization
exist for compile size and gradients, neither of which applies here).
Parameters keep the reference's names and layouts, so
:func:`repro_torch.convert.decoder_from_numpy` can carry a JAX parameter
tree across.

:meth:`DecoderLM.prefill` is split in two: :meth:`DecoderLM.forward`
returns the last token's logits and builds no cache — the scoring path
calls only this, where the reference's ``jax.jit`` drops the unread cache
on its own — and ``prefill`` builds the cache on top of the same pass:
:class:`~repro_torch.models.kvcache.FullKV`, or the
:class:`~repro_torch.models.kvcache.SlidingKV` ring when the config has a
sliding window.  Both passes run each block's self-attention through
:func:`~repro_torch.models.layers.causal_self_attention` (kernel B6 on the
card).  :meth:`DecoderLM.decode_step` feeds one token per sequence against
either cache, through :func:`~repro_torch.models.layers.gqa_attention`
(the reference computes it outside any Pallas kernel too), and updates
the cache in place.  All three run under ``torch.inference_mode()``: the
parameters build no autograd graph, and B6 has no backward.

Not ported yet (each raises ``NotImplementedError``): the ``moe`` family
and the training loss.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import kvcache as kvc
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    attention_qkv,
    causal_self_attention,
    dense_init,
    embed_init,
    embed_lookup,
    gqa_attention,
    logits_from_embedding,
    mlp_apply,
    norm_apply,
    norm_init,
)

__all__ = ["ParamTree", "DecoderBlock", "DecoderLM"]

Cache = Union[kvc.FullKV, kvc.SlidingKV]


class ParamTree(nn.Module):
    """A nested mapping of parameters, read as ``p["name"]`` like the
    reference's parameter pytrees (a nested mapping becomes a child
    ``ParamTree``)."""

    def __init__(self, tree: Dict):
        super().__init__()
        for name, v in tree.items():
            if isinstance(v, dict):
                self.add_module(name, ParamTree(v))
            else:
                self.register_parameter(name, nn.Parameter(v))

    def __getitem__(self, name: str):
        return getattr(self, name)

    def __contains__(self, name: str) -> bool:
        return name in self._parameters or name in self._modules


class DecoderBlock(nn.Module):
    """Pre-norm attention + MLP block (``ln_attn``, ``attn``, ``ln_mlp``,
    ``mlp`` as in the reference's per-layer parameter tree)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        D, F, hd, H, Hkv = cfg.d_model, cfg.d_ff, cfg.hd, cfg.n_heads, cfg.n_kv_heads
        pd, dev = cfg.pdtype, generator.device
        attn = {
            "wq": dense_init((D, H * hd), pd, generator),
            "wk": dense_init((D, Hkv * hd), pd, generator),
            "wv": dense_init((D, Hkv * hd), pd, generator),
            "wo": dense_init((H * hd, D), pd, generator),
        }
        if cfg.qk_norm:
            attn["q_norm"] = norm_init(cfg, dev, hd)
            attn["k_norm"] = norm_init(cfg, dev, hd)
        mlp = {
            "w_in": dense_init((D, F), pd, generator),
            "w_out": dense_init((F, D), pd, generator),
        }
        if cfg.mlp in ("swiglu", "geglu"):
            mlp["w_gate"] = dense_init((D, F), pd, generator)
        self.ln_attn = ParamTree(norm_init(cfg, dev))
        self.attn = ParamTree(attn)
        self.ln_mlp = ParamTree(norm_init(cfg, dev))
        self.mlp = ParamTree(mlp)

    def forward(
        self, x: torch.Tensor, positions: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(x_out, k, v) for a causal pass over the whole sequence."""
        cfg = self.cfg
        h = norm_apply(self.ln_attn, x, cfg.norm)
        q, k, v = attention_qkv(self.attn, h, positions, cfg)
        o = causal_self_attention(q, k, v, positions,
                                  window=cfg.sliding_window)
        return self._finish(x, o), k, v

    def decode(
        self,
        x: torch.Tensor,            # (B, 1, D)
        positions: torch.Tensor,    # (B, 1)
        cache,                      # FullKV or SlidingKV
        layer: int,
        k_positions: torch.Tensor,  # (B, Sk) after this step's write
        valid: torch.Tensor,        # (B, Sk) bool
    ) -> torch.Tensor:
        """One decode step of this block: writes the step's keys and
        values into layer ``layer`` of ``cache`` (in place) and attends
        over the cache."""
        cfg = self.cfg
        h = norm_apply(self.ln_attn, x, cfg.norm)
        q, k_new, v_new = attention_qkv(self.attn, h, positions, cfg)
        update = (kvc.sliding_kv_update_layer
                  if isinstance(cache, kvc.SlidingKV)
                  else kvc.full_kv_update_layer)
        k_layer, v_layer = update(cache.k[layer], cache.v[layer], k_new,
                                  v_new, cache.pos)
        o = gqa_attention(q, k_layer, v_layer, positions, k_positions,
                          causal=True, window=cfg.sliding_window,
                          kv_valid=valid)
        return self._finish(x, o)

    def _finish(self, x: torch.Tensor, o: torch.Tensor) -> torch.Tensor:
        """The output projection and the MLP, each added to the residual."""
        cfg = self.cfg
        B, S, H, hd = o.shape
        x = x + (o.reshape(B, S, H * hd) @ self.attn["wo"]).to(x.dtype)
        h = norm_apply(self.ln_mlp, x, cfg.norm)
        return x + mlp_apply(self.mlp, h, cfg).to(x.dtype)


class DecoderLM(nn.Module):
    """Dense decoder LM with a patch/frame frontend.  Weights are drawn on
    ``device`` from a ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device="cuda"):
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"DecoderLM: family {cfg.family!r} is not ported yet "
                "(ROADMAP, next slices: MoE)"
            )
        self.cfg = cfg
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        self.embed = ParamTree(embed_init(cfg, gen))
        self.blocks = nn.ModuleList(
            DecoderBlock(cfg, gen) for _ in range(cfg.n_layers)
        )
        self.ln_out = ParamTree(norm_init(cfg, dev))

    @property
    def device(self) -> torch.device:
        return self.embed["table"].device

    def _embed_inputs(self, batch: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
        """tokens (+ optional frontend embeds) -> (x (B, S, D), positions)."""
        cfg = self.cfg
        x = embed_lookup(self.embed, batch["tokens"], cfg)
        if cfg.frontend is not None and "frontend_embeds" in batch:
            fe = batch["frontend_embeds"].to(x.dtype)  # (B, P, D)
            x = torch.cat([fe, x], dim=1)
        B, S, _ = x.shape
        positions = torch.arange(S, dtype=torch.int32, device=x.device)
        return x, positions.expand(B, S)

    def last_hidden(
        self, batch: Dict, kv: Optional[List] = None
    ) -> torch.Tensor:
        """The last position's hidden state after the final norm,
        (B, 1, D); appends each layer's (k, v) to ``kv`` when given."""
        x, positions = self._embed_inputs(batch)
        for block in self.blocks:
            x, k, v = block(x, positions)
            if kv is not None:
                kv.append((k, v))
        # the norm is per position: normalizing the last one alone equals
        # the reference's norm over all positions followed by the slice
        return norm_apply(self.ln_out, x[:, -1:], self.cfg.norm)

    @torch.inference_mode()
    def forward(self, batch: Dict) -> torch.Tensor:
        """Last-token logits (B, 1, vocab_padded) float32, no cache."""
        return logits_from_embedding(self.embed, self.last_hidden(batch),
                                     self.cfg)

    @torch.inference_mode()
    def prefill(
        self, batch: Dict, max_len: Optional[int] = None
    ) -> Tuple[torch.Tensor, Cache]:
        """Run the prompt: last-token logits and the filled cache — a
        :class:`~repro_torch.models.kvcache.SlidingKV` holding the last
        ``min(S, W)`` positions in slots ``position % W`` when the config
        has a sliding window ``W`` (``max_len`` is then not read), else a
        :class:`~repro_torch.models.kvcache.FullKV` of ``max(max_len, S)``
        positions."""
        cfg = self.cfg
        kv: List = []
        logits = logits_from_embedding(
            self.embed, self.last_hidden(batch, kv), cfg
        )
        B, S = kv[0][0].shape[:2]
        dev = self.device
        if cfg.sliding_window is not None:
            W = cfg.sliding_window
            cache = kvc.sliding_kv_init(cfg, B, W, dev)
            take = min(S, W)
            abs_pos = torch.arange(S - take, S, dtype=torch.int32, device=dev)
            slots = (abs_pos % W).long()
            for i, (k, v) in enumerate(kv):
                cache.k[i][:, slots] = k[:, S - take:]
                cache.v[i][:, slots] = v[:, S - take:]
            cache.k_pos[:, slots] = abs_pos
        else:
            # a frontend extends the sequence past the token count: the
            # cache holds all of it
            max_len = max(max_len or S, S)
            cache = kvc.full_kv_init(cfg, B, max_len, dev)
            for i, (k, v) in enumerate(kv):
                cache.k[i, :, :S] = k
                cache.v[i, :, :S] = v
        cache.pos.fill_(S)
        return logits, cache

    @torch.inference_mode()
    def decode_step(
        self, cache: Cache, tokens: torch.Tensor
    ) -> Tuple[torch.Tensor, Cache]:
        """One token for every sequence: ``tokens`` (B, 1) at positions
        ``cache.pos``.  Returns logits (B, 1, vocab_padded) float32 and the
        cache, updated in place: the step's keys and values written, ``pos``
        (and, for the ring, ``k_pos``) advanced, as the reference's
        ``decode_step`` returns them."""
        cfg = self.cfg
        x = embed_lookup(self.embed, tokens, cfg)
        B = tokens.shape[0]
        pos = cache.pos
        positions = pos[:, None]
        rows = torch.arange(B, device=pos.device)
        if isinstance(cache, kvc.SlidingKV):
            W = cache.window
            slot = (pos % W).long()
            # the ring's positions once this step is written: the same for
            # every layer
            kp = cache.k_pos.clone()
            kp[rows, slot] = pos
            valid = (kp >= 0) & (kp > positions - (cfg.sliding_window or W))
        else:
            kp = torch.arange(cache.max_len, dtype=torch.int32,
                              device=pos.device).expand(B, -1)
            valid = kp <= positions
        for i, block in enumerate(self.blocks):
            x = block.decode(x, positions, cache, i, kp, valid)
        x = norm_apply(self.ln_out, x, cfg.norm)
        logits = logits_from_embedding(self.embed, x, cfg)
        if isinstance(cache, kvc.SlidingKV):
            cache.k_pos = kp
        cache.pos = pos + 1
        return logits, cache
