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
on its own — and ``prefill`` builds the :class:`~repro_torch.models.
kvcache.FullKV` cache on top of the same pass.

Not ported yet (each raises ``NotImplementedError``): the ``moe`` family,
sliding-window attention with its ring cache, ``decode_step`` and the
training loss.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import kvcache as kvc
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    attention_qkv,
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
        o = gqa_attention(q, k, v, positions, positions, causal=True,
                          window=cfg.sliding_window)
        B, S, H, hd = o.shape
        x = x + (o.reshape(B, S, H * hd) @ self.attn["wo"]).to(x.dtype)
        h = norm_apply(self.ln_mlp, x, cfg.norm)
        x = x + mlp_apply(self.mlp, h, cfg).to(x.dtype)
        return x, k, v


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
        if cfg.sliding_window is not None:
            raise NotImplementedError(
                "DecoderLM: sliding-window attention and its ring cache are "
                "not ported yet (ROADMAP, next slices: LM decode)"
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

    def forward(self, batch: Dict) -> torch.Tensor:
        """Last-token logits (B, 1, vocab_padded) float32, no cache."""
        return logits_from_embedding(self.embed, self.last_hidden(batch),
                                     self.cfg)

    def prefill(
        self, batch: Dict, max_len: Optional[int] = None
    ) -> Tuple[torch.Tensor, kvc.FullKV]:
        """Run the prompt: last-token logits and the filled cache."""
        cfg = self.cfg
        kv: List = []
        logits = logits_from_embedding(
            self.embed, self.last_hidden(batch, kv), cfg
        )
        B, S = kv[0][0].shape[:2]
        # a frontend extends the sequence past the token count: the cache
        # holds all of it
        max_len = max(max_len or S, S)
        cache = kvc.full_kv_init(cfg, B, max_len, self.device)
        for i, (k, v) in enumerate(kv):
            cache.k[i, :, :S] = k
            cache.v[i, :, :S] = v
        cache.pos.fill_(S)
        return logits, cache

    def decode_step(self, cache, tokens: torch.Tensor):
        raise NotImplementedError(
            "DecoderLM.decode_step is not ported yet (ROADMAP, next slices: "
            "LM decode)"
        )
