"""Decoder-only transformer LM, dense and MoE families.

The reference package's ``repro.models.transformer.DecoderLM`` as an
``nn.Module`` that holds its weights: one :class:`DecoderBlock` per layer,
run in a Python loop (the reference's layer scan and rematerialization
exist for compile size and gradients, neither of which applies here).
Parameters keep the reference's names and layouts, so
:func:`repro_torch.convert.decoder_from_numpy` can carry a JAX parameter
tree across.  In the ``moe`` family a block holds ``moe``
(:mod:`repro_torch.models.moe`) where the dense one holds ``mlp``; its
auxiliary losses are dropped by ``prefill`` and ``decode_step``, as the
reference's are.

:meth:`DecoderLM.prefill` is split in two: :meth:`DecoderLM.forward`
returns the last token's logits and builds no cache — the scoring path
calls only this, where the reference's ``jax.jit`` drops the unread cache
on its own — and ``prefill`` builds the cache on top of the same pass:
:class:`~repro_torch.models.kvcache.FullKV`, or the
:class:`~repro_torch.models.kvcache.SlidingKV` ring when the config has a
sliding window.  Both passes run each block's self-attention through
:func:`~repro_torch.models.layers.self_attention` (kernel B6 on the card),
and ``prefill`` writes each layer's keys and values into the cache as the
pass goes.  :meth:`DecoderLM.decode_step` feeds one token per sequence against
either cache, through :func:`~repro_torch.models.layers.gqa_attention`
(the reference computes it outside any Pallas kernel too), and updates
the cache in place.  All three run under ``torch.inference_mode()``: the
parameters build no autograd graph.

:meth:`DecoderLM.loss` is the training loss (the reference's
``DecoderLM.loss``): every block rematerialized with
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint`` with
``nothing_saveable``: a block's activations are recomputed in the
backward pass, so B6's forward runs twice a block and its backward once),
a frontend's positions labelled -1, and in the ``moe`` family
``0.01·lb + 1e-3·z`` of the layers' mean auxiliary losses added.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

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
from repro_torch.models.moe import moe_apply, moe_init

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
    """Pre-norm attention + FFN block (``ln_attn``, ``attn``, ``ln_mlp``,
    and ``mlp`` or, in the ``moe`` family, ``moe``, as in the reference's
    per-layer parameter tree)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        dev = generator.device
        self.ln_attn = ParamTree(norm_init(cfg, dev))
        self.attn = ParamTree(attention_init(cfg, generator))
        self.ln_mlp = ParamTree(norm_init(cfg, dev))
        if cfg.family == "moe":
            self.moe = ParamTree(moe_init(cfg, generator))
        else:
            self.mlp = ParamTree(mlp_init(cfg, generator))

    def forward(
        self, x: torch.Tensor, positions: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(x_out, k, v) for a causal pass over the whole sequence."""
        cfg = self.cfg
        h = norm_apply(self.ln_attn, x, cfg.norm)
        q, k, v = attention_qkv(self.attn, h, positions, cfg)
        o = layers.self_attention(q, k, v, positions, window=cfg.sliding_window)
        return self._finish(x, o)[0], k, v

    def train_forward(
        self, x: torch.Tensor, positions: torch.Tensor
    ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(x_out, aux) for the training pass: the MoE auxiliary losses
        (empty for a dense block)."""
        cfg = self.cfg
        h = norm_apply(self.ln_attn, x, cfg.norm)
        q, k, v = attention_qkv(self.attn, h, positions, cfg)
        o = layers.self_attention(q, k, v, positions, window=cfg.sliding_window)
        return self._finish(x, o)

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
        return self._finish(x, o)[0]

    def _finish(self, x: torch.Tensor, o: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The output projection and the FFN (the MLP, or the experts),
        each added to the residual; with the experts' auxiliary losses
        (the serving passes drop them)."""
        cfg = self.cfg
        B, S, H, hd = o.shape
        x = x + (o.reshape(B, S, H * hd) @ self.attn["wo"]).to(x.dtype)
        h = norm_apply(self.ln_mlp, x, cfg.norm)
        aux = {}
        if cfg.family == "moe":
            f, aux = moe_apply(self.moe, h, cfg)
        else:
            f = mlp_apply(self.mlp, h, cfg)
        return x + f.to(x.dtype), aux


class DecoderLM(nn.Module):
    """Dense or MoE decoder LM with a patch/frame frontend.  Weights are
    drawn on ``device`` from a ``torch.Generator`` seeded with ``seed``."""

    def __init__(self, cfg: ModelConfig, *, seed: int = 0, device="cuda"):
        super().__init__()
        if cfg.family not in ("dense", "moe"):
            raise ValueError(f"DecoderLM: family {cfg.family!r} is not a "
                             "decoder's (dense or moe)")
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

    def _layers(self, x: torch.Tensor, positions: torch.Tensor,
                store=None) -> torch.Tensor:
        """Every block over ``x``; ``store(i, k, v)`` takes each layer's
        keys and values when given.  The last position's hidden state
        after the final norm, (B, 1, D)."""
        for i, block in enumerate(self.blocks):
            x, k, v = block(x, positions)
            if store is not None:
                store(i, k, v)
        # the norm is per position: normalizing the last one alone equals
        # the reference's norm over all positions followed by the slice
        return norm_apply(self.ln_out, x[:, -1:], self.cfg.norm)

    def loss(self, batch: Dict) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss of ``batch`` (``tokens``, ``labels`` (B, S),
        optional ``frontend_embeds``) and its metrics: ``nll``, ``tokens``
        and, in the ``moe`` family, ``moe_lb_loss``, ``moe_z_loss`` and
        ``moe_dropped_frac`` averaged over the layers.  Runs outside
        inference mode, each block rematerialized."""
        cfg = self.cfg
        x, positions = self._embed_inputs(batch)
        aux_sum: Dict[str, torch.Tensor] = {}
        for block in self.blocks:
            x, aux = checkpoint(block.train_forward, x, positions,
                                use_reentrant=False)
            for name, val in aux.items():
                aux_sum[name] = aux_sum[name] + val if name in aux_sum else val
        x = norm_apply(self.ln_out, x, cfg.norm)
        logits = logits_from_embedding(self.embed, x, cfg)
        labels = batch["labels"]
        if cfg.frontend is not None and "frontend_embeds" in batch:
            P = batch["frontend_embeds"].shape[1]
            pad = labels.new_full((labels.shape[0], P), -1)
            labels = torch.cat([pad, labels], dim=1)
        loss, metrics = cross_entropy_loss(logits, labels)
        if cfg.family == "moe":
            L = cfg.n_layers
            lb = aux_sum["moe_lb_loss"] / L
            zl = aux_sum["moe_z_loss"] / L
            loss = loss + 0.01 * lb + 1e-3 * zl
            metrics.update(moe_lb_loss=lb, moe_z_loss=zl,
                           moe_dropped_frac=aux_sum["moe_dropped_frac"] / L)
        return loss, metrics

    def last_hidden(self, batch: Dict) -> torch.Tensor:
        """The last position's hidden state after the final norm,
        (B, 1, D)."""
        return self._layers(*self._embed_inputs(batch))

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
        positions.  The cache is allocated first and each layer's keys
        and values are written into it as the pass reaches them."""
        cfg = self.cfg
        x, positions = self._embed_inputs(batch)
        B, S = x.shape[:2]
        dev = self.device
        if cfg.sliding_window is not None:
            W = cfg.sliding_window
            cache = kvc.sliding_kv_init(cfg, B, W, dev)
            take = min(S, W)
            abs_pos = torch.arange(S - take, S, dtype=torch.int32, device=dev)
            slots = (abs_pos % W).long()

            def store(i, k, v):
                cache.k[i][:, slots] = k[:, S - take:]
                cache.v[i][:, slots] = v[:, S - take:]

            cache.k_pos[:, slots] = abs_pos
        else:
            # a frontend extends the sequence past the token count: the
            # cache holds all of it
            cache = kvc.full_kv_init(cfg, B, max(max_len or S, S), dev)

            def store(i, k, v):
                cache.k[i, :, :S] = k
                cache.v[i, :, :S] = v

        logits = logits_from_embedding(
            self.embed, self._layers(x, positions, store), cfg)
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
