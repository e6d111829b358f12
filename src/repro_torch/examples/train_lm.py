"""End-to-end LM training example (reduced scale), the twin of the
reference package's ``examples/train_lm.py``.

Exercises the port's train stack on one device:

  data pipeline -> build_train_step (microbatched grad accumulation)
  -> AdamW (fp32 master, cosine LR) -> manifest checkpoints
  -> simulated failure -> restore -> resume (fault tolerance).

A ~6M-parameter dense config, float32.  The restored state must equal the
state that was saved, bit for bit, and the loss must fall.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 40] [--device D]
"""

from __future__ import annotations

import argparse
import tempfile
import time
from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ckpt.manifest import CheckpointManager, flatten_tree
from repro_torch.launch.train import checkpoint_tree, restore_state
from repro_torch.models import build_model
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train.step import (
    TrainSettings,
    build_train_step,
    init_opt_state,
)


def small_config() -> ModelConfig:
    return ModelConfig(
        name="lm-small", family="dense",
        n_layers=4, d_model=256, n_heads=4, n_kv_heads=2, head_dim=64,
        d_ff=768, vocab=2048, mlp="swiglu", tie_embeddings=True,
        param_dtype="float32", compute_dtype="float32",
    )


def _batches(batch: int, seq: int, vocab: int, dev):
    from repro_torch.data.synthetic import lm_stream

    for b in lm_stream(np.random.default_rng(0), batch, seq, vocab):
        yield {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def main(steps: int = 40, batch: int = 8, seq: int = 128, ckpt_every: int = 10,
         device="cuda") -> Dict:
    dev = resolve_device(device)
    cfg = small_config()
    model = build_model(cfg, seed=0, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"model: {cfg.name} {n_params / 1e6:.1f}M params")

    settings = TrainSettings(
        num_microbatches=2, grad_dtype="float32",
        opt=AdamWConfig(lr_peak=1e-3, warmup_steps=20, decay_steps=steps),
    )
    step_fn = build_train_step(model, cfg, settings)
    opt = init_opt_state(model, settings)
    stream = _batches(batch, seq, cfg.vocab, dev)

    with tempfile.TemporaryDirectory() as ckdir:
        mgr = CheckpointManager(ckdir, keep=2)
        losses = []
        t0 = time.perf_counter()
        crash_at = steps // 2
        for step in range(crash_at):
            opt, metrics = step_fn(opt, next(stream))
            losses.append(float(metrics["loss"]))
            if step % ckpt_every == 0 or step == crash_at - 1:
                mgr.save(step, checkpoint_tree(model, opt), blocking=False)
            if step % 10 == 0:
                print(f"  step {step:4d} loss {losses[-1]:.4f}")
        mgr.wait()

        # ---- simulated host failure: drop all live state ----------------
        print(f"-- simulated failure at step {crash_at}; "
              f"restoring from checkpoint --")
        saved = [t.detach().clone()
                 for _, t in flatten_tree(checkpoint_tree(model, opt))]
        del model, opt, step_fn
        latest = mgr.latest_step()
        assert latest is not None
        model = build_model(cfg, seed=1, device=dev)  # other weights
        opt = restore_state(mgr, latest, model, dev)
        restored = [t for _, t in flatten_tree(checkpoint_tree(model, opt))]
        same = len(saved) == len(restored) and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(saved, restored))
        assert same, "the restored state must equal the saved one bit for bit"
        print(f"   restored step {latest}: {len(saved)} leaves bit for bit")
        step_fn = build_train_step(model, cfg, settings)

        for step in range(latest + 1, steps):
            opt, metrics = step_fn(opt, next(stream))
            losses.append(float(metrics["loss"]))
            if step % 10 == 0:
                print(f"  step {step:4d} loss {losses[-1]:.4f}")

        dt = time.perf_counter() - t0
        tok_s = steps * batch * seq / dt
        print(f"{steps} steps in {dt:.1f}s ({tok_s:.0f} tok/s incl. "
              f"restore)")
        first, last = np.mean(losses[:5]), np.mean(losses[-5:])
        print(f"loss: {first:.3f} -> {last:.3f}")
        assert last < first, "loss must decrease"
        print("train_lm OK")
    return {"losses": losses, "restored_step": latest, "leaves": len(saved),
            "restored_equal": same, "tok_s": tok_s}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args()
    main(a.steps, a.batch, a.seq, a.ckpt_every, device=a.device)
