"""Training launcher: the twin of the reference package's
``python -m repro.launch.train`` in live mode::

    python -m repro_torch.launch.train --arch seamless-m4t-medium \\
        --batch 8 --seq 1024 --microbatches 4 --steps 20
    python -m repro_torch.launch.train --arch featinsight-fraud --smoke \\
        --steps 20 --ckpt-dir CKPT --restore --device cpu

The reference's flags and settings: ``--smoke`` takes the reduced config
and float32 gradient accumulation (bfloat16 otherwise), warmup
``min(20, steps)``, decay over ``steps``; ``lm_stream`` (seed 0) supplies
tokens and labels, frames or frontend patches come from
``default_rng(1)``; a checkpoint (the reference's tree layout,
``{"params", "opt"}``) every ``--ckpt-every`` steps without blocking and
one at the end; ``--restore`` resumes from the latest.  Plus
``--device`` (default ``cuda``).  ``--dry-run`` / ``--multi-pod`` read
XLA's compile of the full config on a TPU mesh and have no counterpart on
one card: they exit non-zero saying so.

Prints a step line every 5 steps and, at the end, tokens/s and the peak
device memory.  ``main(argv)`` returns the run's numbers: per-step loss,
wall time and kernel launches (B6's forward and backward), tokens/s, the
peak memory, and the live model, optimizer state, step function and
batch stream (to run one more step, traced).
"""

from __future__ import annotations

import argparse
import time
from typing import Dict, Iterator, Optional, Sequence

import numpy as np
import torch


def _stream(cfg, batch: int, seq: int, dev) -> Iterator[Dict[str, torch.Tensor]]:
    from repro_torch.data.synthetic import lm_stream

    base = lm_stream(np.random.default_rng(0), batch, seq, cfg.vocab)
    frng = np.random.default_rng(1)
    for b in base:
        if cfg.family == "encdec":
            b["frames"] = frng.normal(
                size=(batch, seq, cfg.d_model)).astype(np.float32)
        elif cfg.frontend is not None:
            b["frontend_embeds"] = frng.normal(
                size=(batch, cfg.frontend_len, cfg.d_model)).astype(np.float32)
        yield {k: torch.from_numpy(v).to(dev) for k, v in b.items()}


def checkpoint_tree(model, opt: Dict) -> Dict:
    """``{"params": ..., "opt": {master, m, v, step}}`` in the reference's
    tree layout (tensors)."""
    from repro_torch.convert import reference_tree

    return {"params": reference_tree(model),
            "opt": {**{k: reference_tree(model, opt[k])
                       for k in ("master", "m", "v")},
                    "step": opt["step"]}}


def restore_state(mgr, step: int, model, device) -> Dict:
    """Load checkpoint ``step`` into ``model``; returns AdamW's state."""
    from repro_torch.convert import (
        adamw_state_from_numpy,
        load_reference_tree,
        tree_to_numpy,
    )
    from repro_torch.optim.adamw import adamw_init

    like = checkpoint_tree(model, adamw_init(dict(model.named_parameters())))
    restored = mgr.restore(step, like=like)
    load_reference_tree(model, restored["params"])
    return adamw_state_from_numpy(model, tree_to_numpy(restored["opt"]),
                                  device=device)


def main(argv: Optional[Sequence[str]] = None) -> Dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--dry-run", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--restore", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default), or cpu to run the plain versions")
    args = ap.parse_args(argv)

    if args.dry_run or args.multi_pod:
        raise SystemExit(
            "launch.train: --dry-run / --multi-pod lower and compile the full "
            "config with XLA on a TPU mesh (the reference's "
            "repro.launch.dryrun); one GPU has no such mesh and this port "
            "has no counterpart -- run live steps instead")

    from repro_torch import kernels, resolve_device
    from repro_torch.ckpt.manifest import CheckpointManager
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.step import (
        TrainSettings,
        build_train_step,
        init_opt_state,
    )

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, seed=0, device=dev)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"[train] arch={cfg.name} family={cfg.family} device={dev} "
          f"params={n_params}", flush=True)
    settings = TrainSettings(
        num_microbatches=args.microbatches,
        grad_dtype="float32" if args.smoke else "bfloat16",
        opt=AdamWConfig(warmup_steps=min(20, args.steps),
                        decay_steps=args.steps),
    )
    step_fn = build_train_step(model, cfg, settings)
    opt = init_opt_state(model, settings)
    start = 0
    mgr = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    if mgr and args.restore and (latest := mgr.latest_step()) is not None:
        opt = restore_state(mgr, latest, model, dev)
        start = latest + 1
        print(f"[train] restored checkpoint step {latest}", flush=True)

    stream = _stream(cfg, args.batch, args.seq, dev)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    losses, times, launches = [], [], []
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        ts = time.perf_counter()
        batch = next(stream)
        before = dict(kernels.LAUNCHES)
        opt, metrics = step_fn(opt, batch)
        loss = float(metrics["loss"])  # waits for the step
        times.append(time.perf_counter() - ts)
        losses.append(loss)
        launches.append({k: kernels.LAUNCHES[k] - before[k]
                         for k in kernels.LAUNCHES
                         if kernels.LAUNCHES[k] != before[k]})
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step, checkpoint_tree(model, opt), blocking=False)
        if step % 5 == 0 or step == args.steps - 1:
            print(f"[train] step {step:5d} loss {loss:.4f} "
                  f"({times[-1] * 1e3:.0f} ms)", flush=True)
    if mgr:
        # the reference saves the last step a second time, racing its own
        # background write of the same directory when steps is a multiple
        # of ckpt_every: join it first, save only what is not saved yet
        mgr.wait()
        if args.steps > start and args.steps % args.ckpt_every:
            mgr.save(args.steps - 1, checkpoint_tree(model, opt),
                     blocking=True)
    dt = time.perf_counter() - t0
    tok = (args.steps - start) * args.batch * args.seq
    peak = torch.cuda.max_memory_allocated(dev) if cuda else None
    mem = (f"peak device memory {peak / 1e9:.2f} GB" if cuda
           else "peak device memory not measured (CPU)")
    print(f"[train] {args.steps - start} steps in {dt:.1f}s "
          f"({tok / max(dt, 1e-9):.0f} tok/s), {mem}", flush=True)
    return {"cfg": cfg, "losses": losses, "step_s": times,
            "launches": launches, "tok_s": tok / max(dt, 1e-9),
            "peak_bytes": peak, "n_params": n_params, "model": model,
            "opt": opt, "step_fn": step_fn, "stream": stream,
            "settings": settings}


if __name__ == "__main__":
    main()
