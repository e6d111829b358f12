"""How far a model's bf16 training pass parts when its kernels (forward
and backward) are swapped for their plain versions (a measurement, not a
test: pytest does not collect this file).  ``--model seamless`` (the
default): flash attention (B6) against the plain ``gqa_attention`` on
seamless-m4t-medium; ``--model rwkv6``: the WKV6 scan (B7) against
autograd of ``wkv6_chunked`` on rwkv6-3b, its ``mu``, ``u`` and ``w0``
randomized from the seed + 10 as ``chip_smoke.py``'s checks do.  Card
only; full width and depth, weights drawn at each seed as
``chip_smoke.py`` draws them at its ``SEED``, on the batch its training
checks use (``launch.train``'s first batch, ``TRAIN_PLAIN_BATCH``
sequences)::

    PYTHONPATH=src python tests/train_bf16_gap.py --seeds 0 1 2 3 4
    PYTHONPATH=src python tests/train_bf16_gap.py --model rwkv6 --seeds 0 1 2 3 4

Prints one JSON line per seed -- the loss's |diff| and the largest
per-leaf gradient distances (``grad_rel``: ||g_kernel - g_plain|| over
||g_plain||; ``grad_max_rel``: max |g_kernel - g_plain| over the leaf's
largest |g_plain|) -- then one with the largest values, which
``chip_smoke.py``'s ``TRAIN_BF16_LOSS`` / ``TRAIN_BF16_GRAD`` (seamless)
and ``TRAIN_RWKV_BF16_LOSS`` / ``TRAIN_RWKV_BF16_GRAD`` (rwkv6) bound at
1.5 times.  ``--float32``: the float32 model at 1 + 1 layers (seamless)
or ``TRAIN_RWKV_F32_LAYERS`` layers (rwkv6), full width, which
``TRAIN_F32_REL`` / ``TRAIN_RWKV_F32_REL`` bound; ``loss_rel`` is the
loss's relative |diff| there.  ``--model rwkv6 --scans``: the same
distances between two plain versions, autograd of ``wkv6_chunked``
against autograd of the recurrence ``wkv6_ref`` (no kernel): how far
bf16 alone carries a float32 rounding difference in the scan.
``--model rwkv6 --steps N``: the per-step losses of ``chip_smoke.py``'s
``TRAIN_RWKV`` training run (full width and depth, bf16, 4 x 1,024 tokens
in 2 microbatches) cut to N steps, with B7's kernels or, with
``--plain``, autograd of ``wkv6_chunked`` in their place (no B7 launch).
The checkout on ``PYTHONPATH`` trains, so two commits compare on one card
by running once per tree; runs that differ only in how their float32 sums
are ordered give the same first loss and part afterwards, as far as bf16
training amplifies the difference::

    PYTHONPATH=src python tests/train_bf16_gap.py --model rwkv6 --steps 12 [--plain]
"""

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

from repro_torch.configs import rwkv6_3b, seamless_m4t_medium  # noqa: E402
from repro_torch.models import build_model  # noqa: E402


def scans_gap(model, batch):
    """``train_against_plain``'s distances between autograd of the two
    plain WKV6 scans, the chunked one as "kernel", the recurrence as
    "plain"."""
    from repro_torch.kernels.wkv6.ops import wkv6_chunked
    from repro_torch.kernels.wkv6.ref import wkv6_ref
    from repro_torch.models import rwkv6

    kernel_fn, runs = rwkv6.wkv6, []
    try:
        for fn in (wkv6_chunked, wkv6_ref):
            rwkv6.wkv6 = fn
            runs.append(cs.loss_and_grads(model, batch))
    finally:
        rwkv6.wkv6 = kernel_fn
    return cs.grad_gap(model, *runs[0], *runs[1])


def train_losses(steps, plain):
    """The per-step losses of ``launch.train`` run with ``cs.TRAIN_RWKV``
    cut to ``steps``; ``plain``: ``wkv6_chunked`` in B7's place."""
    from repro_torch.kernels.wkv6.ops import wkv6_chunked
    from repro_torch.launch import train
    from repro_torch.models import rwkv6

    argv = list(cs.TRAIN_RWKV)
    argv[argv.index("--steps") + 1] = str(steps)
    kernel_fn = rwkv6.wkv6
    if plain:
        rwkv6.wkv6 = wkv6_chunked
    try:
        out = train.main(argv + ["--device", "cuda"])
    finally:
        rwkv6.wkv6 = kernel_fn
    return [float(x) for x in out["losses"]]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("seamless", "rwkv6"),
                    default="seamless")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--float32", action="store_true")
    ap.add_argument("--scans", action="store_true",
                    help="rwkv6: wkv6_chunked against wkv6_ref, no kernel")
    ap.add_argument("--steps", type=int, default=0,
                    help="rwkv6: the training run's losses over N steps")
    ap.add_argument("--plain", action="store_true",
                    help="with --steps: wkv6_chunked in B7's place")
    args = ap.parse_args(argv)
    if args.steps:
        if args.model != "rwkv6":
            ap.error("--steps trains rwkv6-3b: give --model rwkv6")
        print(json.dumps({"plain": args.plain,
                          "losses": train_losses(args.steps, args.plain)}),
              flush=True)
        return
    f32 = dict(param_dtype="float32", compute_dtype="float32")
    if args.model == "seamless":
        cfg = seamless_m4t_medium.config()
        if args.float32:
            cfg = cfg.replace(n_layers=1, n_encoder_layers=1, **f32)
        batch = cs._plain_batch(cfg, cs.TRAIN_PLAIN_BATCH)
        plain = cs.b6_plain()
    else:
        cfg = rwkv6_3b.config()
        if args.float32:
            cfg = cfg.replace(n_layers=cs.TRAIN_RWKV_F32_LAYERS, **f32)
        batch = cs._plain_batch(cfg, cs.TRAIN_PLAIN_BATCH, cs.TRAIN_RWKV)
        plain = cs.b7_plain()
    worst = {"loss_diff": 0.0, "loss_rel": 0.0, "grad_rel": 0.0,
             "grad_max_rel": 0.0}
    for seed in args.seeds:
        model = build_model(cfg, seed=seed, device="cuda")
        if args.model == "rwkv6":
            cs.randomize_rwkv6(model, seed + 10)
        r = (scans_gap(model, batch) if args.scans
             else cs.train_against_plain(model, batch, plain))
        r["loss_rel"] = r["loss_diff"] / abs(r["loss_plain"])
        r["seed"] = seed
        print(json.dumps(r), flush=True)
        for k in worst:
            worst[k] = max(worst[k], r[k])
        del model
        torch.cuda.empty_cache()
    print(json.dumps({"largest": worst, "model": args.model,
                      "seeds": args.seeds, "float32": args.float32,
                      "scans": args.scans}),
          flush=True)


if __name__ == "__main__":
    main()
