"""How far seamless-m4t-medium's bf16 training pass parts when flash
attention (B6, forward and backward kernels) is swapped for the plain
``gqa_attention`` (a measurement, not a test: pytest does not collect this
file).  Card only; full width and depth, weights drawn at each seed as
``chip_smoke.py`` draws them at its ``SEED``, on the batch its training
checks use (``launch.train``'s first batch, ``TRAIN_PLAIN_BATCH``
sequences)::

    PYTHONPATH=src python tests/train_bf16_gap.py --seeds 0 1 2 3 4

Prints one JSON line per seed -- the loss's |diff| and the largest
per-leaf gradient distances (``grad_rel``: ||g_kernel - g_plain|| over
||g_plain||; ``grad_max_rel``: max |g_kernel - g_plain| over the leaf's
largest |g_plain|) -- then one with the largest values, which
``chip_smoke.py``'s ``TRAIN_BF16_LOSS`` / ``TRAIN_BF16_GRAD`` bound at
1.5 times.  ``--float32``: the float32 model at 1 + 1 layers (full
width), which ``TRAIN_F32_REL`` bounds.
"""

import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

from repro_torch.configs import seamless_m4t_medium  # noqa: E402
from repro_torch.models import build_model  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--float32", action="store_true")
    args = ap.parse_args(argv)
    cfg = seamless_m4t_medium.config()
    if args.float32:
        cfg = cfg.replace(n_layers=1, n_encoder_layers=1,
                          param_dtype="float32", compute_dtype="float32")
    batch = cs._plain_batch(cfg, cs.TRAIN_PLAIN_BATCH)
    worst = {"loss_diff": 0.0, "grad_rel": 0.0, "grad_max_rel": 0.0}
    for seed in args.seeds:
        model = build_model(cfg, seed=seed, device="cuda")
        r = cs.train_against_plain(model, batch)
        r["seed"] = seed
        print(json.dumps(r), flush=True)
        for k in worst:
            worst[k] = max(worst[k], r[k])
        del model
        torch.cuda.empty_cache()
    print(json.dumps({"largest": worst, "seeds": args.seeds,
                      "float32": args.float32}), flush=True)


if __name__ == "__main__":
    main()
