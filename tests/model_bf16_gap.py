"""How far two deep bf16 models part when flash attention (B6) is swapped
for its plain version (a measurement, not a test: pytest does not collect
this file).  Card only; the port at full width and depth with its own
seeded weights and prompts, drawn at each seed as ``chip_smoke.py`` draws
them at its ``SEED``::

    PYTHONPATH=src python tests/model_bf16_gap.py --model recurrentgemma \
        --seeds 0 1 2 3 4
    PYTHONPATH=src python tests/model_bf16_gap.py --model moonshot \
        --seeds 0 1 2 3 4 [--layers 1 2 4 8]

``recurrentgemma`` (recurrentgemma-9b, 2 prompts of 4,096 tokens): the
kernel run against the plain-attention run in bf16 steps (2^-8) of the
largest logit, each run's max |diff| from the float32 run of the same
weights, and their ratio, which ``chip_smoke.py``'s ``GRIFFIN_F32_RATIO``
bounds.

``moonshot`` (moonshot-v1-16b-a3b, 2 prompts of 2,048 tokens): every
top-k decision that differs between the two runs at a position still
routed alike, with its router inputs' max |dx| in bf16 steps of that
token's largest |x| (``MOE_X_STEPS`` bounds it) and both margins; then,
with the kernel run's routing replayed in the plain run, the logits' and
the cache's distance in bf16 steps.  ``--layers`` cuts the depth (full
width), one run per depth and seed.

Prints one JSON line per seed, then one with the largest values.
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke as cs  # noqa: E402

from repro_torch.configs import moonshot_v1_16b_a3b, recurrentgemma_9b  # noqa: E402
from repro_torch.models import build_model  # noqa: E402


def _prompts(seed, offset, cfg, batch, length):
    """``chip_smoke.py``'s draw at ``SEED = seed``: (batch, length), the
    first ``NEMO_PLAIN_BATCH`` compared."""
    gen = torch.Generator(device="cuda").manual_seed(seed + offset)
    tokens = torch.randint(0, cfg.vocab, (batch, length), generator=gen,
                           device="cuda", dtype=torch.int32)
    return tokens[:cs.NEMO_PLAIN_BATCH]


def recurrentgemma(seed, layers=None):
    cfg = recurrentgemma_9b.config()
    model = build_model(cfg, seed=seed, device="cuda")
    prompts = _prompts(seed, 15, cfg, cs.GRIFFIN_BATCH, cs.GRIFFIN_PROMPT)
    out = cs.bf16_against_float32(model, {"tokens": prompts})
    del model
    torch.cuda.empty_cache()
    return out


def moonshot(seed, layers=None):
    cfg = moonshot_v1_16b_a3b.config()
    if layers is not None:
        cfg = cfg.replace(n_layers=layers)
    model = build_model(cfg, seed=seed, device="cuda")
    prompts = _prompts(seed, 13, cfg, cs.MOE_BATCH, cs.MOE_PROMPT)
    r = cs.moe_against_plain(model, prompts)
    del model
    torch.cuda.empty_cache()
    steps = np.array([f["dx_steps"] for f in r["flips"]])
    margins = np.array([max(f["margins"]) for f in r["flips"]])
    by_layer = {}
    for f in r["flips"]:
        by_layer[f["layer"]] = max(by_layer.get(f["layer"], 0.0), f["dx_steps"])
    return dict(
        layers=cfg.n_layers, flips=len(r["flips"]), first=r["first"],
        dx_steps_by_layer={str(k): v for k, v in sorted(by_layer.items())},
        dx_steps_max=float(steps.max()) if len(steps) else 0.0,
        dx_steps_p50=float(np.median(steps)) if len(steps) else 0.0,
        margin_max=float(margins.max()) if len(margins) else 0.0,
        replay_logits_steps=r["logits"][1], replay_k_steps=r["k"][1],
        replay_v_steps=r["v"][1])


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("recurrentgemma", "moonshot"),
                    required=True)
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--layers", type=int, nargs="+", default=[None],
                    help="moonshot only: depths to cut to (default full)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("model_bf16_gap.py: needs a CUDA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {cs._card_line()}", flush=True)
    fn = recurrentgemma if args.model == "recurrentgemma" else moonshot
    if args.model == "recurrentgemma" and args.layers != [None]:
        ap.error("--layers is for moonshot")
    for layers in args.layers:
        rows = []
        for seed in args.seeds:
            row = dict(model=args.model, seed=seed, **fn(seed, layers))
            rows.append(row)
            print(json.dumps(row), flush=True)
        numeric = [k for k, v in rows[0].items() if isinstance(v, float)]
        print(json.dumps({"model": args.model, "layers": layers,
                          "seeds": args.seeds,
                          **{f"largest_{k}": max(r[k] for r in rows)
                             for k in numeric}}), flush=True)


if __name__ == "__main__":
    main()
