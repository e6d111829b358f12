"""How far the port's bf16 RecurrentGemma parts from the JAX package's, run
jitted and op by op (a measurement, not a test: pytest does not collect
this file).  CPU, the smoke config of ``tests/test_torch_griffin.py``
(a 40-token prompt, then 3 decode steps), one model per seed::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/griffin_bf16_gap.py \
        --seeds 0 1 2 3 4 5 6

For each seed and step (prefill, decode 0-2): the largest gap, in bf16
steps (2^-8) of the reference's largest value, over the logits and every
float leaf of the state, between JAX under ``jax.jit`` and JAX op by op
(``jax.disable_jit()``), the port and jitted JAX, and the port and
op-by-op JAX.  First, how many of 65,536 bf16 inputs the reference's
``jax.nn.gelu(approximate=True)`` rounds otherwise than ``F.gelu`` and
than ``layers.gelu_tanh``.  Prints one JSON line each.
"""

import argparse
import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_griffin import _models, _np  # noqa: E402

from repro_torch.models import layers  # noqa: E402


def gelu_mismatches():
    x = np.random.default_rng(0).normal(size=1 << 16).astype(np.float32) * 3
    jx = jnp.asarray(x, jnp.bfloat16)
    want = _np(jax.jit(lambda a: jax.nn.gelu(a, approximate=True))(jx))
    tx = torch.tensor(_np(jx)).to(torch.bfloat16)
    return {"F.gelu": int((_np(F.gelu(tx, approximate="tanh")) != want).sum()),
            "gelu_tanh": int((_np(layers.gelu_tanh(tx)) != want).sum()),
            "of": int(x.size)}


def steps(got, want):
    got, want = _np(got), _np(want)
    return float(np.abs(got - want).max() / (2.0 ** -8 * np.abs(want).max()))


def worst(lg, st, jlg, jst):
    """(steps, leaf) of the largest gap over the logits and the state."""
    out = [(steps(lg, jlg), "logits")]
    out += [(steps(st[n], w), n) for n, w in jst.items()
            if n not in ("k_pos", "pos")]
    return max(out)


def gaps(seed):
    jm, params, model, cfg = _models(
        dict(param_dtype="bfloat16", compute_dtype="bfloat16"), seed=seed)
    rng = np.random.default_rng(41 + seed)
    prompt = rng.integers(0, cfg.vocab, (2, 40)).astype(np.int32)
    toks = rng.integers(0, cfg.vocab, (3, 2, 1)).astype(np.int32)
    jl, js = jm.prefill(params, {"tokens": jnp.asarray(prompt)})
    with jax.disable_jit():
        el, es = jm.model.prefill(params, {"tokens": jnp.asarray(prompt)})
    lg, st = model.prefill({"tokens": torch.from_numpy(prompt)})
    rows = []
    for t in range(4):
        if t:
            tok = jnp.asarray(toks[t - 1])
            jl, js = jm.decode_step(params, js, tok)
            with jax.disable_jit():
                el, es = jm.model.decode_step(params, es, tok)
            lg, st = model.decode_step(st, torch.from_numpy(toks[t - 1]))
        rows.append({"seed": seed, "step": "prefill" if not t else f"decode {t - 1}",
                     "jit_vs_op_by_op": worst(el, es, jl, js),
                     "port_vs_jit": worst(lg, st, jl, js),
                     "port_vs_op_by_op": worst(lg, st, el, es)})
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    args = ap.parse_args(argv)
    print(json.dumps({"gelu_mismatches": gelu_mismatches()}), flush=True)
    largest = {}
    for seed in args.seeds:
        for row in gaps(seed):
            print(json.dumps(row), flush=True)
            for k, v in row.items():
                if isinstance(v, tuple):
                    largest[k] = max(largest.get(k, v), v)
    print(json.dumps({"seeds": args.seeds, "largest": largest}), flush=True)


if __name__ == "__main__":
    main()
