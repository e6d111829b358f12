"""How far rwkv6-3b's decode drifts from a prefill over the longer prompt
(a measurement, not a test: pytest does not collect this file).

On the CPU, the JAX package against the port on the same weights::

    PYTHONPATH=src JAX_PLATFORMS=cpu python tests/rwkv6_bf16_gap.py \
        --layers 16 --prompt 256 --batch 4

On the card (no JAX needed), the port with its own seeded weights, then
the same weights on the host's CPU::

    PYTHONPATH=src python tests/rwkv6_bf16_gap.py --device cuda

Full width (d_model 2560, 40 heads of 64, d_ff 8960, vocab 65536), the
depth, batch and dtype given (default bf16 weights and compute).  The
prompts are prefilled, then 8 tokens are decoded one at a time; decode
after 1 and 8 steps is compared with a prefill over the prompt plus those
tokens.  A sequence's gap is max |diff| of its last position's logits in
bf16 steps (2^-8) of its prefill's largest |logit|; each sequence's is
reported, and the largest.  After 1 step the port's per-layer states
(``att_shift``, ``cm_shift``, ``wkv``) are compared the same way, to show
where the two runs part.  Prints one JSON line per model.  On the CPU at
16 layers it holds about 9 GB.

With ``--scans SEED ...`` (card only) it measures instead how far the
bf16 model parts three correct float32 WKV6 scans -- the kernel, the
chunked plain version and the recurrence, each swapped in for one
prefill -- on the weights and prompts of each seed (drawn as
``chip_smoke.py`` draws them at its ``SEED``); ``chip_smoke.py``'s
``RWKV_SCAN_STEPS`` comes from it::

    PYTHONPATH=src python tests/rwkv6_bf16_gap.py --device cuda \
        --layers 32 --prompt 1024 --batch 8 --scans 0 1 2 3 4 5 6 7 8 9
"""

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.models import build_model

STEPS = (1, 8)
VOCAB = 65536


def bf16_steps(got, want) -> list:
    """Per leading index (sequence, or layer): max |got - want| in bf16
    steps of max |want|."""
    got = np.asarray(got, np.float32).reshape(len(got), -1)
    want = np.asarray(want, np.float32).reshape(len(want), -1)
    return (np.abs(got - want).max(-1)
            / (2.0 ** -8 * np.abs(want).max(-1))).tolist()


def gaps(prefill, decode_step, seq, prompt):
    """{steps: per-sequence gaps} for one model (``prefill(tokens)`` and
    ``decode_step(state, token)`` return (last-position logits, state)),
    and the states after one step of decode and of the longer prefill."""
    _, state = prefill(seq[:, :prompt])
    decoded, states = [], []
    for i in range(max(STEPS)):
        logits, state = decode_step(state, seq[:, prompt + i:prompt + i + 1])
        decoded.append(logits)
        states.append(state)
    out, longer = {}, {}
    for s in STEPS:
        logits, longer[s] = prefill(seq[:, :prompt + s])
        out[s] = bf16_steps(decoded[s - 1], logits)
    return out, states[0], longer[1]


def port_runner(model, device):
    def prefill(tokens):
        logits, state = model.prefill(
            {"tokens": torch.from_numpy(tokens).to(device)})
        return logits[:, -1].float().cpu().numpy(), state

    def decode(state, tok):
        logits, state = model.decode_step(state,
                                          torch.from_numpy(tok).to(device))
        return logits[:, -1].float().cpu().numpy(), state

    return prefill, decode


def port_record(model, device, seq, prompt):
    """The port's gaps, and its per-layer state gaps after one step."""
    with torch.inference_mode():
        out, dec, pre = gaps(*port_runner(model, device), seq, prompt)
    layers = {name: [round(g, 3) for g in
                     bf16_steps(dec[name].float().cpu(),
                                pre[name].float().cpu())]
              for name in ("att_shift", "cm_shift", "wkv")}
    return out, layers


def whole_steps(got, want) -> float:
    """max |got - want| over the whole array, in bf16 steps of max |want|
    (as ``chip_smoke.py``'s checks count them)."""
    got, want = got.float(), want.float()
    return float((got - want).abs().max()) / (
        2.0 ** -8 * float(want.abs().max()))


def scan_spread(cfg, seeds, batch, prompt) -> None:
    """Per seed, one JSON line: the pairwise gaps of the prefill logits and
    final ``wkv`` states of the runs with each WKV6 scan swapped in."""
    from repro_torch.kernels.wkv6.ops import wkv6, wkv6_chunked
    from repro_torch.kernels.wkv6.ref import wkv6_ref
    from repro_torch.models import rwkv6 as rwkv_mod

    scans = {"kernel": wkv6, "chunked": wkv6_chunked,
             "recurrence": wkv6_ref}
    pairs = (("kernel", "chunked"), ("recurrence", "chunked"),
             ("kernel", "recurrence"))
    for seed in seeds:
        t0 = time.perf_counter()
        model = build_model(cfg, seed=seed, device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(seed + 8)
        prompts = torch.randint(0, cfg.vocab, (batch, prompt), generator=gen,
                                device="cuda", dtype=torch.int32)
        outs = {}
        try:
            with torch.inference_mode():
                for name, scan in scans.items():
                    rwkv_mod.wkv6 = scan
                    logits, state = model.prefill({"tokens": prompts})
                    outs[name] = (logits, state["wkv"])
        finally:
            rwkv_mod.wkv6 = wkv6
        rec = {"seed": seed, "layers": cfg.n_layers, "batch": batch,
               "prompt": prompt}
        for i, what in enumerate(("logits", "wkv")):
            for a, b in pairs:
                rec[f"{what}: {a} vs {b}"] = whole_steps(outs[a][i],
                                                         outs[b][i])
        rec["seconds"] = round(time.perf_counter() - t0, 1)
        print(json.dumps(rec), flush=True)
        del model, outs
        torch.cuda.empty_cache()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layers", type=int, default=16)
    ap.add_argument("--prompt", type=int, default=256)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--device", default="cpu", choices=("cpu", "cuda"))
    ap.add_argument("--scans", type=int, nargs="*", default=None,
                    metavar="SEED")
    args = ap.parse_args()
    kw = dict(n_layers=args.layers, param_dtype=args.dtype,
              compute_dtype=args.dtype)
    cfg = registry.get_config("rwkv6-3b").replace(**kw)
    seq = np.random.default_rng(args.seed).integers(
        0, VOCAB, (args.batch, args.prompt + max(STEPS))).astype(np.int32)
    head = {"layers": args.layers, "prompt": args.prompt,
            "batch": args.batch, "dtype": args.dtype}
    t0 = time.perf_counter()
    if args.scans is not None:
        if args.device != "cuda":
            ap.error("--scans runs the WKV6 kernel: it needs --device cuda")
        torch.backends.cuda.matmul.allow_tf32 = False
        scan_spread(cfg, args.scans, args.batch, args.prompt)
        return
    if args.device == "cuda":
        # the port's own seeded weights on the card, then on the host CPU
        torch.backends.cuda.matmul.allow_tf32 = False
        model = build_model(cfg, seed=args.seed, device="cuda")
        for device in ("cuda", "cpu"):
            model = model.to(device)
            out, layers = port_record(model, device, seq, args.prompt)
            print(json.dumps({**head, "run": f"port on {device}",
                              "gaps": out, "max": {s: max(g) for s, g in
                                                   out.items()},
                              "layers_after_1": layers,
                              "seconds": round(time.perf_counter() - t0, 1)}),
                  flush=True)
        return

    import jax
    import jax.numpy as jnp

    from repro.configs import registry as jax_registry
    from repro.models import build_model as jax_build_model
    from repro_torch.convert import rwkv6_from_numpy

    jm = jax_build_model(jax_registry.get_config("rwkv6-3b").replace(**kw))
    params = jm.init(seed=args.seed)

    def jax_prefill(tokens):
        logits, state = jm.prefill(params, {"tokens": jnp.asarray(tokens)})
        return np.asarray(logits[:, -1], np.float32), state

    def jax_decode(state, tok):
        logits, state = jm.decode_step(params, state, jnp.asarray(tok))
        return np.asarray(logits[:, -1], np.float32), state

    out = {**head, "jax": gaps(jax_prefill, jax_decode, seq, args.prompt)[0]}
    model = rwkv6_from_numpy(cfg, jax.tree.map(np.asarray, params),
                             device="cpu")
    del params
    out["port"], out["port_layers_after_1"] = port_record(model, "cpu", seq,
                                                          args.prompt)
    for pkg in ("jax", "port"):
        out[f"{pkg}_max"] = {s: max(g) for s, g in out[pkg].items()}
    out["seconds"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
