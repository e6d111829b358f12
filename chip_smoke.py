"""GPU smoke run of the PyTorch port: the sharded online request path, the
fraud scoring path on top of it, RWKV6 serving (rwkv6-3b prefill and
decode), dense LM serving (nemotron-4-15b prefill and decode), and the
offline feature path with its offline<->online consistency check.

Run from the repository root on a machine with one NVIDIA GPU and the CUDA
toolkit::

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. **Card.**  The card's name and power limit (``nvidia-smi``).
2. **Build.**  All seven CUDA kernels from ``src/repro_torch/kernels/csrc``,
   one ``nvcc`` per source, started together.
3. **Kernels against their plain versions** at the main path's shapes: the
   fused ingest kernel over 65,536-row batches into the full 2^19-card,
   8-shard store state (ring 256 rows x 2 lanes, 512 buckets of 64 s:
   ~15.6 GB, plus a second copy for the plain version) — all six arrays
   bit-exact through a key with more rows than the ring holds, bucket-slot
   reuse, trailing pads, an all-pad batch, one key with 20,000 rows over
   22 buckets and a batch of 65,536 distinct keys; the route-rank kernel on
   4,096-row batches at S = 8 and on an all-one-shard batch — exact; the
   fold-levels kernel for min, max and or at N = 2^24 rows sorted over
   2^19 cards and at the edges (N = 1, N not a power of two, one segment
   over all rows, every row its own segment, NaN / ±0.0 values, segments
   just shorter and longer than its halo, a hot key of 2^20 rows among
   the 2^24, NaN / ±inf in segments longer than the halo) — bit for bit.
   Ingest and fold levels must launch once a call.  Each is timed with
   CUDA events beside its plain version (the ingest kernel also inside a
   CUDA graph, without the host's launch time).
4. **Main path.**  ``FeatureService.build(fraud_view(), sharded=True,
   num_shards=8)`` on the GPU; a day of ~4.2M transactions ingested in
   65,536-row time slices; 8 request batches of 4,096 rows served through
   ``ShardRouter`` in preagg mode with ingest on.  Each batch's answers
   must equal, bit for bit, the same state queried with ranks from the
   route kernel's plain version; afterwards the store state must equal the
   ingest kernel's plain version replayed over the same batches.  Both
   kernels' launch counters must have gone up during this phase.
5. **Window stats.**  On the main path's warm state (flat keys), the
   window-stats kernel for one 4,096-row request batch, windows 1 h and
   6 h: count, min and max bit-exact against its plain version, sums
   within ``rtol=1e-5, atol=1e-3``; SUM 1 h, COUNT 1 h and MAX 6 h agree
   with the store's own preagg query on the same rows.  Its bound counts
   the bytes this batch's data needs (``_window_stats_bytes``).
6. **Trace.**  One more request batch (no ingest) under
   ``torch.profiler``: device kernels launched, device busy time and the
   device's idle share of the batch, the largest device items.
7. **Signature-embedding kernel** against its plain version at the
   scoring shapes: 4,096 rows, k = 2, a 2^18 x 512 float32 table (512 MB,
   larger than L2) over 8 batches of real multi-hash ids; and a bf16
   table, k = 1 and 3, D = 510 (not a multiple of 4 floats or 8 bf16) —
   all bit for bit.  Timed with CUDA events beside its plain version and
   ``F.embedding_bag`` (the library call), cycling over the 8 id batches
   so repeated launches do not find their rows in L2.  Its bound counts
   the distinct table rows each batch probes.
8. **Scoring path.**  ``ScoringService`` on the main path's warm sharded
   service (reused) with ``DecoderLM(featinsight_fraud.config())`` — 8
   layers, d_model 512, bf16, weights from a seeded generator on the
   card — and the 2^18 x 512 table: one warm-up batch, then 8 scored
   batches of 4,096 rows.  Scores must be finite and in [0, 1]; the
   signature-embedding kernel must have launched once a batch; the
   embeddings and scores must equal, bit for bit, the same batches served
   with the kernel's plain version swapped in (a score difference is
   checked against the kernel path's own run-to-run difference); flash
   attention (B6) must have launched once per layer per batch, all in its
   short-sequence ``mma16`` instantiation.  Prints
   the fenced batch wall p50 / p99 split into features, embedding and
   model, the peak device memory and one traced batch; then runs
   ``repro_torch.launch.serve.main`` once on the card at its defaults.
9. **WKV6 kernel** against its plain versions, float32 inputs from a
   seeded generator, r, k, v, lw as the model hands them over ((B, T, H,
   D) tensors viewed as (B, H, T, D)): (8, 40, 1024, 64) with a random s0
   and the decode step (8, 40, 1, 64) with and without s0, T = 15, a
   contiguous (1, 2, 100, 64), the lw edges (above 0, below the -3.5
   floor, 0, a whole chunk at the floor), and every head dim the kernel is
   built for plus D = 48 (zero-padded) at T = 1, 15, 16 and 100, and
   D = 288, 512 and 1,000 (``wide``) at T = 1, 16 and 100; each
   against the chunked plain version and, on four heads, the recurrence,
   at ``WKV_TOL``; D > 256 must run the ``wide`` instantiation, T < 16
   ``step``, longer sequences ``chunk``, and only D = 48 may be copied.
   The prefill and decode shapes are timed on the model's views with CUDA
   events: the kernel's eager launches (as the model issues them; at
   decode the host's launch overhead is most of that time) and the same
   launches inside a CUDA graph (the kernel alone), the wrapper ``wkv6``
   apart, and the chunked plain version; its bound is the larger of its
   bytes over 3.35 TB/s and its chunk products over the float32 peak.  ``wide`` is timed at (2, 8, 256, 512) beside the chunked plain
   version.
10. **RWKV6 serving.**  ``build_model(rwkv6_3b.config())`` at full width
   (32 layers, d_model 2560, 40 heads of 64, d_ff 8960, vocab 65536, bf16:
   2,900,298,240 parameters drawn on the card from a seeded generator, no
   depth cut).  A prefill and a decode step with a spy on B7's entry
   point: every call hands the kernel the model's projections uncopied and
   takes y back in place.  Then 8 prompts of 1,024 random tokens
   prefilled, then 32 tokens decoded greedily.  Logits finite, ``pos`` advanced, the WKV6 kernel
   launched exactly 32 x (1 + 32) times; the prefill logits and final
   ``wkv`` states are within ``RWKV_SCAN_STEPS`` bf16 steps of a run with
   the chunked plain version swapped in (a run with the recurrence
   swapped in is printed beside it).  Prints the fenced prefill wall
   and tokens/s, decode step p50 / p99 and tokens/s, peak device memory,
   how far decode after 1 and 8 steps is from prefill over the longer
   prompt, and one traced prefill and decode step (with B7's share of
   device time and the copy kernels left).  Then, at 16 layers,
   4 prompts of 256 tokens, that bf16 gap must stay within
   ``RWKV_GAP_MARGIN`` times the JAX package's own (``RWKV_REF_GAP``,
   measured by ``tests/rwkv6_bf16_gap.py``).  Then the same model
   in float32 (same seed; ``mu``, ``u`` and ``w0``, which the reference's
   init sets to constants, randomized): decode after 1 and 8 steps equals
   prefill over the longer prompt, and the kernel run the chunked-plain
   run, within ``LM_F32_TOL``.
11. **Flash attention kernel (B6)**: each instantiation's registers and
   spills (``ptxas -v``) and its ``HGMMA`` / ``HMMA`` count in the built
   library's SASS (``cuobjdump -sass``) -- a bf16 instantiation with no
   tensor-core instruction fails; then the kernel against its plain
   version ``attention_ref``: the reference's six kernel-test shapes in
   float32 and bf16, then bf16 at nemotron-4-15b's prefill (8, 48 heads
   over 8, 2,048, 128, causal), mixtral-8x7b's sliding window (1, 32 over
   8, 8,192, 128, window 4,096), phi3's head dim (8, 32, 32, 1,024, 96),
   the fraud scorer's (4,096, 8, 8, 65, 64), recurrentgemma-9b's head
   dim 256 (2, 16 over 1, 4,096, 256, window 2,048) and D = 512 (2, 8
   over 2, 1,024, 512); head dims above 256 (288, 320, 512, 1000, the
   ``wide`` instantiation) in float32 and bf16; tolerances ``FA_TOL``,
   each shape's instantiation launched once.  Every path
   shape is timed with CUDA events beside the plain version and
   ``F.scaled_dot_product_attention`` (the library call, timed only; a
   boolean mask for a window); the bound is the larger of the visible
   (q, k) pairs' products over the bf16 peak and q, k, v, o over 3.35
   TB/s.  Both bf16 instantiations are timed at S = 65 and S = 128 (the
   short-sequence threshold), and float32 at nemotron's shape.
12. **nemotron-4-15b serving.**  ``build_model(nemotron_4_15b.config())``
   at full width and depth (32 layers, d_model 6,144, 48 heads over 8 KV
   heads of 128, squared-ReLU d_ff 24,576, vocab 256,000 untied, bf16:
   15,628,376,064 parameters drawn on the card from a seeded generator);
   8 prompts of 2,048 random tokens prefilled into a FullKV of 2,080
   positions, then 32 tokens decoded greedily.  B6 must launch exactly 32
   times per prefill (its ``wgmma`` instantiation) and never in decode;
   logits finite; the prefill of 2 of the prompts equals a run with
   ``gqa_attention`` swapped in within ``LM_BF16_STEPS`` bf16 steps of the
   largest logit.  Prints the fenced prefill tokens/s, decode step p50 /
   p99 and tokens/s, the memory held before the phase and the peak, and
   one traced prefill (with B6's share of device time) and decode step.
   Then a float32 model at full width and 4 layers: the kernel run equals
   the plain-attention run within ``NEMO_F32_REL`` of the largest logit,
   and decode after 1 and 8 steps equals prefill over the longer prompt
   within the reference's ``LM_F32_TOL``.
13. **Offline path.**  ``OfflineEngine(device="cuda").compute(fraud_view(),
   ...)`` over 2^24 transactions (four days of the main path's traffic)
   on 2^19 cards, cold then warm; every feature must equal, bit for bit,
   a run with the fold-levels kernel's plain version swapped in, and the
   kernel's launch counter must have gone up.  Warm rows/s and peak
   device memory are printed, then one more warm export under
   ``torch.profiler`` (device busy time, idle share, largest items).
14. **Consistency.**  ``verify_view(fraud_view(), ..., device="cuda")`` on
   2^20 transactions over 2^17 cards in one hour, and on 2^20 over 2^11
   cards in a day, where the ring (256 rows) wraps and every one of the
   512 bucket slots of 64 s is reused; naive and preagg mode: all must
   pass.
15. **Summary.**  One ``kernels`` JSON line, then the card line, then the
    ``ok`` line last.

The weights of this system are its data: made here from a fixed seed.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
NUM_CARDS = 1 << 19
NUM_SHARDS = 8
STORE_KW = dict(capacity=256, num_buckets=512, bucket_size=64)
DAY = 86_400
SLICE_ROWS = 65_536
WARM_SLICES = 64          # 64 x 65,536 = 4,194,304 transactions
REQ_ROWS = 4_096
REQ_BATCHES = 8
OFFLINE_DAYS = 4          # 4 x 4,194,304 = 2^24 transactions
VERIFY_ROWS = 1 << 20
# (cards, span s) of the consistency runs, 2^20 transactions each:
# - 2^17 cards in one hour (8 per card): every 1 h / 6 h window reaches back
#   to its card's first row.  Spread over a day, this traffic leaves some
#   1 h windows with two near-equal large amounts, whose STD the reference's
#   own verify_view tolerance does not cover in either package
#   (tests/test_torch_offline.py::test_verify_view_fraud_span; ROADMAP
#   Queue C);
# - 2^11 cards over a day (512 per card): the ring (256 rows) wraps and
#   every bucket slot is reused (1,350 bucket ids over 512 slots), while a
#   6 h window still fits in the ring.
VERIFY_RUNS = ((1 << 17, 3600), (1 << 11, DAY))
WINDOWS = (3600, 21600)   # the fraud view's 1 h and 6 h RANGE windows
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# the scoring path's signature-embedding table and probes
SIG_ROWS, SIG_DIM, SIG_PROBES = 1 << 18, 512, 2
SIG_BATCHES = 8
# float32 outside the tensor cores, H100 SXM (NVIDIA data sheet): the WKV6
# kernel's chunk products run there
FP32_FLOP_PER_S = 67e12
# the RWKV6 serving phase: 8 prompts of 1,024 tokens, 32 greedy decode steps
RWKV_BATCH, RWKV_PROMPT, RWKV_DECODE = 8, 1024, 32
RWKV_PARAMS = 2_900_298_240   # rwkv6-3b's parameter tree (not param_count())
# WKV6 kernel vs its chunked plain version, and vs the recurrence: float32
# products summed in another order (allclose atol = rtol)
WKV_TOL = {"chunked": 1e-4, "recurrence": 5e-4}
# WKV6 head dims checked: every build (16 ... 256) and 48, zero-padded to
# 64; sequence lengths on both sides of a chunk (T < 16 runs "step")
WKV_CHECK_DIMS = (16, 32, 48, 64, 128, 256)
WKV_CHECK_LENGTHS = (1, 15, 16, 100)
# head dims above 256 ("wide", any T), and the shape it is timed at
WKV_WIDE_DIMS = (288, 512, 1000)
WKV_WIDE_LENGTHS = (1, 16, 100)
WKV_WIDE_TIMED = (2, 8, 256, 512)
# an LM's bf16 prefill with a kernel and with its plain version swapped in
# (WKV6's chunked version; gqa_attention, which rounds the attention
# weights to bf16 as B6 does, but sums in another order) differ in
# rounding inside one layer; a flipped bf16
# rounding of the residual stream spreads over 32 layers.  Allowed: this
# many bf16 steps (2^-8) of the array's largest value
LM_BF16_STEPS = 8
# rwkv6-3b in bf16 amplifies any rounding difference in the scan over its
# 32 layers: its two plain versions, the chunked one and the recurrence,
# both float32 and correct, part by more than LM_BF16_STEPS.  The kernel
# run may be this many bf16 steps of the largest value from the
# chunked-plain run: 1.5 x the largest gap between the two plain versions'
# runs over seeds 0-9 (14.36, the final states at seed 1; logits 11.79-
# 13.85), rounded up (``tests/rwkv6_bf16_gap.py --scans``; PERF.md,
# section 6).  The float32 checks (LM_F32_TOL) hold the kernel's
# arithmetic on this model
RWKV_SCAN_STEPS = 22
# decode after prefill vs prefill over the longer prompt, after this many
# steps
LM_CHECK_STEPS = (1, 8)
# rwkv6-3b's bf16 decode after 1 / 8 steps vs prefill over the longer
# prompt, in bf16 steps of a sequence's max |logit|.  The JAX package's own
# gap on the CPU at full width cut to 16 layers (``tests/rwkv6_bf16_gap.py
# --layers 16``) depends on the GEMM shapes more than on the step count:
# batch 1 / 256 tokens 2.73 after 1 step and 7.38 after 8; batch 1 / 1,024
# tokens 4.63 and 7.12; batch 4 / 256 tokens 0.0 and at most 5.78.  The
# check holds the card's largest per-sequence gap, after 1 and after 8
# steps, to the largest of these times RWKV_GAP_MARGIN: the port on the
# card and on its host's CPU, same weights and prompts, differed by up to
# 1.55x (``tests/rwkv6_bf16_gap.py --device cuda --batch 4``: at most 7.63
# / 8.33 on the card, 4.92 / 7.18 on the CPU); in float32 the gap is 0.003
RWKV_GAP_LAYERS, RWKV_GAP_BATCH, RWKV_GAP_PROMPT = 16, 4, 256
RWKV_REF_GAP = 7.381317138671875
RWKV_GAP_MARGIN = 1.6
# the float32 models' checks: the reference's own tolerance for decode vs
# prefill (tests/test_arch_smoke.py), allclose atol = rtol
LM_F32_TOL = 5e-4
# bf16 dense tensor-core peak, H100 SXM (NVIDIA data sheet): flash
# attention's products are bf16 on the main path
BF16_FLOP_PER_S = 989e12
# flash attention (B6) against its plain version: the reference's own
# tolerances (tests/test_kernels.py), allclose atol = rtol
FA_TOL = {torch.float32: 2e-5, torch.bfloat16: 3e-2}
# B, H, Hkv, S, D, causal, window, dtype: the reference's six kernel-test
# shapes (tests/test_kernels.py) in both dtypes, then the paths' shapes:
# nemotron-4-15b's prefill, mixtral-8x7b's sliding window (the attention
# shape only; its MoE model waits), phi3's head dim, the fraud scorer's
FA_TEST_SHAPES = [
    (2, 4, 2, 256, 64, True, None), (1, 8, 8, 128, 128, True, 64),
    (2, 4, 1, 192, 80, False, None), (1, 2, 2, 100, 32, True, 32),
    (2, 16, 4, 128, 128, True, None), (1, 4, 4, 384, 64, True, 128),
]
FA_PATH_SHAPES = {
    "nemotron": (8, 48, 8, 2048, 128, True, None),
    "mixtral": (1, 32, 8, 8192, 128, True, 4096),
    "phi3": (8, 32, 32, 1024, 96, True, None),
    "scorer": (4096, 8, 8, 65, 64, True, None),
    # recurrentgemma-9b's local attention: head dim 256, MQA, window 2,048
    "d256": (2, 16, 1, 4096, 256, True, 2048),
    # above the tiled instantiations ("wide"): no registry config has it
    "d512": (2, 8, 2, 1024, 512, True, None),
}
# head dims above 256 ("wide"), checked in both dtypes
FA_WIDE_SHAPES = [
    (2, 4, 2, 100, 288, True, None), (2, 4, 2, 65, 320, True, 30),
    (2, 4, 2, 300, 512, True, None), (2, 4, 2, 77, 1000, True, 50),
]
FA_TIMED = tuple(FA_PATH_SHAPES)
# the short-sequence dispatch threshold: both bf16 instantiations timed at
# the scorer's S = 65 and at S = 128 (the longest "mma16" takes)
FA_THRESHOLD_SHAPES = {
    "scorer": FA_PATH_SHAPES["scorer"],
    "S=128": (2048, 8, 8, 128, 64, True, None),
}
# a bf16 instantiation must run on the tensor cores: its SASS holds at
# least one of these
FA_TENSOR_CORE_OPS = {"fa_wgmma_kernel": ("HGMMA",),
                      "fa_mma16_kernel": ("HMMA", "HGMMA")}
# the nemotron-4-15b serving phase: 8 prompts of 2,048 tokens, 32 greedy
# decode steps into a FullKV of 2,080 positions
NEMO_BATCH, NEMO_PROMPT, NEMO_DECODE = 8, 2048, 32
NEMO_MAX_LEN = NEMO_PROMPT + NEMO_DECODE
# nemotron-4-15b's parameter tree, norms included (param_count() gives
# 15,627,976,704 without them)
NEMO_PARAMS = 15_628_376_064
# the plain-attention comparisons run on this many of the prompts: their
# S x S float32 scores are 1.6 GB in bf16's (B, Hkv, G, S, S) layout
NEMO_PLAIN_BATCH = 2
# the float32 model's depth (full width)
NEMO_F32_LAYERS = 4
# float32 model, kernel vs plain attention: max |diff| within this share
# of the largest logit (the two attentions differ only in summation order)
NEMO_F32_REL = 1e-4


def _fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_abs_err(a, b) -> float:
    """0.0 when the tensors are bitwise equal, else the largest difference
    (computed in 64M-element chunks: the state arrays are gigabytes)."""
    av = a.view(torch.int32) if a.dtype == torch.float32 else a
    bv = b.view(torch.int32) if b.dtype == torch.float32 else b
    if torch.equal(av, bv):
        return 0.0
    fa, fb = a.reshape(-1), b.reshape(-1)
    worst = 0.0
    for i in range(0, fa.numel(), 1 << 26):
        d = (fa[i:i + (1 << 26)].double() - fb[i:i + (1 << 26)].double())
        worst = max(worst, float(d.abs().max()))
    return worst if worst > 0 else float("nan")  # differing bits, equal values


def _flat_batch(rng, n, t_lo, t_hi, hot_rows=0, pad=0, distinct=False):
    """A (flat key, ts)-sorted ingest batch over the 2^19 flat keys, as the
    sharded store hands it to the kernel; ``hot_rows`` rows on one key,
    ``pad`` sentinel rows at the end; ``distinct``: n different keys."""
    if distinct:
        key = rng.choice(NUM_CARDS, n, replace=False).astype(np.int32)
    else:
        key = rng.integers(0, NUM_CARDS, n).astype(np.int32)
    key[:hot_rows] = 12_345
    ts = rng.integers(t_lo, t_hi, n).astype(np.int32)
    o = np.lexsort((ts, key))
    key, ts = key[o], ts[o]
    amt = rng.gamma(1.5, 60.0, n).astype(np.float32)
    vals = np.stack([amt, (amt > 100.0).astype(np.float32)], axis=1)
    key = np.concatenate([key, np.full(pad, NUM_CARDS, np.int32)])
    ts = np.concatenate([ts, np.full(pad, ts[-1] if n else t_lo, np.int32)])
    vals = np.concatenate([vals, np.zeros((pad, 2), np.float32)])
    dev = torch.device("cuda")
    return (torch.as_tensor(key, device=dev), torch.as_tensor(ts, device=dev),
            torch.as_tensor(vals, device=dev))


def _ingest_bytes(key, ts, lanes) -> int:
    """Bytes the fused ingest of one batch must move: the batch (key, ts,
    lanes) read once, plus each state element the batch touches read once
    and written once (ring slots written: a run's last C rows; bucket
    stats, bitmap and id read and written per (key, bucket) segment;
    cursor per key run), counted from the batch with numpy."""
    key, ts = key.cpu().numpy(), ts.cpu().numpy()
    real = key < NUM_CARDS
    k, b = key[real], np.floor_divide(ts[real], STORE_KW["bucket_size"])
    new_run = np.ones(len(k), bool)
    new_run[1:] = k[1:] != k[:-1]
    new_seg = new_run.copy()
    new_seg[1:] |= b[1:] != b[:-1]
    run_len = np.diff(np.append(np.flatnonzero(new_run), len(k)))
    ring_w = int(np.minimum(run_len, STORE_KW["capacity"]).sum())
    batch = len(key) * (4 + 4 + 4 * lanes)
    ring = ring_w * (4 + 4 * lanes)
    bucket = int(new_seg.sum()) * 2 * (20 * lanes + 4 * lanes + 4)
    cursor = len(run_len) * 2 * 4
    return batch + ring + bucket + cursor


def check_ingest_kernel(results) -> None:
    from repro_torch import kernels
    from repro_torch.core import preagg as pg
    from repro_torch.core import storage as st
    from repro_torch.kernels.ingest.ops import (
        fused_ingest, launch_fused_ingest,
    )
    from repro_torch.kernels.ingest.ref import fused_ingest_ref

    dev = torch.device("cuda")
    C, NB, BS = STORE_KW["capacity"], STORE_KW["num_buckets"], STORE_KW["bucket_size"]

    def fresh():
        r = st.ring_init(NUM_CARDS, C, 2, dev)
        b = pg.bucket_init(NUM_CARDS, NB, 2, BS, dev)
        return [r.ts, r.vals, r.cursor, b.stats, b.bitmap, b.bucket]

    sk, sr = fresh(), fresh()
    rng = np.random.default_rng(SEED + 1)
    slice_s = DAY // WARM_SLICES
    cases = [
        ("slice", SLICE_ROWS, 0, slice_s, 0, 0),
        ("hot key 300 rows > C", SLICE_ROWS - 1000, slice_s, 2 * slice_s, 300, 1000),
        ("slice", SLICE_ROWS, 2 * slice_s, 3 * slice_s, 0, 0),
        ("all pads", 0, 3 * slice_s, 3 * slice_s, 0, SLICE_ROWS),
        # 512 buckets of 64 s later: every slot of the first slices' buckets
        # is reused, so stale slots are reset before merging
        ("stale reuse", SLICE_ROWS, NB * BS, NB * BS + slice_s, 0, 0),
    ]
    # drawn from their own generator, so the timed batch below (and its
    # bound) is the same draw as before they were added
    rng_new = np.random.default_rng(SEED + 11)
    new_cases = [
        # one key's warp: 20,000 rows over the slice's 22 buckets
        ("hot key 20,000 rows over 22 buckets", SLICE_ROWS,
         NB * BS + slice_s, NB * BS + 2 * slice_s, 20_000, 0, False),
        ("65,536 distinct keys", SLICE_ROWS, NB * BS + 2 * slice_s,
         NB * BS + 3 * slice_s, 0, 0, True),
    ]
    worst = 0.0

    def check(name, n, pad, batch):
        nonlocal worst
        k, t, v = batch
        kernels.reset_launches()
        fused_ingest(*sk, k, t, v, bucket_size=BS)
        per_call = kernels.LAUNCHES["fused_ingest"]
        fused_ingest_ref(*sr, k, t, v, bucket_size=BS)
        torch.cuda.synchronize()
        errs = [_max_abs_err(a, b) for a, b in zip(sk, sr)]
        if any(e != 0.0 for e in errs):
            _fail(f"fused_ingest differs from its plain version on "
                  f"'{name}': per-array max |diff| {errs}")
        if per_call != 1:
            _fail(f"fused_ingest on '{name}': {per_call} launches a call")
        worst = max(worst, max(errs))
        print(f"fused_ingest == plain on '{name}' ({n} rows + {pad} pads): "
              f"six arrays bit-exact; {per_call} launch", flush=True)

    for name, n, lo, hi, hot, pad in cases:
        check(name, n, pad, _flat_batch(rng, n, lo, hi, hot, pad))
    for name, n, lo, hi, hot, pad, distinct in new_cases:
        check(name, n, pad, _flat_batch(rng_new, n, lo, hi, hot, pad, distinct))

    # timing on one main-path-shaped batch (state keeps changing: the same
    # work each repetition)
    k, t, v = _flat_batch(rng, SLICE_ROWS, 4 * slice_s, 5 * slice_s)
    ms = _time_ms(lambda: fused_ingest(*sk, k, t, v, bucket_size=BS), 20)
    # the kernel's launches eager (host launch time included) and in a
    # CUDA graph (the kernel alone)
    kernel_ms = _time_ms(
        lambda: launch_fused_ingest(*sk, k, t, v, bucket_size=BS), 20
    )
    graph_ms = _graph_time_ms(
        lambda: launch_fused_ingest(*sk, k, t, v, bucket_size=BS), 20
    )
    plain_ms = _time_ms(
        lambda: fused_ingest_ref(*sr, k, t, v, bucket_size=BS), 3
    )
    nbytes = _ingest_bytes(k, t, 2)
    results["fused_ingest"] = dict(
        max_abs_err=worst, ms=ms, kernel_ms=kernel_ms,
        kernel_graph_ms=graph_ms, plain_ms=plain_ms,
        bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bytes=nbytes,
        launches_per_call=1,
        shape=f"{SLICE_ROWS} rows x 2 lanes into {NUM_CARDS} keys",
    )
    print(f"fused_ingest {SLICE_ROWS} rows: wrapper {ms:.4f} ms "
          f"(kernel alone {kernel_ms:.4f} ms eager, {graph_ms:.4f} ms in a "
          f"CUDA graph), plain {plain_ms:.4f} ms, bound "
          f"{results['fused_ingest']['bound_ms']:.5f} ms ({nbytes} bytes); "
          "1 launch a call", flush=True)
    del sk, sr, k, t, v
    torch.cuda.empty_cache()


def check_route_kernel(results) -> None:
    from repro_torch.core.hashing import KeyPermutation
    from repro_torch.kernels.route.ops import route_rank
    from repro_torch.kernels.route.ref import route_rank_ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 2)
    perm = KeyPermutation(NUM_CARDS)
    batches = []
    for _ in range(4):
        keys = rng.integers(0, NUM_CARDS, REQ_ROWS)
        batches.append(("feistel S=8", torch.as_tensor(
            (perm(keys) % NUM_SHARDS).astype(np.int32), device=dev)))
    batches.append(("all on one shard", torch.full(
        (REQ_ROWS,), 3, dtype=torch.int32, device=dev)))
    pad = torch.as_tensor(
        (perm(rng.integers(0, NUM_CARDS, REQ_ROWS)) % NUM_SHARDS).astype(np.int32),
        device=dev)
    pad[-100:] = NUM_SHARDS
    batches.append(("100 pad ids", pad))
    worst = 0.0
    for name, shard in batches:
        rk, ck = route_rank(shard, num_shards=NUM_SHARDS)
        rr, cr = route_rank_ref(shard, NUM_SHARDS)
        torch.cuda.synchronize()
        err = max(_max_abs_err(rk, rr), _max_abs_err(ck, cr))
        if err != 0.0:
            _fail(f"route_rank differs from its plain version on '{name}'")
        worst = max(worst, err)
        print(f"route_rank == plain on '{name}' ({REQ_ROWS} rows, "
              f"S={NUM_SHARDS}): exact", flush=True)
    shard = batches[0][1]
    ms = _time_ms(lambda: route_rank(shard, num_shards=NUM_SHARDS), 200, 5)
    plain_ms = _time_ms(lambda: route_rank_ref(shard, NUM_SHARDS), 200, 5)
    nbytes = REQ_ROWS * 4 * 2 + NUM_SHARDS * 4
    results["route_rank"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms,
        bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bytes=nbytes,
        shape=f"{REQ_ROWS} rows, S={NUM_SHARDS}",
    )
    print(f"route_rank {REQ_ROWS} rows: {ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {results['route_rank']['bound_ms']:.6f} ms", flush=True)


def _fold_inputs(rng, n, op, segments, special=False, hot=0):
    """(x, seg) on the card: ``segments`` keys sorted over n rows (0: one
    segment over all rows, -1: every row its own segment, "halo": segments
    of FOLD_HALO - 1 ... FOLD_HALO + 2 rows); ``hot`` rows on one key."""
    from repro_torch.core.windows import segment_starts
    from repro_torch.kernels.window_agg.ops import FOLD_HALO

    dev = torch.device("cuda")
    if segments == "halo":
        lens = rng.integers(FOLD_HALO - 1, FOLD_HALO + 3, n // FOLD_HALO + 1)
        key = np.repeat(np.arange(len(lens)), lens)[:n].astype(np.int32)
    elif segments == 0:
        key = np.zeros(n, np.int32)
    elif segments < 0:
        key = np.arange(n, dtype=np.int32)
    else:
        key = np.sort(rng.integers(0, segments, n)).astype(np.int32)
        if hot:
            key[n // 3:n // 3 + hot] = key[n // 3]
            key = np.sort(key)
    if op == "or":
        x = rng.integers(-2**31, 2**31 - 1, n).astype(np.int32)
    else:
        x = rng.normal(size=n).astype(np.float32)
        if special:
            pick = rng.random(n) < 0.2
            x[pick] = rng.choice(np.array(
                [0x0, 0x80000000, 0x7FC00000, 0xFFC00000, 0x7FC00001,
                 0xFF800005, 0x7F800000, 0xFF800000], np.uint32
            ).view(np.float32), int(pick.sum()))
    return (torch.as_tensor(x, device=dev),
            segment_starts(torch.as_tensor(key, device=dev)))


def check_fold_kernel(results) -> None:
    from repro_torch import kernels
    from repro_torch.kernels.window_agg.ops import fold_levels, plan_fold_levels
    from repro_torch.kernels.window_agg.ref import fold_levels_ref

    rng = np.random.default_rng(SEED + 5)
    n_main = 1 << 24
    cases = [(f"N=2^24 over {NUM_CARDS} cards", n_main, NUM_CARDS, False, 0),
             ("N=1", 1, 1, False, 0),
             ("N=1,000,003 (not a power of two)", 1_000_003, 4096, False, 0),
             ("one segment over all rows", 1 << 20, 0, False, 0),
             ("every row its own segment", 1 << 20, -1, False, 0),
             ("NaN / +-0.0 / +-inf values", 1 << 20, 1024, True, 0)]
    # drawn from their own generator, so the timed input below is the same
    # draw as before they were added
    rng_new = np.random.default_rng(SEED + 12)
    new_cases = [
        ("segments of the halo's length +-2, across tile starts", 1 << 22,
         "halo", False, 0),
        (f"a hot key of 2^20 rows among N=2^24 over {NUM_CARDS} cards",
         n_main, NUM_CARDS, False, 1 << 20),
        ("NaN / +-0.0 / +-inf in segments of ~2,048 rows (longer than the "
         "halo)", 1 << 20, 512, True, 0),
    ]
    worst = 0.0
    for gen, group in ((rng, cases), (rng_new, new_cases)):
        for name, n, segments, special, hot in group:
            for op in ("min", "max", "or"):
                if special and op == "or":
                    continue
                x, seg = _fold_inputs(gen, n, op, segments, special, hot)
                kernels.reset_launches()
                got = fold_levels(x, seg, op=op)
                per_call = kernels.LAUNCHES["fold_levels"]
                want = fold_levels_ref(x, seg, op)
                torch.cuda.synchronize()
                err = (_max_abs_err(got, want) if got.shape == want.shape
                       else 1.0)
                if err != 0.0:
                    _fail(f"fold_levels({op}) differs from its plain version "
                          f"on '{name}' (max |diff| {err})")
                if per_call != 1:
                    _fail(f"fold_levels({op}) on '{name}': {per_call} "
                          "launches a call")
                worst = max(worst, err)
                del got, want
            print(f"fold_levels == plain on '{name}' ({n} rows): min / max"
                  f"{'' if special else ' / or'} bit-exact; 1 launch a call",
                  flush=True)
    x, seg = _fold_inputs(rng, n_main, "max", NUM_CARDS)
    ms = _time_ms(lambda: fold_levels(x, seg, op="max"), 10)
    plain_ms = _time_ms(lambda: fold_levels_ref(x, seg, "max"), 3)
    plan = plan_fold_levels(n_main)
    kl = plan.levels
    nbytes = n_main * (8 + 4 * kl)
    results["fold_levels"] = dict(
        max_abs_err=worst, ms=ms, plain_ms=plain_ms,
        bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bytes=nbytes,
        launches_per_call=1,
        shape=f"{n_main} rows over {NUM_CARDS} cards, max, KL={kl} (one "
              f"launch a call: tiles of {plan.tile} rows + a halo of "
              f"{plan.halo})",
    )
    print(f"fold_levels {n_main} rows (KL={kl}): {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {results['fold_levels']['bound_ms']:.4f}"
          f" ms ({nbytes} bytes); 1 launch a call", flush=True)
    del x, seg
    torch.cuda.empty_cache()


def _request_rows(rng, t_lo):
    cols = dict(
        card=rng.integers(0, NUM_CARDS, REQ_ROWS).astype(np.int32),
        ts=rng.integers(t_lo, t_lo + 60, REQ_ROWS).astype(np.int32),
        amount=rng.gamma(1.5, 60.0, REQ_ROWS).astype(np.float32),
        mcc=rng.integers(0, 32, REQ_ROWS).astype(np.int32),
        device=rng.integers(0, 8, REQ_ROWS).astype(np.int32),
        geo=rng.integers(0, 16, REQ_ROWS).astype(np.int32),
    )
    return cols


def main_path(results):
    from repro_torch import kernels
    from repro_torch.core import shard as shard_mod
    from repro_torch.data.synthetic import fraud_transactions
    from repro_torch.kernels.ingest.ref import fused_ingest_ref
    from repro_torch.kernels.route.ref import route_rank_ref
    from repro_torch.obs import Telemetry, get_telemetry, use_telemetry
    from repro_torch.scenarios import fraud_view
    from repro_torch.serve.router import ShardRouter
    from repro_torch.serve.service import BatchScheduler, FeatureService

    svc = FeatureService.build(
        "fraud", fraud_view(), num_keys=NUM_CARDS, sharded=True,
        num_shards=NUM_SHARDS, mode="preagg", device="cuda", **STORE_KW,
    )
    store = svc.store
    print(f"store state: {sum(t.numel() * t.element_size() for t in store.state.arrays()) / 1e9:.2f} GB "
          f"({NUM_SHARDS} shards x {store.num_keys} cards)", flush=True)

    # every flat batch the store hands to the ingest kernel, kept to replay
    # through the plain version afterwards
    applied = []
    apply_kernel = store._apply_ingest

    def recording_apply(key, ts, lanes):
        applied.append((key, ts, lanes))
        apply_kernel(key, ts, lanes)

    store._apply_ingest = recording_apply

    # the expected answers: the same state queried with the route kernel's
    # plain version in place of the kernel
    def route_rank_plain(shard, *, num_shards):
        return route_rank_ref(shard, num_shards)

    def expected_answers(rows):
        # its own telemetry, so the served path's spans stay its own
        shard_mod.route_rank = route_rank_plain
        try:
            with use_telemetry(Telemetry()):
                out = store.query(dict(rows), mode="preagg")
            return {f: v.cpu().numpy() for f, v in out.items()}
        finally:
            shard_mod.route_rank = kernels_route_rank

    kernels_route_rank = shard_mod.route_rank
    rng = np.random.default_rng(SEED)
    slices = [
        fraud_transactions(rng, SLICE_ROWS, NUM_CARDS,
                           i * DAY // WARM_SLICES, (i + 1) * DAY // WARM_SLICES)
        for i in range(WARM_SLICES)
    ]
    torch.cuda.synchronize()

    kernels.reset_launches()
    t0 = time.perf_counter()
    for cols in slices:
        store.ingest(cols)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    rows_in = WARM_SLICES * SLICE_ROWS
    print(f"warm ingest: {rows_in} rows in {ingest_s:.3f} s = "
          f"{rows_in / ingest_s:.0f} rows/s (host routing + device ingest, "
          f"{WARM_SLICES} batches)", flush=True)
    ingest_launches = kernels.LAUNCHES["fused_ingest"]

    router = ShardRouter(
        svc, BatchScheduler(buckets=(REQ_ROWS,), max_batch=REQ_ROWS)
    )
    svc.stats = type(svc.stats)()
    for b in range(REQ_BATCHES):
        rows = _request_rows(rng, DAY + 60 * b)
        want = expected_answers(rows)
        for i in range(REQ_ROWS):
            router.submit({c: v[i] for c, v in rows.items()})
        got = router.pump(flush=True)
        for f in want:
            a, g = want[f], got[f]
            if g.shape != (REQ_ROWS,) or not np.all(np.isfinite(g)):
                _fail(f"batch {b} feature {f}: shape {g.shape} or non-finite")
            if not np.array_equal(a.view(np.int32), g.view(np.int32)):
                _fail(f"batch {b} feature {f}: routed answers differ from "
                      "the route plain version's")
        if not (got["tx_count_1h"] >= 1).all():
            _fail("every request counts at least itself in its window")
    torch.cuda.synchronize()
    launches = dict(kernels.LAUNCHES)
    print(f"served {REQ_BATCHES} batches x {REQ_ROWS} rows: answers == "
          "route plain version's, bit for bit", flush=True)
    if launches["fused_ingest"] <= ingest_launches or launches["route_rank"] < REQ_BATCHES:
        _fail(f"kernel launch counts on the main path: {launches}")
    # window_stats sits beside the preagg query (not on this path): 0
    for k in ("fused_ingest", "route_rank", "window_stats"):
        results.setdefault(k, {})["launches"] = launches[k]
    st = svc.stats
    print(f"request latency (queue wait + batch wall, {st.requests} requests): "
          f"p50 {st.request_p50_ms:.3f} ms, p99 {st.request_p99_ms:.3f} ms; "
          f"batch wall p50 {st.p50_ms:.3f} ms, p99 {st.p99_ms:.3f} ms", flush=True)
    spans = get_telemetry().metrics.histogram(
        "span_seconds", unit="s", labels=("name", "kind"))
    for name, kind in (("query.route", "host"), ("route.device", "device"),
                       ("query.scatter", "host"), ("ingest", "device"),
                       ("request", "host")):
        print(f"span {name}: mean {1e3 * spans.mean(name=name, kind=kind):.3f} ms "
              f"over {int(spans.count(name=name, kind=kind))}", flush=True)

    # the store state == the ingest plain version over the same batches
    # drop the instance attribute (a bound method stored on its own object
    # is a reference cycle that keeps the 15.6 GB store alive after del)
    del store._apply_ingest
    ref = store._init_state()
    ref_flat = [t.flatten(0, 1) for t in ref.arrays()]
    for key, ts, lanes in applied:
        fused_ingest_ref(*ref_flat, key, ts, lanes, bucket_size=store.bucket_size)
    torch.cuda.synchronize()
    errs = [_max_abs_err(a, b) for a, b in zip(store.state.arrays(), ref.arrays())]
    if any(e != 0.0 for e in errs):
        _fail(f"ingested state differs from the plain version: {errs}")
    print(f"ingested state ({len(applied)} batches) == ingest plain version: "
          "six arrays bit-exact", flush=True)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)
    del ref, ref_flat, applied
    torch.cuda.empty_cache()
    check_window_stats(results, store, _request_rows(rng, DAY + 60 * REQ_BATCHES))
    trace_request(svc, _request_rows(rng, DAY + 60 * REQ_BATCHES))
    return svc


def _window_stats_bytes(ring_ts, bagg_bucket, qk, q_ts, L, B):
    """(distinct keys, bytes) the window-stats call must move on this data:
    per distinct key its C ring timestamps (to find the raw rows), the lane
    values of the ring rows some window folds raw (head or tail bucket),
    the stored ids of the bucket slots that can hold a middle bucket of the
    widest window (id mod NB for b_lo < id < b_q) and the stats of the
    slots whose id is a middle bucket of some window; per request its key,
    ts and lanes in and its (NW, L, 5) stats out."""
    NB = bagg_bucket.shape[1]
    uk, inv = torch.unique(qk, return_inverse=True)
    ts, bids = ring_ts[qk.long()], bagg_bucket[qk.long()]
    b_q = torch.div(q_ts, B, rounding_mode="floor")[:, None]
    raw = torch.zeros_like(ts, dtype=torch.bool)
    mid = torch.zeros_like(bids, dtype=torch.bool)
    row_b = torch.div(ts, B, rounding_mode="floor")
    live = (ts != -2**31) & (ts <= q_ts[:, None])
    for T in WINDOWS:
        b_lo = torch.div(q_ts - T, B, rounding_mode="floor")[:, None]
        inside = live & (ts > q_ts[:, None] - T)
        raw |= inside & ((row_b == b_q) | ((row_b == b_lo) & (b_lo != b_q)))
        mid |= (bids > b_lo) & (bids < b_q)
    b_lo = torch.div(q_ts - max(WINDOWS), B, rounding_mode="floor")[:, None]
    span = (b_q - b_lo - 1).clamp(0, NB)
    slot = torch.arange(NB, device=qk.device)[None, :]
    cand = torch.remainder(slot - (b_lo + 1), NB) < span
    per_key = [torch.zeros((uk.numel(), m.shape[1]), dtype=torch.int32,
                           device=qk.device).index_add_(0, inv, m.int()) > 0
               for m in (raw, cand, mid)]
    raw_u, cand_u, mid_u = (int(m.sum()) for m in per_key)
    Q, NW = qk.numel(), len(WINDOWS)
    nbytes = (uk.numel() * ring_ts.shape[1] * 4 + raw_u * 4 * L
              + cand_u * 4 + mid_u * 20 * L
              + Q * ((8 + 4 * L) + NW * L * 20))
    return int(uk.numel()), nbytes


def check_window_stats(results, store, rows) -> None:
    """The window-stats kernel on the main path's warm state: against its
    plain version, and against the store's own preagg answers."""
    from repro_torch.core.expr import Col
    from repro_torch.kernels.window_agg.ops import window_stats
    from repro_torch.kernels.window_agg.ref import window_stats_ref
    from repro_torch.obs import Telemetry, use_telemetry

    dev = torch.device("cuda")
    fs = store._flat_state()
    shard, local = store._route_ids(rows["card"])
    qk = torch.as_tensor((shard * store.num_keys + local).astype(np.int32),
                         device=dev)
    cols = store._columns(rows)
    args = (fs.ring.ts, fs.ring.vals, fs.bagg.stats, fs.bagg.bucket, qk,
            cols["ts"], store._lanes(cols))
    kw = dict(windows=WINDOWS, bucket_size=store.bucket_size)
    got = window_stats(*args, **kw)
    want = window_stats_ref(*args, **kw)
    torch.cuda.synchronize()
    if got.shape != (REQ_ROWS, len(WINDOWS), store.num_lanes, 5):
        _fail(f"window_stats shape {tuple(got.shape)}")
    exact = max(_max_abs_err(got[..., i].contiguous(), want[..., i].contiguous())
                for i in (1, 2, 3))
    if exact != 0.0:
        _fail(f"window_stats count/min/max differ from the plain version "
              f"(max |diff| {exact})")
    sums = [(got[..., i] - want[..., i]).abs().max().item() for i in (0, 4)]
    if not all(torch.allclose(got[..., i], want[..., i], rtol=1e-5, atol=1e-3)
               for i in (0, 4)):
        _fail(f"window_stats sums outside rtol 1e-5 / atol 1e-3: {sums}")
    with use_telemetry(Telemetry()):
        res = store.query(dict(rows), mode="preagg")
    lane = store._lane_of[Col("amount").key]
    g = got.cpu().numpy()
    s1h, c1h, m6h = g[:, 0, lane, 0], g[:, 0, lane, 1], g[:, 1, lane, 3]
    if not np.allclose(s1h, res["amt_sum_1h"].cpu().numpy(), rtol=1e-5,
                       atol=1e-3):
        _fail("window_stats SUM 1h disagrees with the store's preagg query")
    for name, v in (("tx_count_1h", c1h), ("amt_max_6h", m6h)):
        if not np.array_equal(v, res[name].cpu().numpy()):
            _fail(f"window_stats {name} differs from the store's preagg query")
    print(f"window_stats == plain on {REQ_ROWS} requests x {len(WINDOWS)} "
          f"windows x {store.num_lanes} lanes: count/min/max bit-exact, sums "
          f"max |diff| {max(sums):.3e}; SUM 1h / COUNT 1h / MAX 6h agree with "
          "the store's preagg query", flush=True)
    ms = _time_ms(lambda: window_stats(*args, **kw), 50, 3)
    plain_ms = _time_ms(lambda: window_stats_ref(*args, **kw), 5)
    C, L, NB = store.capacity, store.num_lanes, store.num_buckets
    keys, nbytes = _window_stats_bytes(fs.ring.ts, fs.bagg.bucket, qk,
                                       cols["ts"], L, store.bucket_size)
    results["window_stats"].update(
        max_abs_err=max(sums), ms=ms, plain_ms=plain_ms,
        bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bytes=nbytes,
        shape=f"{REQ_ROWS} requests ({keys} keys), C={C}, NB={NB}, L={L}, "
              f"windows {WINDOWS}",
    )
    print(f"window_stats {REQ_ROWS} requests: {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {results['window_stats']['bound_ms']:.5f}"
          f" ms ({nbytes} bytes)", flush=True)


def trace_request(svc, rows) -> None:
    """Profile one request batch: device kernels, busy time, idle share."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    svc.request(dict(rows), ingest=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        svc.request(dict(rows), ingest=False)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    n_kernels = sum(e.count for e in dev)
    if busy_ms <= 0:
        print("trace: the profiler recorded no device time (device busy "
              "share not measured)", flush=True)
        return
    print(f"trace (profiler on): request batch wall {wall_ms:.3f} ms, "
          f"{n_kernels} device kernels, device busy {busy_ms:.3f} ms, "
          f"idle share {1 - busy_ms / wall_ms:.4f}", flush=True)
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:6]:
        print(f"  device {e.self_device_time_total / 1e3:.4f} ms "
              f"x{e.count} {e.key[:90]}", flush=True)


def _sig_ids(rng, n, k, V):
    """(N, k) multi-hash ids of ``n`` random 20-bit signatures, as the
    scoring path computes them."""
    from repro_torch.core.signature import multi_hash_ids

    sig = torch.as_tensor(rng.integers(0, 2**20, n).astype(np.int32),
                          device="cuda")
    return multi_hash_ids(sig, k, V)


def _sig_bytes(ids, D, esize) -> int:
    """Bytes one signature-embedding call must move on these ids: each
    distinct probed table row once, the ids, the weights and the output."""
    n, k = ids.shape
    rows = int(torch.unique(ids).numel())
    return rows * D * esize + n * k * 4 + k * 4 + n * D * esize


def check_signature_kernel(results):
    """The signature-embedding kernel against its plain version, bit for
    bit, then timed at the scoring shapes.  Returns the float32 table the
    scoring phase uses."""
    import torch.nn.functional as F

    from repro_torch.kernels.signature.ops import (
        launch_signature_embed,
        signature_embed,
    )
    from repro_torch.kernels.signature.ref import signature_embed_ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 6)
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    table = torch.randn((SIG_ROWS, SIG_DIM), generator=g, device=dev) * 0.02
    w = torch.full((SIG_PROBES,), 1.0 / SIG_PROBES, device=dev)

    def check(name, tab, ids, wts):
        out = torch.empty((ids.shape[0], tab.shape[1]), dtype=tab.dtype,
                          device=dev)
        launch_signature_embed(tab, ids, wts, out)
        want = signature_embed_ref(tab, ids, wts).to(tab.dtype)
        torch.cuda.synchronize()
        bits = torch.int32 if tab.dtype == torch.float32 else torch.int16
        if not torch.equal(out.view(bits), want.view(bits)):
            err = float((out.float() - want.float()).abs().max())
            _fail(f"signature_embed differs from its plain version on "
                  f"'{name}' (max |diff| {err})")
        print(f"signature_embed == plain on '{name}' ({ids.shape[0]} rows, "
              f"k={ids.shape[1]}, table {tuple(tab.shape)} {tab.dtype}): "
              "bit-exact", flush=True)

    batches = [_sig_ids(rng, REQ_ROWS, SIG_PROBES, SIG_ROWS)
               for _ in range(SIG_BATCHES)]
    for b, ids in enumerate(batches):
        check(f"scoring batch {b}", table, ids, w)
    bf16 = table.to(torch.bfloat16)
    check("bf16 table", bf16, batches[0], w)
    for k in (1, 3):
        wk = torch.randn((k,), generator=g, device=dev)
        ids = _sig_ids(rng, REQ_ROWS, k, SIG_ROWS)
        check(f"k={k}", table, ids, wk)
        check(f"k={k} bf16", bf16, ids, wk)
    odd = table[: 1 << 16, :510].contiguous()
    ids = _sig_ids(rng, REQ_ROWS, SIG_PROBES, odd.shape[0])
    check("D=510 f32", odd, ids, w)
    check("D=510 bf16", odd.to(torch.bfloat16), ids, w)
    del bf16, odd

    # timing: each repetition takes the next of the 8 id batches (8 x 8,192
    # probed rows of 2 KB = 128 MB, so a launch does not find its rows in
    # the 50 MB L2)
    out = torch.empty((REQ_ROWS, SIG_DIM), device=dev)
    wide = w.expand(REQ_ROWS, SIG_PROBES).contiguous()
    ids_long = [ids.long() for ids in batches]
    sigs = [torch.as_tensor(rng.integers(0, 2**20, REQ_ROWS).astype(np.int32),
                            device=dev) for _ in range(SIG_BATCHES)]
    step = itertools.count()

    def nxt():
        return next(step) % SIG_BATCHES

    def library_call():
        i = nxt()
        return F.embedding_bag(ids_long[i], table, per_sample_weights=wide,
                               mode="sum")

    reps = 10 * SIG_BATCHES
    ms = _time_ms(lambda: launch_signature_embed(
        table, batches[nxt()], w, out), reps, SIG_BATCHES)
    plain_ms = _time_ms(lambda: signature_embed_ref(
        table, batches[nxt()], w), reps, SIG_BATCHES)
    library_ms = _time_ms(library_call, reps, SIG_BATCHES)
    wrapper_ms = _time_ms(lambda: signature_embed(
        table, sigs[nxt()], w, num_hashes=SIG_PROBES), reps, SIG_BATCHES)
    lib = F.embedding_bag(ids_long[0], table, per_sample_weights=wide,
                          mode="sum")
    want = signature_embed_ref(table, batches[0], w)
    lib_err = float((lib - want).abs().max())
    nbytes = sum(_sig_bytes(ids, SIG_DIM, 4) for ids in batches) / SIG_BATCHES
    results["signature_embed"] = dict(
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
        wrapper_ms=wrapper_ms, bound_ms=1e3 * nbytes / HBM_BYTES_PER_S,
        bytes=nbytes, library_max_abs_diff=lib_err,
        shape=f"{REQ_ROWS} rows, k={SIG_PROBES}, table {SIG_ROWS} x "
              f"{SIG_DIM} f32 (mean over {SIG_BATCHES} id batches)",
    )
    print(f"signature_embed {REQ_ROWS} rows k={SIG_PROBES}: kernel {ms:.4f} "
          f"ms (wrapper with the id hashing {wrapper_ms:.4f} ms), plain "
          f"{plain_ms:.4f} ms, F.embedding_bag {library_ms:.4f} ms (max "
          f"|diff| {lib_err:.3e}), bound "
          f"{results['signature_embed']['bound_ms']:.5f} ms ({nbytes:.0f} "
          "bytes)", flush=True)
    return table


def _batch_spans(tracer):
    """Durations (s) of the last ``score`` span and its three children."""
    root = tracer.last_root("score")
    out = {"score": root.duration_s}
    for c in root.children:
        out[c.name] = c.duration_s
    return out


def scoring_path(results, svc, table) -> None:
    """ScoringService on the warm sharded service with the full-width bf16
    fraud model; the same batches with the signature-embedding kernel's
    plain version swapped in; one traced batch; the serve launcher."""
    from repro_torch import kernels
    from repro_torch.configs.featinsight_fraud import config
    from repro_torch.core.signature import multi_hash_ids
    from repro_torch.kernels.signature.ref import signature_embed_ref
    from repro_torch.launch import serve
    from repro_torch.models.transformer import DecoderLM
    from repro_torch.obs import Telemetry, use_telemetry
    from repro_torch.serve.service import ScoringService

    # float32 products stay float32 (no TF32), as the reference asks
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = config()
    model = DecoderLM(cfg, seed=SEED, device="cuda")
    n_params = sum(p.numel() for p in model.parameters())
    scoring = ScoringService(svc, model, table)
    rng = np.random.default_rng(SEED + 7)
    t0 = DAY + 60 * (REQ_BATCHES + 2)
    batches = [_request_rows(rng, t0 + 60 * b) for b in range(REQ_BATCHES)]
    print(f"scoring model {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.param_dtype}, {n_params} parameters; "
          f"{REQ_ROWS} rows x {cfg.frontend_len + 1} positions a batch",
          flush=True)

    kernel_embed = scoring._embed
    embs = []

    def recording_embed(*a, **kw):
        out = kernel_embed(*a, **kw)
        embs.append(out)
        return out

    def recording_embed_plain(tab, sig, wts, *, num_hashes):
        ids = multi_hash_ids(sig, num_hashes, tab.shape[0])
        out = signature_embed_ref(tab, ids, wts).to(tab.dtype)
        embs.append(out)
        return out

    tel = Telemetry()

    def serve_all():
        del embs[:]
        scores, spans, walls = [], [], []
        for rows in batches:
            tt = time.perf_counter()
            scores.append(scoring.handle(dict(rows)))
            walls.append(time.perf_counter() - tt)
            spans.append(_batch_spans(tel.tracer))
        return scores, [e.clone() for e in embs], spans, walls

    with use_telemetry(tel):
        scoring._embed = recording_embed
        scoring.handle(dict(batches[0]))      # warm-up: cuBLAS, allocator
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kernels.reset_launches()
        scores, emb_k, spans, walls = serve_all()
        launches = dict(kernels.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        if launches["signature_embed"] < REQ_BATCHES:
            _fail(f"the scoring path did not launch the signature-embedding "
                  f"kernel once a batch: {launches}")
        results["signature_embed"]["launches"] = launches["signature_embed"]
        if launches["flash_attention"] != cfg.n_layers * REQ_BATCHES:
            _fail(f"the scoring path launched flash attention "
                  f"{launches['flash_attention']} times, expected "
                  f"{cfg.n_layers * REQ_BATCHES} (one per layer per batch)")
        short = kernels.VARIANT_LAUNCHES["flash_attention"]["mma16"]
        if short != cfg.n_layers * REQ_BATCHES:
            _fail(f"the scoring path's flash attention ran its mma16 "
                  f"instantiation {short} times, expected "
                  f"{cfg.n_layers * REQ_BATCHES}")
        results["scoring_flash_attention_launches"] = launches["flash_attention"]
        for b, sc in enumerate(scores):
            if sc.shape != (REQ_ROWS,) or not np.all(np.isfinite(sc)):
                _fail(f"scoring batch {b}: shape {sc.shape} or non-finite")
            if not np.all((sc >= 0) & (sc <= 1)):
                _fail(f"scoring batch {b}: scores outside [0, 1]")
        print(f"scored {REQ_BATCHES} batches x {REQ_ROWS} rows: finite, in "
              f"[{min(s.min() for s in scores):.4f}, "
              f"{max(s.max() for s in scores):.4f}]; launches {launches}, "
              f"flash attention by instantiation "
              f"{kernels.VARIANT_LAUNCHES['flash_attention']}",
              flush=True)
        for name in ("score", "score.features", "score.embed", "score.model"):
            v = np.array([sp[name] for sp in spans]) * 1e3
            print(f"span {name}: p50 {np.percentile(v, 50):.3f} ms, p99 "
                  f"{np.percentile(v, 99):.3f} ms (of {len(v)} batches)",
                  flush=True)
        w = np.array(walls) * 1e3
        print(f"scoring batch wall (handle, fenced) p50 "
              f"{np.percentile(w, 50):.3f} ms, p99 {np.percentile(w, 99):.3f}"
              f" ms = {REQ_ROWS / np.percentile(w, 50) * 1e3:.0f} rows/s at "
              f"p50; peak device memory {peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f}"
              f" GB above the {base / 1e9:.2f} GB held before)", flush=True)

        scoring._embed = recording_embed_plain
        scores_p, emb_p, _, _ = serve_all()
        for b in range(REQ_BATCHES):
            if not torch.equal(emb_k[b].view(torch.int32),
                               emb_p[b].view(torch.int32)):
                _fail(f"scoring batch {b}: embeddings differ from the run "
                      "with the plain version")
        diff = max(float(np.abs(a - b).max()) for a, b in zip(scores, scores_p))
        if diff == 0.0 and all(np.array_equal(a.view(np.int32), b.view(np.int32))
                               for a, b in zip(scores, scores_p)):
            print("scoring == the run with the signature-embedding plain "
                  "version: embeddings and scores bit for bit", flush=True)
        else:
            scoring._embed = recording_embed
            scores_k2, _, _, _ = serve_all()
            rerun = max(float(np.abs(a - b).max())
                        for a, b in zip(scores, scores_k2))
            print(f"scoring vs the plain-version run: embeddings bit for "
                  f"bit, scores max |diff| {diff:.3e}; the kernel path's own "
                  f"run-to-run max |diff| {rerun:.3e}", flush=True)
            if diff > rerun:
                _fail("scores differ from the plain-version run by more than "
                      "the kernel path's own run-to-run difference")
        scoring._embed = kernel_embed
        trace_scoring(scoring, batches[0])
    del embs, emb_k, emb_p, scoring, model
    torch.cuda.empty_cache()
    kernels.reset_launches()
    out = serve.main([])
    if out["requests"] < 512 or out.get("p50_ms", 0) <= 0:
        _fail(f"repro_torch.launch.serve.main on the card: {out}")


def _print_b6_share(dev, busy_ms) -> None:
    """Flash attention's (B6's) device time in a trace and its share of
    the device busy time, by instantiation."""
    import re

    by = {}
    for e in dev:
        m = re.search(r"fa_(wgmma|mma16|simt|wide)_kernel", e.key)
        if m:
            ms, n = by.get(m.group(1), (0.0, 0))
            by[m.group(1)] = (ms + e.self_device_time_total / 1e3, n + e.count)
    if not by:
        return
    total = sum(ms for ms, _ in by.values())
    print(f"  B6 (flash attention): {total:.4f} ms device time = "
          f"{total / busy_ms:.4f} of device busy ("
          + ", ".join(f"{v} {ms:.4f} ms x{n}" for v, (ms, n) in sorted(by.items()))
          + ")", flush=True)


def _print_b7_share(dev, busy_ms) -> None:
    """The WKV6 kernel's (B7's) device time in a trace and its share of
    the device busy time, by instantiation; and the device copies in the
    trace (kernels named for a copy; a wrapper that copied B7's inputs
    and output would add five a layer)."""
    import re

    by, copies = {}, [0.0, 0]
    for e in dev:
        m = re.search(r"wkv6_(chunk|step)_kernel", e.key)
        if m:
            ms, n = by.get(m.group(1), (0.0, 0))
            by[m.group(1)] = (ms + e.self_device_time_total / 1e3, n + e.count)
        elif "copy" in e.key.lower():
            copies[0] += e.self_device_time_total / 1e3
            copies[1] += e.count
    if not by:
        return
    total = sum(ms for ms, _ in by.values())
    print(f"  B7 (wkv6): {total:.4f} ms device time = {total / busy_ms:.4f} "
          f"of device busy ("
          + ", ".join(f"{v} {ms:.4f} ms x{n}" for v, (ms, n) in sorted(by.items()))
          + f"); copy kernels in the whole trace: {copies[1]}, "
          f"{copies[0]:.4f} ms", flush=True)


def trace_scoring(scoring, rows) -> None:
    """Profile one scoring batch: device busy time, idle share, the largest
    device items."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        scoring.handle(dict(rows))
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    if busy_ms <= 0:
        print("scoring trace: the profiler recorded no device time (device "
              "busy share not measured)", flush=True)
        return
    print(f"scoring trace (profiler on): batch wall {wall_ms:.3f} ms, "
          f"{sum(e.count for e in dev)} device kernels, device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}",
          flush=True)
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  device {e.self_device_time_total / 1e3:.4f} ms "
              f"x{e.count} {e.key[:90]}", flush=True)
    _print_b6_share(dev, busy_ms)


def _wkv6_cost(shape, with_s0):
    """(bytes, FLOP) one WKV6 call must move and compute: r, k, v, lw read
    and y written once, u, s0 (when given) and the final state; per
    (b, h) and row the chunk products r~ S and k~ᵀ v (2 D² multiply-adds)
    and A = r~ k~ᵀ and A v (2 x 16 D)."""
    B, H, T, D = shape
    nbytes = 4 * (5 * B * H * T * D + H * D + (2 if with_s0 else 1) * B * H * D * D)
    flop = 2 * B * H * T * (2 * D * D + 2 * 16 * D)
    return nbytes, flop


def _wkv6_inputs(gen, shape, lw_edge=None, layout="bthd"):
    """(r, k, v, lw, u, s0) float32 on the card, scaled as the reference's
    kernel tests scale them; r, k, v, lw as the model hands them over --
    (B, T, H, D) tensors viewed as (B, H, T, D) -- or, ``layout="bhtd"``,
    contiguous; ``lw_edge`` as in ``check_wkv6_kernel``."""
    B, H, T, D = shape
    dev = torch.device("cuda")

    def randn(*s):
        return torch.randn(s, generator=gen, device=dev)

    made = (B, T, H, D) if layout == "bthd" else shape
    r, k, v = randn(*made) * 0.5, randn(*made) * 0.5, randn(*made)
    lw = -torch.exp(randn(*made) - 1.0)
    if layout == "bthd":
        r, k, v, lw = (x.transpose(1, 2) for x in (r, k, v, lw))
    if lw_edge == "lw > 0":
        lw[..., ::3] = torch.rand(lw[..., ::3].shape, generator=gen, device=dev) * 2
    elif lw_edge == "lw < -3.5":
        lw[..., 1::3] = -3.6 - 16 * torch.rand(lw[..., 1::3].shape,
                                               generator=gen, device=dev)
    elif lw_edge == "lw = 0":
        lw.zero_()
    elif lw_edge == "a chunk at -3.5 (e^56)":
        lw[:, :, 16:32] = -3.5
    return r, k, v, lw, randn(H, D) * 0.3, randn(B, H, D, D) * 0.1


def _graph_time_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` calls captured in one CUDA
    graph and replayed: the kernels back to back, without the host's
    launch overhead."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    ms = _time_ms(graph.replay, 3) / reps
    del graph
    return ms


def check_wkv6_kernel(results) -> None:
    """The WKV6 kernel against its chunked plain version and the
    recurrence -- at the model's shapes and layout, every head dim, both
    instantiations -- then timed at the prefill and decode shapes as the
    model calls them."""
    from repro_torch import kernels
    from repro_torch.kernels.wkv6.ops import (
        launch_wkv6, plan_wkv6, wkv6, wkv6_chunked,
    )
    from repro_torch.kernels.wkv6.ref import wkv6_ref

    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    H = 40
    main = (RWKV_BATCH, H, RWKV_PROMPT, 64)
    decode = (RWKV_BATCH, H, 1, 64)
    cases = [("prefill", main, True, None, "bthd"),
             ("decode step", decode, True, None, "bthd"),
             ("decode step, zero state", decode, False, None, "bthd"),
             ("T=15", (RWKV_BATCH, H, 15, 64), True, None, "bthd"),
             ("T=100, contiguous", (1, 2, 100, 64), True, None, "bhtd")]
    cases += [(e, (2, H, 48, 64), True, e, "bthd") for e in (
        "lw > 0", "lw < -3.5", "lw = 0", "a chunk at -3.5 (e^56)")]
    cases += [(f"D={D}, T={T}", (2, 8, T, D), True, None, "bthd")
              for D in WKV_CHECK_DIMS for T in WKV_CHECK_LENGTHS]
    cases += [(f"D={D}, T={T} (wide)", (2, 4, T, D), True, None, "bthd")
              for D in WKV_WIDE_DIMS for T in WKV_WIDE_LENGTHS]
    worst = 0.0
    for name, shape, with_s0, edge, layout in cases:
        r, k, v, lw, u, s0 = _wkv6_inputs(gen, shape, edge, layout)
        s0 = s0 if with_s0 else None
        plan = plan_wkv6(r, k, v, lw)
        D = shape[3]
        want = ("wide" if D > 256 else "step" if shape[2] < 16 else "chunk")
        if plan.variant != want or (
                any(plan.copy) != (D <= 256 and D not in (16, 32, 64, 128, 256))):
            _fail(f"wkv6 on '{name}' {shape}: plan {plan}")
        kernels.reset_launches()
        y, s = wkv6(r, k, v, lw, u, s0)
        if kernels.VARIANT_LAUNCHES["wkv6"][plan.variant] != 1:
            _fail(f"wkv6 on '{name}': the {plan.variant} instantiation was "
                  f"not launched ({kernels.VARIANT_LAUNCHES['wkv6']})")
        yc, sc = wkv6_chunked(r, k, v, lw, u, s0)
        torch.cuda.synchronize()
        err = max(float((y - yc).abs().max()), float((s - sc).abs().max()))
        tol = WKV_TOL["chunked"]
        if not (torch.allclose(y, yc, rtol=tol, atol=tol)
                and torch.allclose(s, sc, rtol=tol, atol=tol)):
            _fail(f"wkv6 differs from its chunked plain version on '{name}' "
                  f"{shape} (max |diff| {err:.3e}, tolerance {tol})")
        worst = max(worst, err)
        # the recurrence on every case, on a slice of the large ones
        sl = slice(0, 4)
        yr, sr = wkv6_ref(r[:1, sl], k[:1, sl], v[:1, sl], lw[:1, sl], u[sl],
                          None if s0 is None else s0[:1, sl])
        ref_err = max(float((y[:1, sl] - yr).abs().max()),
                      float((s[:1, sl] - sr).abs().max()))
        tol_r = WKV_TOL["recurrence"]
        if not (torch.allclose(y[:1, sl], yr, rtol=tol_r, atol=tol_r)
                and torch.allclose(s[:1, sl], sr, rtol=tol_r, atol=tol_r)):
            _fail(f"wkv6 differs from the recurrence on '{name}' {shape} "
                  f"(max |diff| {ref_err:.3e})")
        print(f"wkv6 ({plan.variant}, {layout}, copies {plan.copy}) on "
              f"'{name}' {shape}: max |diff| {err:.3e} to the chunked plain "
              f"version (atol = rtol = {tol}), {ref_err:.3e} to the "
              f"recurrence on (1, 4) heads (atol = rtol = {tol_r})",
              flush=True)
        del r, k, v, lw, u, s0, y, s, yc, sc, yr, sr

    timed = {}
    for label, shape in (("prefill", main), ("decode", decode)):
        r, k, v, lw, u, s0 = _wkv6_inputs(gen, shape)   # the model's views
        y = torch.empty_like(r)
        s = torch.empty_like(s0)
        reps = 20 if label == "prefill" else 200
        kernel_ms = _time_ms(lambda: launch_wkv6(r, k, v, lw, u, s0, y, s),
                             reps, 3)
        graph_ms = _graph_time_ms(
            lambda: launch_wkv6(r, k, v, lw, u, s0, y, s), reps)
        wrapper_ms = _time_ms(lambda: wkv6(r, k, v, lw, u, s0), reps, 3)
        plain_ms = _time_ms(lambda: wkv6_chunked(r, k, v, lw, u, s0), 3)
        nbytes, flop = _wkv6_cost(shape, True)
        by_bytes, by_ops = 1e3 * nbytes / HBM_BYTES_PER_S, 1e3 * flop / FP32_FLOP_PER_S
        # eager launches, as the model issues them (at decode the host's
        # launch overhead is most of it); in a CUDA graph, the kernel alone
        timed[label] = dict(ms=kernel_ms, graph_ms=graph_ms,
                            wrapper_ms=wrapper_ms,
                            plain_ms=plain_ms, bound_ms=max(by_bytes, by_ops),
                            bound_by="bytes" if by_bytes >= by_ops else "operations",
                            bytes=nbytes, flop=flop)
        print(f"wkv6 {label} {shape} on the model's (B, T, H, D) views: "
              f"kernel {kernel_ms:.4f} ms eager (in a CUDA graph "
              f"{graph_ms:.4f} ms; the wrapper wkv6() {wrapper_ms:.4f} ms), "
              f"chunked plain {plain_ms:.4f} ms, bound "
              f"{max(by_bytes, by_ops):.5f} ms ({nbytes} bytes -> "
              f"{by_bytes:.5f} ms; {flop} FLOP -> {by_ops:.5f} ms; "
              f"{max(by_bytes, by_ops) / kernel_ms:.3f} of the bound eager, "
              f"{max(by_bytes, by_ops) / graph_ms:.3f} in the graph)",
              flush=True)
        del r, k, v, lw, u, s0, y, s
    # "wide" (D > 256, off every model's path): its time beside the
    # chunked plain version's
    r, k, v, lw, u, s0 = _wkv6_inputs(gen, WKV_WIDE_TIMED)
    y, s = torch.empty_like(r), torch.empty_like(s0)
    wide_ms = _time_ms(lambda: launch_wkv6(r, k, v, lw, u, s0, y, s), 3)
    wide_plain_ms = _time_ms(lambda: wkv6_chunked(r, k, v, lw, u, s0), 3)
    nbytes, flop = _wkv6_cost(WKV_WIDE_TIMED, True)
    wide_bound = 1e3 * max(nbytes / HBM_BYTES_PER_S, flop / FP32_FLOP_PER_S)
    print(f"wkv6 wide {WKV_WIDE_TIMED}: kernel {wide_ms:.4f} ms, chunked "
          f"plain {wide_plain_ms:.4f} ms, bound {wide_bound:.5f} ms",
          flush=True)
    del r, k, v, lw, u, s0, y, s
    pre, dec = timed["prefill"], timed["decode"]
    results["wkv6"] = dict(
        max_abs_err=worst, **pre,
        decode_ms=dec["ms"], decode_graph_ms=dec["graph_ms"],
        decode_wrapper_ms=dec["wrapper_ms"], decode_plain_ms=dec["plain_ms"],
        decode_bound_ms=dec["bound_ms"],
        wide_ms=wide_ms, wide_plain_ms=wide_plain_ms, wide_bound_ms=wide_bound,
        shape=f"{main} prefill with s0 on the model's views (decode "
              f"{decode}: kernel {dec['ms']:.4f} ms eager, "
              f"{dec['graph_ms']:.4f} ms in a CUDA graph, bound "
              f"{dec['bound_ms']:.5f} ms; wide {WKV_WIDE_TIMED}: "
              f"{wide_ms:.4f} ms)",
    )
    torch.cuda.empty_cache()


def _bf16_close(got, want):
    """(max |diff|, allowed): allowed is ``LM_BF16_STEPS`` bf16 steps of
    ``want``'s largest value."""
    got, want = got.float(), want.float()
    allowed = LM_BF16_STEPS * 2.0 ** -8 * float(want.abs().max())
    return float((got - want).abs().max()), allowed


def rwkv6_path(results) -> None:
    """rwkv6-3b at full width: 8 x 1,024-token prefill, 32 greedy decode
    steps, every WKV6 scan through the kernel; then the checks against
    longer prefills and the chunked-plain run, and one traced prefill and
    decode step."""
    from repro_torch import kernels
    from repro_torch.configs import rwkv6_3b
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = rwkv6_3b.config()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"rwkv6 model {cfg.name}: {cfg.n_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.n_heads} heads of {cfg.hd}, d_ff {cfg.d_ff}, "
          f"vocab {cfg.vocab}, {cfg.param_dtype}; {n_params} parameters "
          f"({wbytes / 1e9:.2f} GB) drawn in {time.perf_counter() - t0:.1f} s",
          flush=True)
    if n_params != RWKV_PARAMS:
        _fail(f"rwkv6-3b has {n_params} parameters, expected {RWKV_PARAMS}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 8)
    prompts = torch.randint(0, cfg.vocab, (RWKV_BATCH, RWKV_PROMPT),
                            generator=gen, device="cuda", dtype=torch.int32)

    # warm-up at the same shapes: cuBLAS heuristics, the allocator
    _, st = model.prefill({"tokens": prompts})
    model.decode_step(st, prompts[:, :1])
    del st
    _b7_copies_check(model, prompts)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launches()
    t0 = time.perf_counter()
    logits, state = model.prefill({"tokens": prompts})
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    prefill_logits, prefill_wkv = logits, state["wkv"]
    finite = torch.isfinite(logits).all()
    tok = logits[:, -1, :cfg.vocab].argmax(-1, keepdim=True).to(torch.int32)
    generated, step_ms, step_logits = [tok], [], []
    for _ in range(RWKV_DECODE):
        t1 = time.perf_counter()
        lg, state = model.decode_step(state, tok)
        tok = lg[:, -1, :cfg.vocab].argmax(-1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t1))
        finite &= torch.isfinite(lg).all()
        generated.append(tok)
        step_logits.append(lg)
    launches = kernels.LAUNCHES["wkv6"]
    peak = torch.cuda.max_memory_allocated()
    want = cfg.n_layers * (1 + RWKV_DECODE)
    if launches != want:
        _fail(f"the RWKV6 path launched the WKV6 kernel {launches} times, "
              f"expected {want} (one per layer per call)")
    results["wkv6"]["launches"] = launches
    if not bool(finite):
        _fail("rwkv6: non-finite logits")
    pos = state["pos"].cpu()
    if not bool((pos == RWKV_PROMPT + RWKV_DECODE).all()):
        _fail(f"rwkv6: pos {pos.tolist()} after {RWKV_DECODE} steps")
    ms = np.array(step_ms)
    n_tok = RWKV_BATCH * RWKV_PROMPT
    print(f"rwkv6 prefill {RWKV_BATCH} x {RWKV_PROMPT} tokens: {prefill_s:.3f} "
          f"s fenced = {n_tok / prefill_s:.0f} tokens/s; decode {RWKV_DECODE} "
          f"steps x {RWKV_BATCH}: p50 {np.percentile(ms, 50):.3f} ms, p99 "
          f"{np.percentile(ms, 99):.3f} ms = "
          f"{RWKV_BATCH / np.percentile(ms, 50) * 1e3:.1f} tokens/s at p50; "
          f"wkv6 launches {launches} (= {cfg.n_layers} layers x "
          f"{1 + RWKV_DECODE} calls); peak device memory {peak / 1e9:.2f} GB "
          f"({(peak - base) / 1e9:.2f} GB above the {base / 1e9:.2f} GB "
          f"held before, {wbytes / 1e9:.2f} GB of it weights); logits "
          f"finite, pos {int(pos[0])}",
          flush=True)
    seq = torch.cat([prompts] + generated, dim=1)
    # bf16 decode against prefill over the longer prompt: the two round the
    # residual stream at different places (GEMMs of other shapes), and the
    # gap grows with depth in the JAX package too; checked at the depth
    # where the reference was measured (rwkv6_bf16_gap_check), printed here
    for steps in LM_CHECK_STEPS:
        ref, _ = model.prefill({"tokens": seq[:, :RWKV_PROMPT + steps]})
        err, allowed = _bf16_close(step_logits[steps - 1], ref)
        print(f"rwkv6 bf16 decode after {steps} step(s) vs prefill over "
              f"{RWKV_PROMPT + steps} tokens: logits max |diff| {err:.4f} = "
              f"{err / allowed * LM_BF16_STEPS:.2f} bf16 steps of max "
              f"|logit| ({cfg.n_layers} layers; checked at "
              f"{RWKV_GAP_LAYERS} below)", flush=True)
        del ref
    plain_logits, plain_state = _prefill_plain(model, prompts)
    rec_logits, rec_state = _prefill_plain(model, prompts, recurrence=True)
    for name, got, ref, rec in (
            ("prefill logits", prefill_logits, plain_logits, rec_logits),
            ("final wkv states", prefill_wkv, plain_state["wkv"],
             rec_state["wkv"])):
        err, steps8 = _bf16_close(got, ref)
        step = steps8 / LM_BF16_STEPS
        spread = _bf16_close(rec, ref)[0]
        if err > RWKV_SCAN_STEPS * step:
            _fail(f"rwkv6 {name} differ from the chunked-plain run by "
                  f"{err / step:.2f} bf16 steps, allowed {RWKV_SCAN_STEPS} "
                  f"(the recurrence-plain run by {spread / step:.2f})")
        print(f"rwkv6 bf16 {name}: the kernel run vs the chunked-plain run "
              f"{err / step:.2f} bf16 steps of the largest value (allowed "
              f"{RWKV_SCAN_STEPS}); the recurrence-plain run vs the "
              f"chunked-plain run {spread / step:.2f}, the kernel run vs the "
              f"recurrence-plain run {_bf16_close(got, rec)[0] / step:.2f}",
              flush=True)
    del plain_logits, plain_state, rec_logits, rec_state, step_logits
    trace_lm("rwkv6", lambda: model.prefill({"tokens": prompts}),
             lambda: model.decode_step(state, tok))
    del model, state, logits, prefill_logits, prefill_wkv
    torch.cuda.empty_cache()
    rwkv6_bf16_gap_check(cfg)
    rwkv6_float32_checks(cfg, prompts, seq)


def _b7_copies_check(model, prompts) -> None:
    """One prefill and one decode step with a spy on B7's entry point:
    every call must hand the kernel the model's (B, S, H, 64) projections
    as they are (no copy planned, the launched pointers the given ones) and
    take y back as a view whose (B, S, H, 64) order is contiguous."""
    from repro_torch.kernels.wkv6 import ops as wkv_ops
    from repro_torch.models import rwkv6 as rwkv_mod

    seen = {"calls": 0, "copied": 0, "y not in place": 0}
    real_wkv6, real_launch = rwkv_mod.wkv6, wkv_ops.launch_wkv6
    given = []

    def spy(r, k, v, lw, u, s0=None):
        seen["calls"] += 1
        given[:] = [x.data_ptr() for x in (r, k, v, lw)]
        y, s = real_wkv6(r, k, v, lw, u, s0)
        seen["y not in place"] += not y.transpose(1, 2).is_contiguous()
        return y, s

    def launch_spy(r, k, v, lw, *rest):
        seen["copied"] += [x.data_ptr() for x in (r, k, v, lw)] != given
        return real_launch(r, k, v, lw, *rest)

    rwkv_mod.wkv6, wkv_ops.launch_wkv6 = spy, launch_spy
    try:
        _, st = model.prefill({"tokens": prompts})
        model.decode_step(st, prompts[:, :1])
        torch.cuda.synchronize()
    finally:
        rwkv_mod.wkv6, wkv_ops.launch_wkv6 = real_wkv6, real_launch
    if seen["calls"] != 2 * model.cfg.n_layers or seen["copied"] or seen[
            "y not in place"]:
        _fail(f"B7 on the RWKV6 path copied its inputs or output: {seen}")
    print(f"rwkv6: B7 took the model's (B, S, H, 64) views uncopied in all "
          f"{seen['calls']} calls of a prefill and a decode step, y back in "
          f"place ({seen})", flush=True)


def rwkv6_bf16_gap_check(cfg) -> None:
    """rwkv6-3b in bf16 at full width, ``RWKV_GAP_LAYERS`` layers, a batch
    of ``RWKV_GAP_BATCH`` prompts (a shape the JAX package was measured
    at): decode after 1 and 8 steps against prefill over the longer
    prompt, the largest per-sequence gap within ``RWKV_GAP_MARGIN`` times
    the reference's largest (``RWKV_REF_GAP``)."""
    from repro_torch.models import build_model

    model = build_model(cfg.replace(n_layers=RWKV_GAP_LAYERS), seed=SEED,
                        device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
    T = RWKV_GAP_PROMPT
    seq = torch.randint(0, cfg.vocab, (RWKV_GAP_BATCH, T + max(LM_CHECK_STEPS)),
                        generator=gen, device="cuda", dtype=torch.int32)
    _, state = model.prefill({"tokens": seq[:, :T]})
    decoded = []
    for i in range(max(LM_CHECK_STEPS)):
        lg, state = model.decode_step(state, seq[:, T + i:T + i + 1])
        decoded.append(lg[:, -1].float())
    for steps in LM_CHECK_STEPS:
        ref, _ = model.prefill({"tokens": seq[:, :T + steps]})
        ref = ref[:, -1].float()
        gaps = ((decoded[steps - 1] - ref).abs().amax(-1)
                / (2.0 ** -8 * ref.abs().amax(-1))).tolist()
        allowed = RWKV_GAP_MARGIN * RWKV_REF_GAP
        if max(gaps) > allowed:
            _fail(f"rwkv6 bf16 ({RWKV_GAP_LAYERS} layers) decode after "
                  f"{steps} step(s) is up to {max(gaps):.2f} bf16 steps from "
                  f"prefill over the longer prompt; the JAX package's own "
                  f"gap is up to {RWKV_REF_GAP:.2f}, allowed {allowed:.2f}")
        print(f"rwkv6 bf16 ({RWKV_GAP_LAYERS} layers, {RWKV_GAP_BATCH} x {T} "
              f"tokens) decode after {steps} step(s) vs prefill over "
              f"{T + steps} tokens: {', '.join(f'{g:.2f}' for g in gaps)} "
              f"bf16 steps of max |logit| (the JAX package's own gap up to "
              f"{RWKV_REF_GAP:.2f}, allowed {allowed:.2f})", flush=True)
    del model, state, decoded
    torch.cuda.empty_cache()


def _prefill_plain(model, prompts, recurrence=False):
    """``model.prefill`` with the WKV6 kernel's chunked plain version (or,
    ``recurrence``, the recurrence ``wkv6_ref``) swapped in; fails if the
    kernel launched."""
    from repro_torch import kernels
    from repro_torch.kernels.wkv6.ops import wkv6_chunked
    from repro_torch.kernels.wkv6.ref import wkv6_ref
    from repro_torch.models import rwkv6 as rwkv_mod

    plain = wkv6_ref if recurrence else wkv6_chunked

    def wkv6_plain(r, k, v, lw, u, s0=None):
        return plain(r, k, v, lw, u, s0)

    kernel_wkv6 = rwkv_mod.wkv6
    rwkv_mod.wkv6 = wkv6_plain
    try:
        before = kernels.LAUNCHES["wkv6"]
        out = model.prefill({"tokens": prompts})
        torch.cuda.synchronize()
        if kernels.LAUNCHES["wkv6"] != before:
            _fail("the chunked-plain run launched the kernel")
    finally:
        rwkv_mod.wkv6 = kernel_wkv6
    return out


def rwkv6_float32_checks(cfg, prompts, seq) -> None:
    """rwkv6-3b at full width in float32 (weights from the same seed, the
    shift mixes, bonus and base decay randomized): decode after prefill
    against prefill over the longer prompt, and the kernel run against the
    chunked-plain run, at ``LM_F32_TOL``."""
    from repro_torch.models import build_model

    cfg32 = cfg.replace(param_dtype="float32", compute_dtype="float32")
    model = build_model(cfg32, seed=SEED, device="cuda")
    # the reference's init zeros the shift mixes and the bonus (with u = 0
    # the kernel and the chunked plain version agree bit for bit on the
    # H100): seeded random values drive the token shift and the bonus here
    gen = torch.Generator(device="cuda").manual_seed(SEED + 10)
    with torch.no_grad():
        for lp in model.layers:
            for mu in (lp["tm"]["mu"], lp["cm"]["mu"]):
                mu.copy_(torch.rand(mu.shape, generator=gen, device="cuda"))
            u, w0 = lp["tm"]["u"], lp["tm"]["w0"]
            u.copy_(0.5 * torch.randn(u.shape, generator=gen, device="cuda"))
            w0.copy_(torch.randn(w0.shape, generator=gen, device="cuda") - 0.5)
    logits, state = model.prefill({"tokens": prompts})
    wkv0 = state["wkv"]
    step_logits = []
    for i in range(max(LM_CHECK_STEPS)):
        lg, state = model.decode_step(
            state, seq[:, RWKV_PROMPT + i:RWKV_PROMPT + i + 1])
        step_logits.append(lg)
    checks = []
    for steps in LM_CHECK_STEPS:
        ref, _ = model.prefill({"tokens": seq[:, :RWKV_PROMPT + steps]})
        checks.append((f"decode after {steps} step(s) vs prefill over "
                       f"{RWKV_PROMPT + steps} tokens: logits",
                       step_logits[steps - 1], ref))
    plain_logits, plain_state = _prefill_plain(model, prompts)
    checks += [("prefill logits vs the chunked-plain run", logits, plain_logits),
               ("final wkv states vs the chunked-plain run", wkv0,
                plain_state["wkv"])]
    for name, got, ref in checks:
        err = float((got - ref).abs().max())
        if not torch.allclose(got, ref, rtol=LM_F32_TOL, atol=LM_F32_TOL):
            _fail(f"rwkv6 float32 {name}: max |diff| {err:.3e} outside "
                  f"atol = rtol = {LM_F32_TOL}")
        print(f"rwkv6 float32 {name}: max |diff| {err:.3e} (atol = rtol = "
              f"{LM_F32_TOL}; largest value {float(ref.abs().max()):.3f})",
              flush=True)
    del model, state, logits, wkv0, step_logits, checks, plain_logits, plain_state
    torch.cuda.empty_cache()


def trace_lm(name, prefill, decode) -> None:
    """Profile one prefill and one decode step (``prefill()`` and
    ``decode()``): device kernels, busy time, idle share, the largest
    device items."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for label, fn in (("prefill", prefill), ("decode step", decode)):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
        if busy_ms <= 0:
            print(f"{name} {label} trace: the profiler recorded no device time "
                  "(device busy share not measured)", flush=True)
            continue
        print(f"{name} {label} trace (profiler on): wall {wall_ms:.3f} ms, "
              f"{sum(e.count for e in dev)} device kernels, device busy "
              f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}",
              flush=True)
        for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:8]:
            print(f"  device {e.self_device_time_total / 1e3:.4f} ms "
                  f"x{e.count} {e.key[:90]}", flush=True)
        _print_b6_share(dev, busy_ms)
        _print_b7_share(dev, busy_ms)


def _fa_cost(shape, esize):
    """(bytes, FLOP) one attention call must move and compute: q, k, v read
    and o written once; 4 D FLOP (q·k and p·v) per visible (q, k) pair of
    every head, counted from the causal limit and the window."""
    B, H, Hkv, S, D, causal, window = shape
    q = np.arange(S, dtype=np.int64)
    hi = q if causal else np.full(S, S - 1)
    lo = np.maximum(q - window + 1, 0) if window is not None else np.zeros(S, np.int64)
    pairs = int(np.maximum(hi - lo + 1, 0).sum())
    nbytes = esize * S * D * B * (2 * H + 2 * Hkv)
    return nbytes, 4 * B * H * D * pairs


def _fa_inputs(gen, shape, dtype):
    B, H, Hkv, S, D = shape[:5]
    return [torch.randn((B, h, S, D), generator=gen, device="cuda").to(dtype)
            for h in (H, Hkv, Hkv)]


def _fa_label(mangled: str) -> str:
    """``fa_wgmma_kernel<128>`` from a mangled kernel name."""
    import re

    m = re.search(r"(fa_[a-z0-9]+_kernel)I(13__nv_bfloat16|f)E", mangled)
    if m is not None:  # fa_wide_kernel<float> / <bf16>
        return f"{m.group(1)}<{'float' if m.group(2) == 'f' else 'bf16'}>"
    m = re.search(r"(fa_[a-z0-9]+_kernel)I((?:Li\d+E)+)E", mangled)
    if m is None:
        return mangled
    return f"{m.group(1)}<{', '.join(re.findall(r'Li(\d+)E', m.group(2)))}>"


def flash_attention_build_report() -> dict:
    """Per instantiation of B6: registers and spills (``ptxas -v``), and
    its ``HGMMA`` / ``HMMA`` instruction counts (``cuobjdump -sass`` on the
    built library).  Fails if a bf16 instantiation has no tensor-core
    instruction."""
    import re
    import shutil

    from repro_torch.kernels import build

    path = build.build(["flash_attention"])["flash_attention"]
    report, fn = {}, None
    for ln in build.BUILD_LOGS.get("flash_attention", "").splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            fn = _fa_label(m.group(1))
            report[fn] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and fn:
            report[fn]["spills"] = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn:
            report[fn]["registers"] = int(m.group(1))
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                          text=True, timeout=300, check=True).stdout
    fn = None
    for ln in sass.splitlines():
        m = re.search(r"Function : (\S+)", ln)
        if m:
            fn = _fa_label(m.group(1))
            report.setdefault(fn, {}).update(HGMMA=0, HMMA=0)
        elif fn:
            for op in ("HGMMA", "HMMA"):
                if re.search(rf"\b{op}\.", ln):
                    report[fn][op] += 1
    if not build.BUILD_LOGS:
        print("  (the library was already built: no ptxas report)", flush=True)
    for fn, r in sorted(report.items()):
        print(f"  flash_attention {fn}: {r.get('registers', '?')} registers, "
              f"spill stores / loads {r.get('spills', '?')} bytes, SASS "
              f"HGMMA {r.get('HGMMA', 0)}, HMMA {r.get('HMMA', 0)}", flush=True)
        for kernel, ops in FA_TENSOR_CORE_OPS.items():
            if fn.startswith(kernel) and not any(r.get(op) for op in ops):
                _fail(f"flash attention's bf16 instantiation {fn} has no "
                      f"{' / '.join(ops)} instruction in its SASS")
    for kernel in FA_TENSOR_CORE_OPS:
        if not any(fn.startswith(kernel) for fn in report):
            _fail(f"no {kernel} instantiation in the built library")
    return report


def _fa_library_call(q, k, v, shape):
    """One ``F.scaled_dot_product_attention`` call for the same function
    (a boolean mask for a window); timed only, the port never calls it."""
    import torch.nn.functional as F

    S, causal, window = shape[3], shape[5], shape[6]
    if window is None:
        return lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=causal, enable_gqa=True)
    pos = torch.arange(S, device="cuda")
    mask = pos[None, :] > pos[:, None] - window
    if causal:
        mask &= pos[None, :] <= pos[:, None]
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask,
                                                  enable_gqa=True)


def check_flash_attention_kernel(results) -> None:
    """Flash attention (B6): the build report of its instantiations; the
    kernel against ``attention_ref`` on the reference's test shapes and
    the paths' shapes; every path shape timed beside the plain version and
    SDPA; both bf16 instantiations timed at short sequences (the dispatch
    threshold); float32 timed at nemotron's shape."""
    from repro_torch import kernels
    from repro_torch.kernels.flash_attention.ops import (
        SHORT_SEQ_MAX, attention, launch_flash_attention, plan_attention,
    )
    from repro_torch.kernels.flash_attention.ref import attention_ref

    flash_attention_build_report()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 11)
    cases = [(f"test {sh[:5]}", sh, dt) for dt in (torch.float32, torch.bfloat16)
             for sh in FA_TEST_SHAPES]
    cases += [(f"wide {sh[:5]}", sh, dt) for dt in (torch.float32, torch.bfloat16)
              for sh in FA_WIDE_SHAPES]
    cases += [(name, sh, torch.bfloat16) for name, sh in FA_PATH_SHAPES.items()]
    worst = {}
    for name, shape, dtype in cases:
        causal, window = shape[5:]
        q, k, v = _fa_inputs(gen, shape, dtype)
        kernels.reset_launches()
        out = attention(q, k, v, causal=causal, window=window)
        variant = plan_attention(q, k, v).variant
        if kernels.VARIANT_LAUNCHES["flash_attention"][variant] != 1:
            _fail(f"flash attention on {name}: the {variant} instantiation "
                  f"was not launched ({kernels.VARIANT_LAUNCHES})")
        want = attention_ref(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        tol = FA_TOL[dtype]
        if not torch.allclose(out.float(), want.float(), atol=tol, rtol=tol):
            _fail(f"flash attention differs from its plain version on {name} "
                  f"{shape} {dtype} (max |diff| {err:.3e}, tolerance {tol})")
        worst[dtype] = max(worst.get(dtype, 0.0), err)
        print(f"flash_attention == attention_ref on {name} {shape} {dtype} "
              f"({variant}): max |diff| {err:.3e} (atol = rtol = {tol})",
              flush=True)
        del q, k, v, out, want
    torch.cuda.empty_cache()

    timed = {}
    for name in FA_TIMED:
        shape = FA_PATH_SHAPES[name]
        B, H, Hkv, S, D, causal, window = shape
        q, k, v = _fa_inputs(gen, shape, torch.bfloat16)
        variant = plan_attention(q, k, v).variant
        kernel_ms = _time_ms(lambda: attention(q, k, v, causal=causal,
                                               window=window), 10, 2)
        plain_ms = _time_ms(lambda: attention_ref(q, k, v, causal=causal,
                                                  window=window), 3)
        library_ms = _time_ms(_fa_library_call(q, k, v, shape), 10, 2)
        nbytes, flop = _fa_cost(shape, 2)
        by_bytes = 1e3 * nbytes / HBM_BYTES_PER_S
        by_ops = 1e3 * flop / BF16_FLOP_PER_S
        timed[name] = dict(ms=kernel_ms, plain_ms=plain_ms,
                           library_ms=library_ms,
                           bound_ms=max(by_bytes, by_ops),
                           bound_by="bytes" if by_bytes >= by_ops else "operations",
                           variant=variant)
        print(f"flash_attention {name} {shape} bf16 ({variant}): kernel "
              f"{kernel_ms:.4f} ms, plain {plain_ms:.4f} ms, SDPA "
              f"{library_ms:.4f} ms, bound {max(by_bytes, by_ops):.5f} ms "
              f"({nbytes} bytes -> {by_bytes:.5f} ms; {flop} FLOP -> "
              f"{by_ops:.5f} ms; kernel at {flop / kernel_ms / 1e9:.1f} "
              f"TFLOP/s, {nbytes / kernel_ms / 1e6:.1f} GB/s; "
              f"{max(by_bytes, by_ops) / kernel_ms:.3f} of the bound)",
              flush=True)
        del q, k, v
        torch.cuda.empty_cache()

    # the threshold between the bf16 instantiations, measured
    for name, shape in FA_THRESHOLD_SHAPES.items():
        B, H, Hkv, S, D, causal, window = shape
        q, k, v = _fa_inputs(gen, shape, torch.bfloat16)
        o = torch.empty_like(q)
        short = plan_attention(q, k, v)
        long_ = dataclasses.replace(short, variant="wgmma",
                                    grid=(B * H, -(-S // 128)), threads=384)
        ms = {}
        for plan in (short, long_):
            ms[plan.variant] = _time_ms(lambda: launch_flash_attention(
                q, k, v, o, causal=causal, window=window,
                scale=D ** -0.5, plan=plan), 10, 2)
            want = attention_ref(q, k, v, causal=causal, window=window)
            if not torch.allclose(o.float(), want.float(), atol=3e-2, rtol=3e-2):
                _fail(f"flash attention's {plan.variant} instantiation "
                      f"differs from its plain version at {shape}")
        print(f"flash_attention dispatch threshold at {name} {shape}: mma16 "
              f"{ms['mma16']:.4f} ms, wgmma {ms['wgmma']:.4f} ms (bf16 "
              f"S <= {SHORT_SEQ_MAX} takes mma16)", flush=True)
        del q, k, v, o
    torch.cuda.empty_cache()

    # float32 (the checks' dtype) at nemotron's shape, on the CUDA cores
    shape = FA_PATH_SHAPES["nemotron"]
    q, k, v = _fa_inputs(gen, shape, torch.float32)
    f32_ms = _time_ms(lambda: attention(q, k, v), 3, 1)
    print(f"flash_attention nemotron {shape} float32 (simt): kernel "
          f"{f32_ms:.4f} ms", flush=True)
    del q, k, v
    torch.cuda.empty_cache()

    others = "; ".join(
        f"{n} {FA_PATH_SHAPES[n][:5]} window {FA_PATH_SHAPES[n][6]} "
        f"({timed[n]['variant']}): kernel {timed[n]['ms']:.4f} ms, plain "
        f"{timed[n]['plain_ms']:.4f} ms, SDPA {timed[n]['library_ms']:.4f} "
        f"ms, bound {timed[n]['bound_ms']:.5f} ms"
        for n in FA_TIMED[1:])
    main = {k: v for k, v in timed["nemotron"].items() if k != "variant"}
    results["flash_attention"] = dict(
        max_abs_err=worst[torch.bfloat16], max_abs_err_f32=worst[torch.float32],
        **main, f32_ms=f32_ms,
        shape=f"{FA_PATH_SHAPES['nemotron'][:5]} bf16 causal (wgmma; {others})",
        shapes=timed,
    )


def _prefill_plain_attention(model, prompts, **kw):
    """``model.prefill`` with ``gqa_attention`` (the reference model's own
    attention) swapped in for B6; fails if the kernel launched."""
    from repro_torch import kernels
    from repro_torch.models import layers, transformer

    def plain(q, k, v, positions, *, window):
        return layers.gqa_attention(q, k, v, positions, positions,
                                    causal=True, window=window)

    kernel_attention = transformer.causal_self_attention
    transformer.causal_self_attention = plain
    try:
        before = kernels.LAUNCHES["flash_attention"]
        out = model.prefill({"tokens": prompts}, **kw)
        torch.cuda.synchronize()
        if kernels.LAUNCHES["flash_attention"] != before:
            _fail("the plain-attention run launched the kernel")
    finally:
        transformer.causal_self_attention = kernel_attention
    return out


def nemotron_path(results) -> None:
    """nemotron-4-15b at full width and depth: 8 x 2,048-token prefill, 32
    greedy decode steps, every prefill attention through B6; the check
    against the plain-attention run, one traced prefill and decode step;
    then the float32 checks."""
    from repro_torch import kernels
    from repro_torch.configs import nemotron_4_15b
    from repro_torch.models import build_model

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    cfg = nemotron_4_15b.config()
    t0 = time.perf_counter()
    model = build_model(cfg, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    wbytes = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"dense LM {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads over {cfg.n_kv_heads} KV heads of {cfg.hd}, "
          f"{cfg.mlp} d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.param_dtype}; "
          f"{n_params} parameters ({wbytes / 1e9:.2f} GB) drawn in "
          f"{time.perf_counter() - t0:.1f} s; {held / 1e9:.2f} GB held "
          "before the phase", flush=True)
    if n_params != NEMO_PARAMS:
        _fail(f"nemotron-4-15b has {n_params} parameters, expected {NEMO_PARAMS}")
    gen = torch.Generator(device="cuda").manual_seed(SEED + 12)
    prompts = torch.randint(0, cfg.vocab, (NEMO_BATCH, NEMO_PROMPT),
                            generator=gen, device="cuda", dtype=torch.int32)

    # warm-up at the same shapes: cuBLAS heuristics, the allocator
    _, cache = model.prefill({"tokens": prompts}, max_len=NEMO_MAX_LEN)
    model.decode_step(cache, prompts[:, :1])
    del cache
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launches()
    t0 = time.perf_counter()
    logits, cache = model.prefill({"tokens": prompts}, max_len=NEMO_MAX_LEN)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    after_prefill = kernels.LAUNCHES["flash_attention"]
    by_variant = dict(kernels.VARIANT_LAUNCHES["flash_attention"])
    finite = torch.isfinite(logits).all()
    tok = logits[:, -1, :cfg.vocab].argmax(-1, keepdim=True).to(torch.int32)
    generated, step_ms = [tok], []
    for _ in range(NEMO_DECODE):
        t1 = time.perf_counter()
        lg, cache = model.decode_step(cache, tok)
        tok = lg[:, -1, :cfg.vocab].argmax(-1, keepdim=True).to(torch.int32)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t1))
        finite &= torch.isfinite(lg).all()
        generated.append(tok)
    launches = kernels.LAUNCHES["flash_attention"]
    peak = torch.cuda.max_memory_allocated()
    if (after_prefill != cfg.n_layers or launches != cfg.n_layers
            or by_variant["wgmma"] != cfg.n_layers):
        _fail(f"the nemotron path launched flash attention {after_prefill} "
              f"times in prefill ({by_variant}) and "
              f"{launches - after_prefill} in {NEMO_DECODE} decode steps, "
              f"expected {cfg.n_layers} (wgmma) and 0")
    results["flash_attention"]["launches"] = launches
    if not bool(finite):
        _fail("nemotron: non-finite logits")
    pos = cache.pos.cpu()
    if not bool((pos == NEMO_MAX_LEN).all()):
        _fail(f"nemotron: pos {pos.tolist()} after {NEMO_DECODE} steps")
    ms = np.array(step_ms)
    n_tok = NEMO_BATCH * NEMO_PROMPT
    print(f"nemotron prefill {NEMO_BATCH} x {NEMO_PROMPT} tokens: "
          f"{prefill_s:.3f} s fenced = {n_tok / prefill_s:.0f} tokens/s; "
          f"decode {NEMO_DECODE} steps x {NEMO_BATCH}: p50 "
          f"{np.percentile(ms, 50):.3f} ms, p99 {np.percentile(ms, 99):.3f} "
          f"ms = {NEMO_BATCH / np.percentile(ms, 50) * 1e3:.1f} tokens/s at "
          f"p50; flash_attention launches {after_prefill} in prefill "
          f"({by_variant}), "
          f"{launches - after_prefill} in decode; peak device memory "
          f"{peak / 1e9:.2f} GB ({(peak - base) / 1e9:.2f} GB above the "
          f"{base / 1e9:.2f} GB held after the build, {wbytes / 1e9:.2f} GB "
          f"of it weights); logits finite, pos {int(pos[0])}", flush=True)
    seq = torch.cat([prompts] + generated, dim=1)
    few = prompts[:NEMO_PLAIN_BATCH]
    got, _ = model.prefill({"tokens": few})
    want, _ = _prefill_plain_attention(model, few)
    err, allowed = _bf16_close(got, want)
    steps = err / allowed * LM_BF16_STEPS
    if err > allowed:
        _fail(f"nemotron bf16 prefill differs from the plain-attention run "
              f"by {steps:.2f} bf16 steps of the largest logit (max |diff| "
              f"{err:.4f})")
    print(f"nemotron bf16 prefill of {NEMO_PLAIN_BATCH} prompts == the "
          f"gqa_attention run: logits max |diff| {err:.4e} = {steps:.2f} bf16 "
          f"steps of max |logit| {float(want.abs().max()):.3f} (allowed "
          f"{LM_BF16_STEPS})", flush=True)
    del got, want
    trace_lm("nemotron", lambda: model.prefill({"tokens": prompts},
                                               max_len=NEMO_MAX_LEN),
             lambda: model.decode_step(cache, tok))
    del model, cache, logits, lg
    torch.cuda.empty_cache()
    nemotron_float32_checks(cfg, prompts, seq)


def nemotron_float32_checks(cfg, prompts, seq) -> None:
    """nemotron-4-15b at full width, 4 layers, float32: the kernel run
    against the plain-attention run, and decode after prefill against
    prefill over the longer prompt."""
    from repro_torch.models import build_model

    cfg32 = cfg.replace(n_layers=NEMO_F32_LAYERS, param_dtype="float32",
                        compute_dtype="float32")
    model = build_model(cfg32, seed=SEED, device="cuda")
    few = prompts[:NEMO_PLAIN_BATCH]
    got, _ = model.prefill({"tokens": few})
    want, _ = _prefill_plain_attention(model, few)
    err = float((got - want).abs().max())
    allowed = NEMO_F32_REL * float(want.abs().max())
    if err > allowed:
        _fail(f"nemotron float32 prefill differs from the plain-attention run "
              f"(max |diff| {err:.3e} > {allowed:.3e})")
    print(f"nemotron float32 ({NEMO_F32_LAYERS} layers) prefill of "
          f"{NEMO_PLAIN_BATCH} prompts == the gqa_attention run: max |diff| "
          f"{err:.3e} (allowed {allowed:.3e} = {NEMO_F32_REL} of max |logit|)",
          flush=True)
    del got, want
    _, cache = model.prefill({"tokens": prompts}, max_len=NEMO_MAX_LEN)
    step_logits = []
    for i in range(max(LM_CHECK_STEPS)):
        lg, cache = model.decode_step(
            cache, seq[:, NEMO_PROMPT + i:NEMO_PROMPT + i + 1])
        step_logits.append(lg)
    for steps in LM_CHECK_STEPS:
        ref, _ = model.prefill({"tokens": seq[:, :NEMO_PROMPT + steps]})
        got = step_logits[steps - 1]
        err = float((got - ref).abs().max())
        if not torch.allclose(got, ref, rtol=LM_F32_TOL, atol=LM_F32_TOL):
            _fail(f"nemotron float32 decode after {steps} step(s) vs prefill "
                  f"over {NEMO_PROMPT + steps} tokens: max |diff| {err:.3e} "
                  f"outside atol = rtol = {LM_F32_TOL}")
        print(f"nemotron float32 decode after {steps} step(s) vs prefill over "
              f"{NEMO_PROMPT + steps} tokens: logits max |diff| {err:.3e} "
              f"(atol = rtol = {LM_F32_TOL}; largest value "
              f"{float(ref.abs().max()):.3f})", flush=True)
        del ref
    del model, cache, step_logits
    torch.cuda.empty_cache()


def offline_path(results) -> None:
    """The offline export over 2^24 transactions, through the fold-levels
    kernel, and the same export with the kernel's plain version swapped
    in: every feature bit for bit."""
    from repro_torch import kernels
    from repro_torch.core import windows as win
    from repro_torch.core.engine import OfflineEngine
    from repro_torch.data.synthetic import fraud_transactions
    from repro_torch.kernels.window_agg.ref import fold_levels_ref
    from repro_torch.scenarios import fraud_view

    rng = np.random.default_rng(SEED + 3)
    per_day = WARM_SLICES * SLICE_ROWS
    days = [fraud_transactions(rng, per_day, NUM_CARDS, d * DAY, (d + 1) * DAY)
            for d in range(OFFLINE_DAYS)]
    cols = {c: np.concatenate([d[c] for d in days]) for c in days[0]}
    del days
    n = len(cols["card"])
    view = fraud_view()
    engine = OfflineEngine(device="cuda")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    kernels.reset_launches()
    t0 = time.perf_counter()
    engine.compute(view, cols)
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = engine.compute(view, cols)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    # one launch a fold-levels call, at least one call in each export
    if launches["fold_levels"] < 2:
        _fail(f"the offline path did not launch the fold-levels kernel: "
              f"{launches}")
    results["fold_levels"]["launches"] = launches["fold_levels"]
    print(f"offline export, {n} transactions on {NUM_CARDS} cards, "
          f"{len(view.features)} features: cold {cold_s:.3f} s, warm "
          f"{warm_s:.3f} s = {n / warm_s:.0f} rows/s (host columns to "
          f"device included); fold_levels launches {launches['fold_levels']}"
          f" over 2 runs; peak device memory {peak / 1e9:.2f} GB", flush=True)

    amount = torch.as_tensor(cols["amount"], device="cuda")
    for f, v in out.items():
        if v.shape != (n,) or not bool(torch.isfinite(v).all()):
            _fail(f"offline feature {f}: shape {tuple(v.shape)} or non-finite")
    if not bool((out["tx_count_1h"] >= 1).all()):
        _fail("offline: a row's 1 h window must count the row itself")
    if not bool((out["amt_max_6h"] >= amount).all()):
        _fail("offline: a row's 6 h max must be at least its own amount")

    kernel_fold = win.fold_levels

    def fold_levels_plain(x, seg, *, op):
        return fold_levels_ref(x, seg, op)

    win.fold_levels = fold_levels_plain
    try:
        plain = engine.compute(view, cols)
    finally:
        win.fold_levels = kernel_fold
    torch.cuda.synchronize()
    for f in out:
        err = _max_abs_err(out[f], plain[f])
        if err != 0.0:
            _fail(f"offline feature {f} differs from the run with the "
                  f"fold-levels plain version (max |diff| {err})")
    print(f"offline export == the fold-levels plain version's run: "
          f"{len(out)} features bit-exact", flush=True)
    del out, plain, amount
    torch.cuda.empty_cache()
    trace_offline(engine, view, cols)


def trace_offline(engine, view, cols) -> None:
    """Profile one warm offline export: device kernels, busy time, idle
    share, the largest device items."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.compute(view, cols)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    dev = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in dev) / 1e3
    if busy_ms <= 0:
        print("offline trace: the profiler recorded no device time (device "
              "busy share not measured)", flush=True)
        return
    print(f"offline trace (profiler on): export wall {wall_ms:.3f} ms, "
          f"{sum(e.count for e in dev)} device kernels, device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}",
          flush=True)
    for e in sorted(dev, key=lambda e: -e.self_device_time_total)[:10]:
        print(f"  device {e.self_device_time_total / 1e3:.4f} ms "
              f"x{e.count} {e.key[:90]}", flush=True)
    _print_b6_share(dev, busy_ms)


def consistency() -> None:
    """verify_view on the card, naive and preagg mode, for each run of
    ``VERIFY_RUNS``."""
    from repro_torch.core.consistency import verify_view
    from repro_torch.data.synthetic import fraud_transactions
    from repro_torch.scenarios import fraud_view

    rng = np.random.default_rng(SEED + 4)
    for cards, span in VERIFY_RUNS:
        cols = fraud_transactions(rng, VERIFY_ROWS, cards, 0, span)
        per_card = np.bincount(cols["card"], minlength=cards)
        print(f"consistency: {VERIFY_ROWS} transactions on {cards} cards "
              f"over {span} s, {per_card.max()} on the busiest card "
              f"(ring {STORE_KW['capacity']})", flush=True)
        for mode in ("naive", "preagg"):
            t0 = time.perf_counter()
            rep = verify_view(fraud_view(), cols, num_keys=cards,
                              mode=mode, device="cuda", **STORE_KW)
            print(f"{rep.summary()} in {time.perf_counter() - t0:.1f} s: "
                  f"max_abs_err {rep.max_abs_err!r}, max_rel_err "
                  f"{rep.max_rel_err!r}; per feature {rep.per_feature}",
                  flush=True)
            if not rep.passed:
                _fail(f"verify_view ({mode}, {cards} cards over {span} s) "
                      f"failed: {rep.per_feature}")
        torch.cuda.empty_cache()


def main() -> None:
    if not torch.cuda.is_available():
        _fail("no CUDA GPU visible (this smoke run needs one)")
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        _fail(f"the port's package is not next to this script ({e})")
    card = _card_line()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    build.build()
    print(f"built {sorted(build.SOURCES)} in {time.perf_counter() - t0:.1f} s",
          flush=True)
    for name, log in sorted(build.BUILD_LOGS.items()):
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  {name}: {ln.strip()}", flush=True)

    results = {}
    check_ingest_kernel(results)
    check_route_kernel(results)
    check_fold_kernel(results)
    svc = main_path(results)
    table = check_signature_kernel(results)
    scoring_path(results, svc, table)
    del svc, table
    torch.cuda.empty_cache()
    check_wkv6_kernel(results)
    rwkv6_path(results)
    check_flash_attention_kernel(results)
    nemotron_path(results)
    offline_path(results)
    consistency()

    line = {"kernels": [
        dict(name="fused_ingest", route="cuda",
             source="src/repro_torch/kernels/csrc/fused_ingest.cu",
             replaces="src/repro/kernels/ingest/ingest.py:182",
             bound_by="bytes", library_ms=None, **results["fused_ingest"]),
        dict(name="route_rank", route="cuda",
             source="src/repro_torch/kernels/csrc/route_rank.cu",
             replaces="src/repro/kernels/route/route.py:57",
             bound_by="bytes", library_ms=None, **results["route_rank"]),
        dict(name="fold_levels", route="cuda",
             source="src/repro_torch/kernels/csrc/fold_levels.cu",
             replaces="src/repro/kernels/window_agg/window_agg.py:288",
             bound_by="bytes", library_ms=None, **results["fold_levels"]),
        dict(name="window_stats", route="cuda",
             source="src/repro_torch/kernels/csrc/window_stats.cu",
             replaces="src/repro/kernels/window_agg/window_agg.py:103",
             bound_by="bytes", library_ms=None, **results["window_stats"]),
        dict(name="signature_embed", route="cuda",
             source="src/repro_torch/kernels/csrc/signature_embed.cu",
             replaces="src/repro/kernels/signature/signature.py:41",
             bound_by="bytes", **results["signature_embed"]),
        dict(name="wkv6", route="cuda",
             source="src/repro_torch/kernels/csrc/wkv6.cu",
             replaces="src/repro/kernels/wkv6/wkv6.py:99",
             library_ms=None, **results["wkv6"]),
        dict(name="flash_attention", route="cuda",
             source="src/repro_torch/kernels/csrc/flash_attention.cu",
             replaces="src/repro/kernels/flash_attention/flash_attention.py:111",
             scoring_launches=results["scoring_flash_attention_launches"],
             **results["flash_attention"]),
    ]}
    print(json.dumps(line), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
