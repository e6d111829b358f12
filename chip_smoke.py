"""GPU smoke run of the PyTorch port: the sharded online request path, the
fraud scoring path on top of it, multi-table sharded serving, the
multi-scenario plane (mixed batches through one store), hot deploy onto a
live plane and the offline bridge (backfill, training-set export), the
merge-order bucket families (FIRST / LAST / TOPN_FREQ over RANGE
windows), the platform surface (data import at a day's scale, the
telemetry gate, the dashboard, the catalog, the example twins), the
stress harness (its CLI, and 128 generated scenarios on one plane at a
deployment's size, with a hot-deploy wave), RWKV6
serving (rwkv6-3b prefill and decode), dense LM serving
(nemotron-4-15b prefill and decode), and the offline feature path with its
offline<->online consistency check.

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
   22 buckets and a batch of 65,536 distinct keys; the route kernel (B2)
   from keys -- the Feistel walk, shard, local id, rank and the two
   per-shard counts in one launch -- against the host permutation and the
   rank's plain version on 4,096-key batches over the 2^19 cards at S = 8,
   a 200-key domain (long walks), all rows on one shard and invalid rows
   with keys outside the domain, and from shard ids on 4,096-row batches
   (one shard, pad ids) — exact; the fold-levels kernel for min, max and or at N = 2^24 rows sorted over
   2^19 cards and at the edges (N = 1, N not a power of two, one segment
   over all rows, every row its own segment, NaN / ±0.0 values, segments
   just shorter and longer than its halo, a hot key of 2^20 rows among
   the 2^24, NaN / ±inf in segments longer than the halo) — bit for bit.
   Ingest, route and fold levels must launch once a call.  Each is timed
   with CUDA events beside its plain version (the ingest kernel also
   inside a CUDA graph, without the host's launch time; the route kernel
   also by its device time in a profile, beside an empty kernel launched
   through the same ctypes path: the launch floor).
4. **Main path.**  ``FeatureService.build(fraud_view(), sharded=True,
   num_shards=8)`` on the GPU; a day of ~4.2M transactions ingested in
   65,536-row time slices; 8 request batches of 4,096 rows served through
   ``ShardRouter`` in preagg mode with ingest on.  Each batch's answers
   must equal, bit for bit, the same state queried with the route
   kernel's plain composition (eager Feistel walk, rank plain version)
   swapped in; afterwards the store state must equal the ingest kernel's
   plain version replayed over the same batches.  The ingest kernel's
   launch counter must have gone up, and the route kernel must have
   launched exactly once (from keys) for each of the 8 route dispatches.
5. **Window stats** (B3, on no path: its launches on the main path stay
   0).  At two shapes: the main path's warm state (flat keys over the 8
   shards) and a dense day (``DENSE_CARDS`` = 2^11 cards, 2^20
   transactions over a day in an unsharded store of the same sizes), 8
   request batches of 4,096 rows each, windows 1 h and 6 h.  On the first
   batch: one launch of the register instantiation, count, min and max
   bit-exact against its plain version, sums within ``rtol=1e-5,
   atol=1e-3``; SUM 1 h, COUNT 1 h and MAX 6 h agree with the store's own
   preagg query on the same rows.  Then timed four ways, cycling over the
   8 batches: the wrapper ``window_stats`` eager (its key-range guard reads
   the card), ``launch_window_stats`` eager and inside a CUDA graph, and
   the kernel's device time under ``torch.profiler``; beside the plain
   version.  Each shape's bound counts the bytes its batches' data need
   (``_window_stats_bytes``).
6. **Trace.**  One more request batch (no ingest) under
   ``torch.profiler``: device kernels launched, device busy time and the
   device's idle share of the batch, the largest device items, the route
   kernel's launches and device time in it.
7. **Signature-embedding kernel** (B5) against its plain version at the
   scoring shapes, from signatures (the ids hashed in the kernel, one
   launch a call) and from ids already hashed: 4,096 rows, k = 2, a 2^18
   x 512 float32 table (512 MB, larger than L2) over 8 batches; a bf16
   table; k = 1, 2, 3 and 32 on signatures anywhere in int32 (INT32_MIN
   and -1 among them) at D = 512 and D = 510 (not a multiple of 4 floats
   or 8 bf16), float32 and bf16 — all bit for bit against
   ``multi_hash_ids`` + the plain version.  Timed with CUDA events
   (eager, and inside a CUDA graph) beside the plain composition and
   ``F.embedding_bag`` on the ids (the library call), cycling over the 8
   batches so repeated launches do not find their rows in L2.  Its bound
   counts the distinct table rows each batch probes.
8. **Scoring path.**  ``ScoringService`` on the main path's warm sharded
   service (reused) with ``DecoderLM(featinsight_fraud.config())`` — 8
   layers, d_model 512, bf16, weights from a seeded generator on the
   card — and the 2^18 x 512 table: one warm-up batch, then 8 scored
   batches of 4,096 rows.  Scores must be finite and in [0, 1]; the
   signature-embedding kernel must have launched once a batch, from the
   signatures; the
   embeddings and scores must equal, bit for bit, the same batches served
   with the kernel's plain version swapped in (a score difference is
   checked against the kernel path's own run-to-run difference); flash
   attention (B6) must have launched once per layer per batch, all in its
   short-sequence ``mma16`` instantiation.  Prints
   the fenced batch wall p50 / p99 split into features, embedding and
   model, the peak device memory and one traced batch; then runs
   ``repro_torch.launch.serve.main`` once on the card at its defaults.
9. **Multi-table sharded serving** (after the scoring phase has freed
   the main path's service).  ``FeatureService.build(sharded_view(),
   sharded=True, num_shards=8)`` at the main path's sizes (2^19 accounts,
   ring 256, 512 buckets of 64 s; ``secondary_num_keys={"merchants":
   2^16}``): two LAST JOINs (``accounts``, ``merchants``), WINDOW UNION
   sums / counts over ``wires`` and one single-table MEAN; beside it a
   single-device ``OnlineFeatureStore`` of the same view.  A day of
   ``multitable_stream`` traffic (4,194,304 transactions, ~1.05 M wires,
   786,432 account and 98,304 merchant rows): ``accounts`` and
   ``merchants`` first through ``ingest_table``, then 64 time slices, each
   its wires through ``ingest_table`` and its transactions through
   ``ingest`` (B1).  Then 8 request batches of 4,096 rows (accounts
   uniform over 2^19, merchants over 2^16, ts after the day) through
   ``FeatureService.request``, preagg, ingest on.  Before each is
   ingested, its device-routed answers must equal, bit for bit, the
   host-routed answers of the same store (``device_routing=False``), the
   single-device store's and the device-routed answers with B2's plain
   composition swapped in; both paths' per-shard counts must be equal;
   B2 must launch once a dispatch (from keys) and B1's count must rise;
   afterwards the served store's primary state must equal B1's plain
   version replayed over its batches.  Prints the bytes of each ring,
   ingest rows/s per table, request p50 / p99, the device path's
   ``route.device`` / ``query.route`` / ``query.scatter`` beside the host
   path's ``query.route`` / ``query.compute`` / ``query.scatter``, the
   peak device memory and one traced device-routed batch.  Then modulo
   routing (``hash_routing=False``) at 2^16 accounts, the same view and
   sizes, a day of 2^19 transactions: 8 batches device == host ==
   single-device == B2-plain, B2 launched once a dispatch from shard ids
   and never from keys, and one batch of accounts all ≡ 0 mod 8 that
   overflows the optimistic grid and re-dispatches at B = N with its
   answers still equal.  Then ``verify_view(multi_table_view(), ...,
   secondary=...)`` on 2^20 transactions over a day on 2^11 accounts
   (merchants 256), 8 shards: preagg on the device-routed path and naive
   on the host-routed path must both pass.
10. **Multi-scenario plane** (after phase 9 has freed its stores).
   ``FeatureService.build_multi("plane", multi_scenario_views(),
   sharded=True, num_shards=8)`` at the main path's sizes (2^19 accounts,
   ring 256, 512 buckets of 64 s, merchants 2^16): the three scenarios'
   views on one store (``raw_lanes``: two primary lanes), ~18.5 GB.  The
   day of phase 9's traffic, ingested once for all scenarios; then 8 mixed
   batches of 4,096 rows (scenario tags uniform over the three, accounts
   uniform over 2^19, merchants over 2^16) and one batch of one scenario
   alone, each submitted row by row with its tag to ``ShardRouter`` and
   served by one ``pump`` (``request_mixed``: preagg, ingest on).  Before
   each is ingested, its answers must equal, bit for bit, a host-routed
   router's over the same store (``device_routing=False``: one program a
   scenario group, ingest off) and the mixed answers with B2's plain
   composition swapped in; both routers' per-(scenario, shard) histograms
   must be equal; the pump must be one ``route.device`` span with one B2
   launch (from keys), and B1's count must rise.  ``ingest_row_counts``
   must count transactions and wires once and accounts and merchants x 8.
   Then each scenario's dedicated single-device store, built one at a
   time and fed the same day and request rows in the same order, must
   answer the 9 batches as the plane did, bit for bit.  Prints the plane's
   bytes beside the dedicated stores', ingest rows/s, request p50 / p99
   (``ServiceStats`` over all the phase's requests, and the fenced pump
   walls), the device path's spans beside the host path's, the peak
   device memory and one traced mixed batch.  Then modulo routing
   (``hash_routing=False``) at 2^16 accounts: ``MS_MOD_BATCHES`` mixed
   batches, device == host == B2-plain, B2 from shard ids once a pump.
11. **Hot deploy and the offline bridge** (after phase 10 has freed its
   stores; phase 10's sizes and day, regenerated from its seed).  (a)
   ``build_multi("hot", multi_scenario_views()[:2])`` takes the day and 2
   mixed warm-up batches; ``hot_deploy(views[2])`` must be exact, keep
   ``ingest_row_counts`` and every buffer's ``data_ptr()``; a cold
   ``ScenarioPlane(views)`` replaying the same stream must equal it buffer
   by buffer, bit for bit; then 8 mixed batches through ``ShardRouter`` on
   the hot plane (== a host-routed router == the B2-plain swap, one B2
   launch a pump, B1 rising) and the same rows on the cold plane, bit for
   bit.  (b) ``[va] -> [va, vb]`` (derived lanes ``amount * 2.0``,
   ``amount > 20.0``) with the ring grown 256 -> 384 at the full 2^19
   accounts: exact, synthesized lanes, hot == cold; bucket cells may differ
   only at (account, bucket) pairs outside the exactness contract (rows in
   two or more slices, two or more in a later one), whose count is printed.
   (c) ``views[:2]`` on rings of 4 (most wrap): deploying the
   ``merchant_mix`` Signature view on rings of 16 without a source must
   raise ``ValueError`` naming backfill and leave the plane's buffers and
   answers as they were; with ``BackfillSource(MULTITABLE_DB, day)`` it is
   exact with ``backfilled`` deficits, B1 re-folds the new lane's buckets,
   and hot == a cold plane on rings of 16.  (d) ``export_training_set`` of
   ``multi_table_view()`` and of ``merchant_watch`` (whose MAX and
   DISTINCT reach B4), 65,536 labels over the day, == the same exports
   with B4's plain version swapped in, bit for bit; ``verify_export`` at
   the consistency shape (2^20 transactions over a day on 2^11 accounts,
   4,096 labels, most beyond the rings' horizon) passes single-device and
   at 8 shards.  Prints the reports' carried / migrated / fresh lists, the
   fenced ``hot_deploy`` walls with their ``migrate.*`` / ``backfill``
   spans beside the cold build + replay walls, the peak memory, the
   export's rows/s.
12. **Merge-order bucket families** (after phase 11 has freed its
   planes; a day of ``multitable_stream`` from its own seed).
   ``sharded_view()`` plus FIRST / LAST of ``amount`` and TOPN_FREQ
   (n = 0, 1) of ``merchant`` over its 1 h window (the view is built
   here), 2^19 accounts x 8 shards, ring 256, 64 buckets of 64 s (the
   tail family costs 32 (9 + 4F) bytes a (key, bucket): ~146 GB at 512
   buckets); the family bytes reckoned must equal those allocated.  (a)
   The day in 64 slices, B1 once a slice; every state tensor, the
   families included, == a replay of the same batches through the split
   ``ring_ingest`` + ``bucket_ingest``, and ``seq`` == the cursor; the
   warm ingest rate beside the same store without the four features.
   (b) 8 batches of 4,096 through ``ShardRouter`` (preagg, ingest on):
   == the host-routed path, the B2-plain swap (every feature) and naive
   mode (the family features), bit for bit; B2 once a pump;
   ``preagg_hits_total{agg=first|last|topn_freq}`` hits and no
   fallbacks; then a single-device store fed the same stream == the
   saved answers.  (c) ``verify_view`` of the view on 2^20 transactions
   over a day on 2^11 accounts, preagg, device-routed: PASS with err 0
   on the family features.  (d) ``hot_deploy`` of the view onto a warm
   ``[sharded_view()]`` plane, from the rings (rings of 256) and with a
   ``BackfillSource`` (rings of 4, most wrapped): exact, == a cold plane
   replaying the day buffer by buffer.  Prints the card line's numbers
   beside the ingest rates, request p50 / p99 (fenced pump walls), the
   ``route.device`` span, the ``hot_deploy`` walls against the cold
   builds, the peaks and the phase's seconds.
13. **Platform surface** (after phase 12 has freed its planes).  (a) The
   main path's day (phase 4's 64 slices of 65,536 rows from ``SEED``)
   written as one ``.npz`` a slice and, for the first
   ``PLATFORM_CSV_SLICES`` = 16 slices (2^20 rows), as CSV (float32 as
   ``repr(float(v))``) under a temporary directory; loaded back with
   ``data.ingest.load_table(..., "npz")`` / ``(..., "csv")``: every column
   equal to the generated one, dtype and bytes.  The loaded day ingested
   into ``FeatureService.build(fraud_view(), sharded=True, num_shards=8)``
   at the main path's sizes (~15.6 GB), B1 once a slice; then 8 batches of
   4,096 through ``ShardRouter`` (preagg, ingest on), each equal bit for
   bit to the host-routed path of the same store
   (``device_routing=False``), B2 once a pump.  Prints the npz and CSV
   load rates, the ingest rate and the state's bytes.  (b)
   ``repro_torch.obs.check.main(["all", "--device", "cuda"])``: the golden
   metric catalog, every span name, every device span fenced,
   ``kernel_dispatch_total`` with ``impl="cuda"`` for ``fused_ingest``
   and ``route_rank`` and no ``impl="ref"``, and the overhead bound
   (2.5x + 2 ms, medians of 40 requests, printed).  (c) ``render_markdown``
   of (b)'s snapshot names every golden metric; ``obs.report --prom`` of
   the demo names every family the demo records.  (d)
   ``repro_torch.catalog.main(["--check"])`` against
   ``docs/CATALOG_TORCH.md``.  (e) The five example twins
   (``repro_torch.examples``), each ``main(device="cuda")`` at its own
   sizes with its own assertions; seconds and B1 / B2 / B4 launches each.
14. **Stress harness** (after phase 13 has freed its stores).  First the
   count-min sketch (``core.signature``): ``CMS_ITEMS`` uniform ids plus
   ``CMS_HOT`` ids of ``CMS_HOT_ROWS`` copies into a (4, 2^14) sketch, unit
   and float weights (six magnitudes), the card's counts and queries ==
   the CPU's, bit for bit.  (a) ``repro_torch.stress.__main__.main(
   ["--smoke", "--device", "cuda"])`` in this process, its answer
   comparisons held to the bits (dtype and bytes; the harness itself
   compares values): exit 0, 16 views deployed, 2 waves, 3
   flavour-parity probes (device-routed == host-routed), 6 verified, 3
   spot checks (plane == a dedicated store).  (b) ``--smoke
   --force-fail`` of the first view (a) verified: exit 1, exactly one
   ``verify`` failure, shrunk to 60 rows, one repro script naming ``python -m repro_torch.stress
   --repro``, whose command, run as a subprocess from the repository
   root, exits 0 on the card.  (c) ``--n 128`` at the defaults (8
   shards, 2 waves of 3, 1,200 rows): 128 deployed, 2 waves, 3 probes, 6
   verified; ``deploy_wall_s``, ``qps`` and B1 / B2 / B4 launches.
   Repro scripts go to a temporary directory.  (d)
   ``bench_stress.py``'s ladder: N in ``STRESS_LADDER`` generated views
   on one 8-shard ``ScenarioPlane``, 900 rows, 8 mixed ``query_mixed``
   batches of 64: ``deploy_s``, ``lanes_primary`` / ``lanes_shared``,
   ``mixed_qps``, the telemetry registry's size (printed, no file).  (e)
   Deployment size: the 128 views of ``gen_views(0, 128)``, 122 deployed
   by ``build_multi(..., sharded=True, num_shards=8)`` at
   ``STRESS_ENTITIES`` = 2^15 entities (items 2^14) with the generator's
   other knobs; a day of ``STRESS_ROWS`` = 2^22 events
   (``stress_stream``), the tracked secondary tables first, then 64
   (entity, ts)-sorted slices, B1 at least once a slice; 8 mixed batches
   of 4,096 event rows (after the day, tags drawn over all live
   scenarios) through ``ShardRouter`` (ingest off), device-routed ==
   host-routed bit for bit, B2 once a pump from keys; two views'
   answers == a dedicated single-view store replaying the ingest log,
   bit for bit; one traced mixed batch; one hot-deploy wave of the 6
   held views under the harness's protocol (without a backfill first; a
   refusal naming backfill is retried with a ``BackfillSource`` of the
   ingest log; every migration exact), then one more mixed batch over
   all 128, device == host.  Prints the build seconds, ingest rows/s,
   pump p50 / p99, ``route.device``, the trace's kernel count and idle
   share, each deploy's seconds and spans, the state's bytes and peaks,
   and B1 / B2 / B4 launches over the phase.
15. **WKV6 kernel** against its plain versions, float32 inputs from a
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
16. **RWKV6 serving.**  ``build_model(rwkv6_3b.config())`` at full width
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
17. **Flash attention kernel (B6)**: each instantiation's registers and
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
18. **nemotron-4-15b serving.**  ``build_model(nemotron_4_15b.config())``
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
19. **Offline path.**  ``OfflineEngine(device="cuda").compute(fraud_view(),
   ...)`` over 2^24 transactions (four days of the main path's traffic)
   on 2^19 cards, cold then warm; every feature must equal, bit for bit,
   a run with the fold-levels kernel's plain version swapped in, and the
   kernel's launch counter must have gone up.  Warm rows/s and peak
   device memory are printed, then one more warm export under
   ``torch.profiler`` (device busy time, idle share, largest items).
20. **Consistency.**  ``verify_view(fraud_view(), ..., device="cuda")`` on
   2^20 transactions over 2^17 cards in one hour, and on 2^20 over 2^11
   cards in a day, where the ring (256 rows) wraps and every one of the
   512 bucket slots of 64 s is reused; naive and preagg mode: all must
   pass.
21. **Summary.**  One ``kernels`` JSON line (``launches``: each kernel's
    count on its own path; B1's and B2's counts on phase 9 under their
    own keys, phase 10's under ``launches_multiscenario``, phase 11's B1,
    B2 and B4 under ``launches_deploy``, phase 12's B1 and B2 under
    ``launches_families``, phase 13's (a), (b) and (e) under
    ``launches_platform``, phase 14's under ``launches_stress``), then
    the card
    line, then the ``ok`` line last.

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
# B3's second shape, a dense history: the second run's traffic (2^20
# transactions over a day on 2^11 cards, 512 a card) in an unsharded store
# of the main path's sizes; a 6 h window then holds ~128 ring rows and ~100
# filled middle buckets.  B3 is timed over WS_BATCHES request batches in
# turn at each shape (at the main path's, 8 x ~12 MB of key rows > L2).
DENSE_CARDS = 1 << 11
# the multi-table phase: sharded_view() on the main path's store sizes, a
# day of 4,194,304 transactions (~1.05 M wires, 786,432 account and 98,304
# merchant rows); modulo routing at 2^16 accounts over a day of 2^19
# transactions (16 slices); verify_view of multi_table_view() on 2^20
# transactions over a day on 2^11 accounts (~128 wires a ring of 256)
MT_MERCHANTS = 1 << 16
MT_ROWS = WARM_SLICES * SLICE_ROWS
MT_MOD_ACCOUNTS = 1 << 16
MT_MOD_ROWS = 1 << 19
MT_MOD_SLICES = 16
MT_VERIFY_ACCOUNTS, MT_VERIFY_MERCHANTS = 1 << 11, 256
# the multi-scenario phase's modulo-routing run: mixed batches served
MS_MOD_BATCHES = 2
# the hot-deploy phase: (a) 2 warm-up mixed batches, then 8 after the
# deploy; (b) va -> [va, vb] with the ring grown 256 -> 384 at the full 2^19
# accounts (hot plane 16.6 -> 32.5 GB, the cold plane 32.5 GB: ~65 GB at the
# peak, below the card's 80); (c) rings of 4 rows grown to 16 with a
# Signature lane from a BackfillSource; (d) 65,536 labels over the day and
# verify_export at the consistency shape (2^20 transactions over a day on
# 2^11 accounts, merchants 256, 4,096 labels).  Its rings hold 256 rows, as
# phase 9's verify_view: 512 rows an account still put most labels beyond
# the horizon, while the replay's early-ingested wires (a round reaches
# ~6,600 s past a key's row, ~10 wires) and a 1 h union window (~5 wires)
# overflow a ring of 16 — the replay's capacity contract, broken in both
# packages at 16 (the reference's verify_export fails there as the port's)
DEPLOY_WARM_BATCHES = 2
DEPLOY_B_ACCOUNTS = NUM_CARDS
DEPLOY_B_CAPACITY = 384
DEPLOY_C_CAPACITY, DEPLOY_C_GROWN = 4, 16
EXPORT_LABELS = 1 << 16
EXPORT_CHECK_LABELS = 4_096
EXPORT_CHECK_CAPACITY = STORE_KW["capacity"]
# the merge-order families phase: sharded_view() plus FIRST / LAST /
# TOPN_FREQ over its 1 h window at the main path's 2^19 accounts x 8 shards,
# ring 256, but 64 buckets of 64 s (the planner's default: the 1 h
# window's 57 middle buckets, a day's slices of 21 buckets each).  The
# tail family costs 32 (9 + 4F) bytes a (key, bucket): at STORE_KW's 512
# buckets and F = 2 that is ~146 GB, at 64 ~18 GB.  verify_view at the
# consistency shape of phase 9 (2^11 accounts over a day)
FAM_STORE_KW = dict(capacity=256, num_buckets=64, bucket_size=64)
FAM_FEATURES = ("first_amount_1h", "last_amount_1h", "top_merchant_1h",
                "second_merchant_1h")
# the platform phase: the main path's day written as npz (all 64 slices) and
# as CSV (the first 16 slices, 2^20 rows), loaded back through data.ingest
PLATFORM_CSV_SLICES = 16
# the stress phase: the harness's N = 128 sweep; bench_stress.py's ladder
# (N views on one 8-shard plane, 900 rows, 8 mixed batches of 64); the
# generated views of (0, 128) at a deployment's size: 122 on the plane and
# 6 held back for one hot-deploy wave, 2^15 entities (items 2^14), a day of
# 2^22 events in 64 slices (busiest entity under the ring of 256), 8 mixed
# batches of REQ_ROWS; the count-min sketch over 2^20 uniform ids plus
# CMS_HOT ids of CMS_HOT_ROWS copies each (its per-cell fold runs one step
# per copy on the busiest cell)
STRESS_N = 128
STRESS_HELD = 6
STRESS_LADDER = (16, 64, 128)
STRESS_LADDER_ROWS = 900
STRESS_LADDER_BATCH = 64
STRESS_LADDER_BATCHES = 8
STRESS_ENTITIES = 1 << 15
STRESS_ITEMS = 1 << 14
STRESS_ROWS = 1 << 22
STRESS_SLICES = 64
STRESS_BATCHES = 8
CMS_ITEMS = 1 << 20
CMS_HOT = 4
CMS_HOT_ROWS = 512
CMS_DEPTH = 4
CMS_WIDTH = 1 << 14
WS_BATCHES = 8
WINDOWS = (3600, 21600)   # the fraud view's 1 h and 6 h RANGE windows
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
# int32 operations a second on the H100 SXM's CUDA cores: 132 SMs x 64
# INT32 lanes x 1.98 GHz boost (NVIDIA's Hopper white paper; the published
# tables give no int32 rate): the route kernel's Feistel walk runs there
INT32_OP_PER_S = 132 * 64 * 1.98e9
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


def _kernel_device_ms(fn, reps: int, name: str) -> float:
    """Mean device time of one launch of the kernels whose name holds
    ``name``, over ``reps`` calls of ``fn`` under ``torch.profiler`` (the
    kernel alone, whatever the host spends around it); NaN when the
    profiler records no such kernel."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and name in e.key]
    n = sum(e.count for e in hits)
    return (sum(e.self_device_time_total for e in hits) / 1e3 / n
            if n else float("nan"))


def _route_cost(keys, valid, perm, S):
    """(bytes, int32 operations) the fused route of one batch must move and
    do on this data: keys (4 B) and valid flags (1 B) read, local, shard
    and rank (4 B each) written, two (S,) counts; per key its walk's
    passes (counted here with the host permutation) x (rounds x 13 + 5)
    operations (a round: mix32's 11, the mask and the xor; a pass: split,
    join and the domain test), plus 2 for % S and // S."""
    x = perm._once(keys.astype(np.int64))
    passes = np.ones(len(keys), np.int64)
    bad = x >= perm.upper
    while bad.any():
        x[bad] = perm._once(x[bad])
        passes[bad] += 1
        bad = x >= perm.upper
    nbytes = len(keys) * (4 + 1 + 3 * 4) + 2 * S * 4
    ops = int(passes.sum()) * (perm.rounds * 13 + 5) + 2 * len(keys)
    return nbytes, ops, float(passes.mean()), int(passes.max())


def check_route_kernel(results) -> None:
    """B2 from keys (the Feistel walk and the rank in one launch) against
    the host permutation + the rank's plain version, and from shard ids
    against the rank's plain version; then timed beside the plain
    composition and an empty kernel's launch (the launch floor)."""
    from repro_torch import kernels
    from repro_torch.core.hashing import KeyPermutation
    from repro_torch.kernels.route.ops import launch_empty, route_keys, route_rank
    from repro_torch.kernels.route.ref import route_keys_ref, route_rank_ref

    dev = torch.device("cuda")
    S = NUM_SHARDS
    rng = np.random.default_rng(SEED + 2)
    perm = KeyPermutation(NUM_CARDS)   # the main path's domain: 8 x 2^16
    ones = np.ones(REQ_ROWS, bool)
    cases = [(f"main-path batch {b}", perm,
              rng.integers(0, NUM_CARDS, REQ_ROWS).astype(np.int32), ones)
             for b in range(4)]
    cases.append(("a 200-key domain (long walks)", KeyPermutation(200),
                  rng.integers(0, 200, REQ_ROWS).astype(np.int32), ones))
    pool = np.arange(1 << 16, dtype=np.int32)
    cases.append(("all rows on one shard", perm,
                  pool[perm(pool) % S == 3][:REQ_ROWS], ones))
    keys = rng.integers(0, NUM_CARDS, REQ_ROWS).astype(np.int32)
    keys[:50] = -1
    keys[50:100] = NUM_CARDS
    invalid = rng.random(REQ_ROWS) < 0.8
    cases.append(("invalid rows and keys outside the domain", perm, keys,
                  invalid))
    worst = 0.0
    for name, pm, keys, valid in cases:
        k = torch.as_tensor(keys, device=dev)
        v = torch.as_tensor(valid, device=dev)
        kernels.reset_launches()
        got = route_keys(k, v, pm, num_shards=S)
        per_call = kernels.LAUNCHES["route_rank"]
        inside = (keys >= 0) & (keys < pm.upper)
        routed = np.where(inside, pm(np.where(inside, keys, 0)), -1)
        shard = np.where(inside, routed % S, -1).astype(np.int32)
        local = np.where(inside, routed // S, -1).astype(np.int32)
        rank, counts = route_rank_ref(torch.as_tensor(shard, device=dev), S)
        vcounts = np.bincount(shard[inside & valid], minlength=S)
        want = [torch.as_tensor(local, device=dev),
                torch.as_tensor(shard, device=dev), rank, counts,
                torch.as_tensor(vcounts.astype(np.int32), device=dev)]
        plain = route_keys_ref(k, v, pm, S)
        torch.cuda.synchronize()
        err = max(max(_max_abs_err(a, b) for a, b in zip(got, want)),
                  max(_max_abs_err(a, b) for a, b in zip(plain, want)))
        if err != 0.0:
            _fail(f"route_keys differs from the host permutation + the rank's "
                  f"plain version on '{name}'")
        if per_call != 1:
            _fail(f"route_keys on '{name}': {per_call} launches a call")
        worst = max(worst, err)
        print(f"route_keys == host permutation + route_rank_ref on '{name}' "
              f"({len(keys)} rows, S={S}, domain {pm.upper}): five outputs "
              "exact; 1 launch", flush=True)
    shards = [("feistel S=8", torch.as_tensor(
        (perm(rng.integers(0, NUM_CARDS, REQ_ROWS)) % S).astype(np.int32),
        device=dev))]
    shards.append(("all on one shard", torch.full(
        (REQ_ROWS,), 3, dtype=torch.int32, device=dev)))
    pad = shards[0][1].clone()
    pad[-100:] = S
    shards.append(("100 pad ids", pad))
    for name, shard in shards:
        rk, ck = route_rank(shard, num_shards=S)
        rr, cr = route_rank_ref(shard, S)
        torch.cuda.synchronize()
        err = max(_max_abs_err(rk, rr), _max_abs_err(ck, cr))
        if err != 0.0:
            _fail(f"route_rank differs from its plain version on '{name}'")
        print(f"route_rank == plain on '{name}' ({REQ_ROWS} rows, S={S}): "
              "exact", flush=True)

    keys = cases[0][2]
    k = torch.as_tensor(keys, device=dev)
    v = torch.ones(REQ_ROWS, dtype=torch.bool, device=dev)
    shard = shards[0][1]
    ms = _time_ms(lambda: route_keys(k, v, perm, num_shards=S), 200, 5)
    kernel_ms = _kernel_device_ms(
        lambda: route_keys(k, v, perm, num_shards=S), 50, "route_kernel")
    rank_ms = _time_ms(lambda: route_rank(shard, num_shards=S), 200, 5)
    rank_kernel_ms = _kernel_device_ms(
        lambda: route_rank(shard, num_shards=S), 50, "route_kernel")
    plain_ms = _time_ms(lambda: route_keys_ref(k, v, perm, S), 20, 2)
    floor_ms = _time_ms(lambda: launch_empty(dev), 200, 5)
    floor_graph_ms = _graph_time_ms(lambda: launch_empty(dev), 50)
    floor_kernel_ms = _kernel_device_ms(lambda: launch_empty(dev), 50,
                                        "empty_kernel")
    nbytes, ops, mean_passes, max_passes = _route_cost(keys, ones, perm, S)
    bytes_ms = 1e3 * nbytes / HBM_BYTES_PER_S
    ops_ms = 1e3 * ops / INT32_OP_PER_S
    results["route_rank"] = dict(
        max_abs_err=worst, ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
        rank_ms=rank_ms, rank_kernel_ms=rank_kernel_ms,
        floor_ms=floor_ms, floor_graph_ms=floor_graph_ms,
        floor_kernel_ms=floor_kernel_ms,
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations",
        bytes=nbytes, int32_ops=ops, walk_passes_mean=mean_passes,
        walk_passes_max=max_passes, launches_per_call=1,
        shape=f"{REQ_ROWS} keys over {NUM_CARDS} cards, S={S} (Feistel walk "
              f"+ rank, one launch)",
    )
    r = results["route_rank"]
    print(f"route_keys {REQ_ROWS} keys: wrapper {ms:.4f} ms eager, kernel "
          f"{kernel_ms:.4f} ms device time; route_rank from shard ids "
          f"{rank_ms:.4f} ms eager ({rank_kernel_ms:.4f} ms device); plain "
          f"composition {plain_ms:.4f} ms; launch floor (empty kernel, same "
          f"ctypes path) {floor_ms:.4f} ms eager, {floor_graph_ms:.4f} ms in a "
          f"CUDA graph, {floor_kernel_ms:.4f} ms device; bound "
          f"{r['bound_ms']:.6f} ms by {r['bound_by']} ({nbytes} bytes, {ops} "
          f"int32 operations; walk passes mean {mean_passes:.3f}, max "
          f"{max_passes})", flush=True)


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


def _request_rows(rng, t_lo, cards=NUM_CARDS):
    cols = dict(
        card=rng.integers(0, cards, REQ_ROWS).astype(np.int32),
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
    from repro_torch.kernels.route.ref import route_keys_ref
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
    # plain composition (the eager Feistel walk, % S, // S, the rank's plain
    # version, the masked count) in place of the kernel
    def route_keys_plain(key, valid, perm, *, num_shards):
        return route_keys_ref(key, valid, perm, num_shards)

    def expected_answers(rows):
        # its own telemetry, so the served path's spans stay its own
        shard_mod.route_keys = route_keys_plain
        try:
            with use_telemetry(Telemetry()):
                out = store.query(dict(rows), mode="preagg")
            return {f: v.cpu().numpy() for f, v in out.items()}
        finally:
            shard_mod.route_keys = kernels_route_keys

    kernels_route_keys = shard_mod.route_keys
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
    # a window over all the phase's requests: the percentiles cover every
    # batch, not the last 1,024 samples
    svc.stats = type(svc.stats)(window=REQ_BATCHES * REQ_ROWS)
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
          "the route plain composition's, bit for bit; launches "
          f"{launches}", flush=True)
    if launches["fused_ingest"] <= ingest_launches:
        _fail(f"kernel launch counts on the main path: {launches}")
    # one route dispatch a batch, one B2 launch (from keys) a dispatch
    if (launches["route_rank"] != REQ_BATCHES
            or kernels.VARIANT_LAUNCHES["route_rank"]["keys"] != REQ_BATCHES):
        _fail(f"the main path's {REQ_BATCHES} route dispatches launched B2 "
              f"{launches['route_rank']} times "
              f"({kernels.VARIANT_LAUNCHES['route_rank']}), expected one each")
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
    check_window_stats(results, store, rng, DAY + 60 * REQ_BATCHES)
    trace_request(svc, _request_rows(rng, DAY + 60 * REQ_BATCHES), results)
    return svc


def _window_stats_bytes(ring_ts, bagg_bucket, qk, q_ts, L, B):
    """(distinct keys, bytes, raw rows, middle slots) of one window-stats
    call on this data: the bytes it must move are, per distinct key, its C
    ring timestamps (to find the raw rows), the lane values of the ring
    rows some window folds raw (head or tail bucket), the stored ids of the
    bucket slots that can hold a middle bucket of the widest window (id
    mod NB for b_lo < id < b_q) and the stats of the slots whose id is a
    middle bucket of some window; per request its key, ts and lanes in and
    its (NW, L, 5) stats out.  Raw rows and middle slots: means a request
    (union over the windows)."""
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
    return (int(uk.numel()), nbytes, float(raw.sum()) / Q,
            float(mid.sum()) / Q)


def _dense_store():
    """B3's dense shape: an unsharded fraud store of DENSE_CARDS cards with
    the main path's sizes after VERIFY_ROWS transactions over a day."""
    from repro_torch.data.synthetic import fraud_transactions
    from repro_torch.scenarios import fraud_view
    from repro_torch.serve.service import FeatureService

    svc = FeatureService.build(
        "fraud_dense", fraud_view(), num_keys=DENSE_CARDS, mode="preagg",
        device="cuda", **STORE_KW,
    )
    rng = np.random.default_rng(SEED + 7)
    svc.store.ingest(fraud_transactions(rng, VERIFY_ROWS, DENSE_CARDS, 0, DAY))
    torch.cuda.synchronize()
    return svc.store


def _ws_batches(store, rng, cards, t_lo, n=WS_BATCHES):
    """``n`` request batches of REQ_ROWS rows (batch b at [t_lo + 60 b, +
    60) s) as (rows, window_stats arguments) on ``store``'s flat state
    (flat keys of a sharded store)."""
    dev = torch.device("cuda")
    fs = store._flat_state()
    out = []
    for b in range(n):
        rows = _request_rows(rng, t_lo + 60 * b, cards)
        key = rows["card"]
        if hasattr(store, "_route_ids"):
            shard, local = store._route_ids(key)
            key = (shard * store.num_keys + local).astype(np.int32)
        cols = store._columns(rows)
        out.append((rows, (fs.ring.ts, fs.ring.vals, fs.bagg.stats,
                           fs.bagg.bucket, torch.as_tensor(key, device=dev),
                           cols["ts"], store._lanes(cols))))
    return out


def _ws_times(batches, launch, wrapper, bucket_size) -> dict:
    """B3 timed four ways, each repetition on the next batch: the wrapper
    ``window_stats`` eager (key-range guard and allocation included), the
    kernel's launches eager (``launch(args, out)``: the host's launch path
    included) and captured in one CUDA graph, and its device time a launch
    under ``torch.profiler``."""
    n = len(batches)
    L = batches[0][1][6].shape[1]
    outs = [torch.empty((REQ_ROWS, len(WINDOWS), L, 5), device="cuda")
            for _ in range(n)]
    step = itertools.count()

    def run_launch():
        i = next(step) % n
        launch(batches[i][1], outs[i])

    def run_wrapper():
        return wrapper(*batches[next(step) % n][1], windows=WINDOWS,
                       bucket_size=bucket_size)

    reps = 10 * n
    return dict(
        wrapper_ms=_time_ms(run_wrapper, reps, n),
        ms=_time_ms(run_launch, 25 * n, n),
        graph_ms=_graph_time_ms(run_launch, reps),
        device_ms=_kernel_device_ms(run_launch, reps, "window_stats"),
    )


def _ws_check(store, rows, args, tag) -> float:
    """B3 on one batch against its plain version (count / min / max bit for
    bit, sums within rtol 1e-5 / atol 1e-3) and against the store's preagg
    query (SUM 1 h, COUNT 1 h, MAX 6 h); one launch of the register
    instantiation.  Returns the sums' max |diff|."""
    from repro_torch import kernels
    from repro_torch.core.expr import Col
    from repro_torch.kernels.window_agg.ops import window_stats
    from repro_torch.kernels.window_agg.ref import window_stats_ref
    from repro_torch.obs import Telemetry, use_telemetry

    kw = dict(windows=WINDOWS, bucket_size=store.bucket_size)
    before = (kernels.LAUNCHES["window_stats"],
              kernels.VARIANT_LAUNCHES["window_stats"]["small"])
    got = window_stats(*args, **kw)
    after = (kernels.LAUNCHES["window_stats"],
             kernels.VARIANT_LAUNCHES["window_stats"]["small"])
    if (after[0] - before[0], after[1] - before[1]) != (1, 1):
        _fail(f"window_stats ({tag}): {after[0] - before[0]} launches a "
              "call, expected one of the register instantiation")
    want = window_stats_ref(*args, **kw)
    torch.cuda.synchronize()
    if got.shape != (REQ_ROWS, len(WINDOWS), store.num_lanes, 5):
        _fail(f"window_stats ({tag}) shape {tuple(got.shape)}")
    exact = max(_max_abs_err(got[..., i].contiguous(), want[..., i].contiguous())
                for i in (1, 2, 3))
    if exact != 0.0:
        _fail(f"window_stats ({tag}) count/min/max differ from the plain "
              f"version (max |diff| {exact})")
    sums = [(got[..., i] - want[..., i]).abs().max().item() for i in (0, 4)]
    if not all(torch.allclose(got[..., i], want[..., i], rtol=1e-5, atol=1e-3)
               for i in (0, 4)):
        _fail(f"window_stats ({tag}) sums outside rtol 1e-5 / atol 1e-3: "
              f"{sums}")
    with use_telemetry(Telemetry()):
        res = store.query(dict(rows), mode="preagg")
    lane = store._lane_of[Col("amount").key]
    g = got.cpu().numpy()
    s1h, c1h, m6h = g[:, 0, lane, 0], g[:, 0, lane, 1], g[:, 1, lane, 3]
    if not np.allclose(s1h, res["amt_sum_1h"].cpu().numpy(), rtol=1e-5,
                       atol=1e-3):
        _fail(f"window_stats ({tag}) SUM 1h disagrees with the store's "
              "preagg query")
    for name, v in (("tx_count_1h", c1h), ("amt_max_6h", m6h)):
        if not np.array_equal(v, res[name].cpu().numpy()):
            _fail(f"window_stats ({tag}) {name} differs from the store's "
                  "preagg query")
    print(f"window_stats ({tag}) == plain on {REQ_ROWS} requests x "
          f"{len(WINDOWS)} windows x {store.num_lanes} lanes, one launch: "
          f"count/min/max bit-exact, sums max |diff| {max(sums):.3e}; SUM "
          "1h / COUNT 1h / MAX 6h agree with the store's preagg query",
          flush=True)
    return max(sums)


def check_window_stats(results, store, rng, t_lo) -> None:
    """The window-stats kernel (B3) at two shapes -- the main path's warm
    state (flat keys over 8 shards) and a dense day on 2^11 cards --
    against its plain version and the store's preagg answers, then timed
    four ways beside the plain version, with each shape's byte bound."""
    from repro_torch.kernels.window_agg.ops import (
        launch_window_stats,
        window_stats,
    )
    from repro_torch.kernels.window_agg.ref import window_stats_ref

    def launch(args, out):
        launch_window_stats(*args, WINDOWS, out, STORE_KW["bucket_size"])

    dense = _dense_store()
    per_card = VERIFY_ROWS // DENSE_CARDS
    shapes = (
        ("", store, NUM_CARDS, t_lo,
         f"main path's warm state, {NUM_SHARDS} shards x {store.num_keys} "
         "cards"),
        ("dense_", dense, DENSE_CARDS, DAY,
         f"dense day: {DENSE_CARDS} cards, {VERIFY_ROWS} transactions over "
         f"{DAY} s ({per_card} a card)"),
    )
    worst = 0.0
    for prefix, st, cards, t0, what in shapes:
        tag = prefix.rstrip("_") or "main"
        batches = _ws_batches(st, rng, cards, t0)
        worst = max(worst, _ws_check(st, *batches[0], tag))
        times = _ws_times(batches, launch, window_stats, st.bucket_size)
        args0 = batches[0][1]
        plain_ms = _time_ms(lambda: window_stats_ref(
            *args0, windows=WINDOWS, bucket_size=st.bucket_size), 5)
        costs = [_window_stats_bytes(a[0], a[3], a[4], a[5], st.num_lanes,
                                     st.bucket_size) for _, a in batches]
        nbytes = sum(c[1] for c in costs) / len(costs)
        keys = sum(c[0] for c in costs) / len(costs)
        raw_q = sum(c[2] for c in costs) / len(costs)
        mid_q = sum(c[3] for c in costs) / len(costs)
        fs = st._flat_state()
        state_gb = sum(t.numel() * t.element_size()
                       for t in fs.arrays()) / 1e9
        entry = dict(
            times, plain_ms=plain_ms,
            bound_ms=1e3 * nbytes / HBM_BYTES_PER_S, bytes=nbytes,
            raw_rows_per_request=raw_q, middle_slots_per_request=mid_q,
            shape=f"{what}; {REQ_ROWS} requests ({keys:.0f} keys, mean over "
                  f"{len(batches)} batches), C={st.capacity}, "
                  f"NB={st.num_buckets}, L={st.num_lanes}, windows "
                  f"{WINDOWS}, state {state_gb:.3f} GB")
        results["window_stats"].update(
            {prefix + k: v for k, v in entry.items()})
        print(f"window_stats ({tag}) {REQ_ROWS} requests, state "
              f"{state_gb:.3f} GB, {raw_q:.2f} raw rows and {mid_q:.2f} "
              f"middle slots a request: device {times['device_ms']:.5f} ms a "
              f"launch, CUDA graph {times['graph_ms']:.5f} ms, eager launch "
              f"{times['ms']:.5f} ms, wrapper {times['wrapper_ms']:.5f} ms; "
              f"plain {plain_ms:.4f} ms; bound "
              f"{1e3 * nbytes / HBM_BYTES_PER_S:.5f} ms ({nbytes:.0f} bytes)",
              flush=True)
    results["window_stats"].update(max_abs_err=worst, launches_per_call=1)
    del dense
    torch.cuda.empty_cache()


def trace_request(svc, rows, results, key="trace_request",
                  serve=None) -> None:
    """Profile one request batch (``serve(rows)``, by default
    ``svc.request`` without ingest): device kernels, busy time, idle
    share, and B2's launches and device time in it (kept in B2's results
    under ``key``)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if serve is None:
        def serve(cols):
            return svc.request(cols, ingest=False)

    serve(dict(rows))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        serve(dict(rows))
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
    b2 = [e for e in dev if "route_kernel" in e.key]
    b2_n = sum(e.count for e in b2)
    b2_ms = sum(e.self_device_time_total for e in b2) / 1e3
    print(f"  B2 (route kernel) in the trace: x{b2_n}, {b2_ms:.4f} ms device "
          "time", flush=True)
    results["route_rank"].update({
        f"{key}_kernels": n_kernels, f"{key}_busy_ms": busy_ms,
        f"{key}_idle_share": 1 - busy_ms / wall_ms,
        f"{key}_b2_launches": b2_n})


def _sig_ids(rng, n, k, V, signed=False):
    """(sig (N,), ids (N, k)) on the card: ``n`` random 20-bit signatures
    (``signed``: any int32, INT32_MIN and -1 first) and their multi-hash
    ids, as the scoring path computes them."""
    from repro_torch.core.signature import multi_hash_ids

    if signed:
        raw = rng.integers(-2**31, 2**31 - 1, n, dtype=np.int64)
        raw[:2] = [-2**31, -1]
    else:
        raw = rng.integers(0, 2**20, n)
    sig = torch.as_tensor(raw.astype(np.int32), device="cuda")
    return sig, multi_hash_ids(sig, k, V)


def _sig_bytes(ids, D, esize) -> int:
    """Bytes one signature-embedding call from signatures must move on
    these ids: each distinct probed table row once, the signatures, the
    weights and the output."""
    n, k = ids.shape
    rows = int(torch.unique(ids).numel())
    return rows * D * esize + n * 4 + k * 4 + n * D * esize


def check_signature_kernel(results):
    """The signature-embedding kernel against its plain version, bit for
    bit -- from signatures (the ids hashed in the kernel, as the scoring
    path calls it) and from ids already hashed -- then timed at the
    scoring shapes.  Returns the float32 table the scoring phase uses."""
    import torch.nn.functional as F

    from repro_torch import kernels
    from repro_torch.core.signature import multi_hash_ids
    from repro_torch.kernels.signature.ops import (
        launch_signature_embed,
        launch_signature_embed_sig,
        signature_embed,
    )
    from repro_torch.kernels.signature.ref import signature_embed_ref

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 6)
    g = torch.Generator(device=dev).manual_seed(SEED + 6)
    table = torch.randn((SIG_ROWS, SIG_DIM), generator=g, device=dev) * 0.02
    w = torch.full((SIG_PROBES,), 1.0 / SIG_PROBES, device=dev)

    def check(name, tab, ids, wts, sig=None):
        k = ids.shape[1]
        if sig is None:
            out = torch.empty((ids.shape[0], tab.shape[1]), dtype=tab.dtype,
                              device=dev)
            launch_signature_embed(tab, ids, wts, out)
        else:
            kernels.reset_launches()
            out = signature_embed(tab, sig, wts, num_hashes=k)
            if kernels.VARIANT_LAUNCHES["signature_embed"]["sig"] != 1 or \
                    kernels.LAUNCHES["signature_embed"] != 1:
                _fail(f"signature_embed from signatures on '{name}': "
                      f"{kernels.LAUNCHES['signature_embed']} launches a call")
        want = signature_embed_ref(tab, ids, wts).to(tab.dtype)
        torch.cuda.synchronize()
        bits = torch.int32 if tab.dtype == torch.float32 else torch.int16
        if not torch.equal(out.view(bits), want.view(bits)):
            err = float((out.float() - want.float()).abs().max())
            _fail(f"signature_embed differs from its plain version on "
                  f"'{name}' (max |diff| {err})")
        src = "ids" if sig is None else "signatures, 1 launch"
        print(f"signature_embed ({src}) == plain on '{name}' ({ids.shape[0]} "
              f"rows, k={k}, table {tuple(tab.shape)} {tab.dtype}): "
              "bit-exact", flush=True)

    pairs = [_sig_ids(rng, REQ_ROWS, SIG_PROBES, SIG_ROWS)
             for _ in range(SIG_BATCHES)]
    sigs = [p[0] for p in pairs]
    batches = [p[1] for p in pairs]
    for b, (sig, ids) in enumerate(pairs):
        check(f"scoring batch {b}", table, ids, w)
        check(f"scoring batch {b}", table, ids, w, sig)
    bf16 = table.to(torch.bfloat16)
    check("bf16 table", bf16, batches[0], w)
    odd = table[: 1 << 16, :510].contiguous()
    tables = {512: (table, bf16), 510: (odd, odd.to(torch.bfloat16))}
    for k in (1, 2, 3, 32):
        wk = torch.randn((k,), generator=g, device=dev)
        for D, (f32, b16) in tables.items():
            sig, ids = _sig_ids(rng, REQ_ROWS, k, f32.shape[0], signed=True)
            for tab in (f32, b16):
                name = f"k={k} D={D} {str(tab.dtype)[6:]} signed signatures"
                if k in (1, 3):
                    check(name, tab, ids, wk)
                check(name, tab, ids, wk, sig)
    del bf16, odd, tables

    # timing: each repetition takes the next of the 8 batches (8 x 8,192
    # probed rows of 2 KB = 128 MB, so a launch does not find its rows in
    # the 50 MB L2)
    out = torch.empty((REQ_ROWS, SIG_DIM), device=dev)
    wide = w.expand(REQ_ROWS, SIG_PROBES).contiguous()
    ids_long = [ids.long() for ids in batches]
    step = itertools.count()

    def nxt():
        return next(step) % SIG_BATCHES

    def library_call():
        i = nxt()
        return F.embedding_bag(ids_long[i], table, per_sample_weights=wide,
                               mode="sum")

    def from_sig():
        launch_signature_embed_sig(table, sigs[nxt()], w, out)

    def from_ids():
        launch_signature_embed(table, batches[nxt()], w, out)

    def plain():
        i = nxt()
        return signature_embed_ref(
            table, multi_hash_ids(sigs[i], SIG_PROBES, SIG_ROWS), w)

    reps = 10 * SIG_BATCHES
    ms = _time_ms(from_sig, reps, SIG_BATCHES)
    graph_ms = _graph_time_ms(from_sig, reps)
    ids_ms = _time_ms(from_ids, reps, SIG_BATCHES)
    ids_graph_ms = _graph_time_ms(from_ids, reps)
    plain_ms = _time_ms(plain, reps, SIG_BATCHES)
    library_ms = _time_ms(library_call, reps, SIG_BATCHES)
    wrapper_ms = _time_ms(lambda: signature_embed(
        table, sigs[nxt()], w, num_hashes=SIG_PROBES), reps, SIG_BATCHES)
    lib = F.embedding_bag(ids_long[0], table, per_sample_weights=wide,
                          mode="sum")
    want = signature_embed_ref(table, batches[0], w)
    lib_err = float((lib - want).abs().max())
    nbytes = sum(_sig_bytes(ids, SIG_DIM, 4) for ids in batches) / SIG_BATCHES
    results["signature_embed"] = dict(
        max_abs_err=0.0, ms=ms, graph_ms=graph_ms, ids_ms=ids_ms,
        ids_graph_ms=ids_graph_ms, plain_ms=plain_ms, library_ms=library_ms,
        wrapper_ms=wrapper_ms, bound_ms=1e3 * nbytes / HBM_BYTES_PER_S,
        bytes=nbytes, library_max_abs_diff=lib_err, launches_per_call=1,
        shape=f"{REQ_ROWS} rows, k={SIG_PROBES}, table {SIG_ROWS} x "
              f"{SIG_DIM} f32, from signatures (mean over {SIG_BATCHES} "
              "batches)",
    )
    print(f"signature_embed {REQ_ROWS} rows k={SIG_PROBES} from signatures: "
          f"kernel {ms:.4f} ms eager, {graph_ms:.4f} ms in a CUDA graph "
          f"(from ids {ids_ms:.4f} / {ids_graph_ms:.4f}); wrapper "
          f"{wrapper_ms:.4f} ms; plain (multi_hash_ids + ref) {plain_ms:.4f}"
          f" ms; F.embedding_bag on the ids {library_ms:.4f} ms (max |diff| "
          f"{lib_err:.3e}); bound {results['signature_embed']['bound_ms']:.5f}"
          f" ms ({nbytes:.0f} bytes)", flush=True)
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
        # one launch a batch, from the signatures (no eager id hashing)
        if (launches["signature_embed"] != REQ_BATCHES or kernels.
                VARIANT_LAUNCHES["signature_embed"]["sig"] != REQ_BATCHES):
            _fail(f"the scoring path did not launch the signature-embedding "
                  f"kernel once a batch from the signatures: {launches}, "
                  f"{kernels.VARIANT_LAUNCHES['signature_embed']}")
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


# ---------------------------------------------------------------------------
# multi-table sharded serving
# ---------------------------------------------------------------------------


def _mt_requests(rng, t_lo, accounts):
    """A request batch of the multi-table view: accounts uniform over
    ``accounts``, merchants over ``MT_MERCHANTS``, ts in a minute."""
    return dict(
        account=rng.integers(0, accounts, REQ_ROWS).astype(np.int32),
        ts=rng.integers(t_lo, t_lo + 60, REQ_ROWS).astype(np.int32),
        amount=rng.gamma(1.5, 60.0, REQ_ROWS).astype(np.float32),
        merchant=rng.integers(0, MT_MERCHANTS, REQ_ROWS).astype(np.int32),
    )


def _by_key(cols, key):
    o = np.lexsort((cols["ts"], cols[key]))
    return {c: v[o] for c, v in cols.items()}


def _mt_ingest(served, others, tables, slices, launches):
    """``accounts`` and ``merchants`` (key, ts)-sorted, then the day in
    ``slices`` time slices: each slice's ``wires`` rows through
    ``ingest_table``, then its transactions through ``ingest`` (B1), into
    the served store and into each of ``others`` (each store takes the
    tables its view reads).  Returns the served store's seconds and rows
    per table; ``launches`` gains the served store's B1 launches."""
    from repro_torch import kernels

    secs, rows = {}, {}

    def reads(store, table):
        return table == store.schema.name or table in store._sec_names

    def put(table, cols):
        for s in others:
            if reads(s, table):
                s.ingest_table(table, dict(cols))
        if not reads(served, table):
            return
        kernels_before = kernels.LAUNCHES["fused_ingest"]
        t0 = time.perf_counter()
        served.ingest_table(table, dict(cols))
        secs[table] = secs.get(table, 0.0) + time.perf_counter() - t0
        rows[table] = rows.get(table, 0) + len(cols["ts"])
        launches["fused_ingest"] += (kernels.LAUNCHES["fused_ingest"]
                                     - kernels_before)

    put("accounts", _by_key(tables["accounts"], "account"))
    put("merchants", _by_key(tables["merchants"], "merchant"))
    tx, wires = tables["transactions"], tables["wires"]
    for i in range(slices):
        lo, hi = i * DAY // slices, (i + 1) * DAY // slices
        for table, cols in (("wires", wires), ("transactions", tx)):
            a, b = np.searchsorted(cols["ts"], [lo, hi])
            put(table, _by_key({c: v[a:b] for c, v in cols.items()},
                               "account"))
    return secs, rows


def _ring_bytes(store):
    """Bytes held by each ring of a store (a replicated ring's one copy)."""
    def nbytes(ring):
        return sum(t.untyped_storage().nbytes()
                   for t in (ring.ts, ring.vals, ring.cursor))

    s = store.state
    out = {"primary ring": nbytes(s.ring),
           "buckets": sum(t.untyped_storage().nbytes()
                          for t in (s.bagg.stats, s.bagg.bitmap, s.bagg.bucket))}
    for p, ring in zip(store.layout.tables, s.sec):
        role = "partitioned" if p.partitioned else "replicated"
        out[f"{p.table} ({role}, {'/'.join(p.serves)})"] = nbytes(ring)
    return out


def _np_answers(out):
    return {f: (v.cpu().numpy() if isinstance(v, torch.Tensor) else v)
            for f, v in out.items()}


def _same_bits(a, b):
    """Every feature of two answer dicts bit for bit."""
    for f in a:
        x, y = np.asarray(a[f]), np.asarray(b[f])
        if x.shape != y.shape or x.dtype != y.dtype:
            return f
        if not np.array_equal(x.view(np.uint8), y.view(np.uint8)):
            return f
    return None


def _mt_serve(svc, single, rng, t_lo, accounts, batches, launches, tels,
              variant, strided=False):
    """Serve ``batches`` request batches through ``svc`` (device-routed,
    ingest on); before each is ingested its answers must equal, bit for
    bit, the host-routed answers of the same store, the single-device
    store's and the answers with B2's plain composition swapped in; both
    paths' per-shard counts must be equal, and B2 (``variant``) must
    launch exactly once a dispatch.  ``strided`` makes every account
    ≡ 0 mod S.  Returns the last batch's per-shard counts and each
    ``request``'s wall seconds (query + ingest, answers on the host)."""
    from repro_torch import kernels
    from repro_torch.core import shard as shard_mod
    from repro_torch.kernels.route.ref import route_keys_ref, route_rank_ref
    from repro_torch.obs import Telemetry, use_telemetry

    store = svc.store
    S = store.num_shards
    kernel_fns = (shard_mod.route_keys, shard_mod.route_rank)

    def plain_route_keys(key, valid, perm, *, num_shards):
        return route_keys_ref(key, valid, perm, num_shards)

    def plain_route_rank(shard, *, num_shards):
        return route_rank_ref(shard, num_shards)

    walls = []
    for b in range(batches):
        rows = _mt_requests(rng, t_lo + 60 * b, accounts)
        if strided:
            rows["account"] = (rows["account"] // S * S).astype(np.int32)
        b2_before = dict(kernels.VARIANT_LAUNCHES["route_rank"])
        ri_host = {}
        store.device_routing = False
        with use_telemetry(tels["host"]):
            host = _np_answers(store.query(dict(rows), mode="preagg",
                                           route_info=ri_host))
        store.device_routing = True
        shard_mod.route_keys, shard_mod.route_rank = (plain_route_keys,
                                                      plain_route_rank)
        try:
            with use_telemetry(Telemetry()):
                plain = _np_answers(store.query(dict(rows), mode="preagg"))
        finally:
            shard_mod.route_keys, shard_mod.route_rank = kernel_fns
        with use_telemetry(Telemetry()):
            one = _np_answers(single.query(dict(rows), mode="preagg"))
        if kernels.VARIANT_LAUNCHES["route_rank"] != b2_before:
            _fail("the host-routed, plain and single-device answers "
                  "launched B2")
        ri_dev = {}
        b1 = kernels.LAUNCHES["fused_ingest"]
        t0 = time.perf_counter()
        with use_telemetry(tels["device"]):
            got = svc.request(dict(rows), ingest=True, route_info=ri_dev)
        walls.append(time.perf_counter() - t0)
        launches["fused_ingest"] += kernels.LAUNCHES["fused_ingest"] - b1
        after = kernels.VARIANT_LAUNCHES["route_rank"]
        n_b2 = {v: after[v] - b2_before[v] for v in after}
        launches[variant] += n_b2[variant]
        if n_b2[variant] != 1 or sum(n_b2.values()) != 1:
            _fail(f"batch {b}: B2 launched {n_b2} in one device-routed "
                  f"dispatch, expected one from {variant}")
        for name, want in (("host-routed", host), ("single-device", one),
                           ("B2-plain", plain)):
            bad = _same_bits(want, got)
            if bad is not None:
                x, y = np.asarray(want[bad]), np.asarray(got[bad])
                i = int(np.flatnonzero(x.view(np.uint8) != y.view(np.uint8))[0]
                        // x.itemsize) if x.shape == y.shape else 0
                _fail(f"batch {b} feature {bad}: device-routed answers differ "
                      f"from the {name} answers (first at row {i}: "
                      f"{y.reshape(-1)[i]!r} vs {x.reshape(-1)[i]!r})")
        for f, v in got.items():
            if v.shape != (REQ_ROWS,) or not np.all(np.isfinite(v)):
                _fail(f"batch {b} feature {f}: shape {v.shape} or non-finite")
        if not (got["outflow_cnt_1h"] >= 1).all():
            _fail("every request counts at least itself in its window")
        if not np.array_equal(ri_dev["shard_counts"], ri_host["shard_counts"]):
            _fail(f"batch {b}: per-shard counts differ: device "
                  f"{ri_dev['shard_counts']} host {ri_host['shard_counts']}")
        single.ingest(_by_key(rows, "account"))
    return ri_dev["shard_counts"], walls


def multitable_path(results) -> None:
    """Multi-table sharded serving at deployment size: ``sharded_view()``
    (two LAST JOINs, WINDOW UNION over wires) on 2^19 accounts x 8 shards,
    device == host == single-device == the B2-plain composition, bit for
    bit; then modulo routing at 2^16 accounts; then ``verify_view`` of
    ``multi_table_view()`` on the card in both routings."""
    from repro_torch import kernels
    from repro_torch.core.consistency import verify_view
    from repro_torch.core.online import OnlineFeatureStore
    from repro_torch.core.shard import ShardedOnlineStore
    from repro_torch.data.synthetic import multitable_stream
    from repro_torch.kernels.ingest.ref import fused_ingest_ref
    from repro_torch.obs import Telemetry
    from repro_torch.scenarios import multi_table_view, sharded_view
    from repro_torch.serve.service import FeatureService

    dev = "cuda"
    kw = dict(secondary_num_keys={"merchants": MT_MERCHANTS}, **STORE_KW)
    rng = np.random.default_rng(SEED + 5)
    torch.cuda.reset_peak_memory_stats()
    svc = FeatureService.build(
        "multitable", sharded_view(), num_keys=NUM_CARDS, sharded=True,
        num_shards=NUM_SHARDS, mode="preagg", device=dev, **kw)
    store = svc.store
    single = OnlineFeatureStore(sharded_view(), num_keys=NUM_CARDS,
                                device=dev, **kw)
    for name, nbytes in _ring_bytes(store).items():
        print(f"multi-table store: {name} {nbytes / 1e9:.4f} GB", flush=True)
    print(f"multi-table store: {sum(_ring_bytes(store).values()) / 1e9:.3f} "
          f"GB in all ({NUM_SHARDS} shards x {store.num_keys} accounts; the "
          f"single-device store beside it "
          f"{sum(_ring_bytes(single).values()) / 1e9:.3f} GB)", flush=True)

    # every flat batch the served store hands to B1, kept to replay
    # through its plain version afterwards
    applied = []
    apply_kernel = store._apply_ingest

    def recording_apply(key, ts, lanes):
        applied.append((key, ts, lanes))
        apply_kernel(key, ts, lanes)

    store._apply_ingest = recording_apply
    tables = multitable_stream(rng, MT_ROWS, num_accounts=NUM_CARDS,
                               num_merchants=MT_MERCHANTS, t_max=DAY)
    print("multi-table traffic: " + ", ".join(
        f"{t} {len(c['ts'])} rows" for t, c in tables.items()), flush=True)
    kernels.reset_launches()
    launches = {"fused_ingest": 0, "keys": 0, "shards": 0}
    secs, rows = _mt_ingest(store, (single,), tables, WARM_SLICES, launches)
    for t in rows:
        print(f"multi-table ingest {t}: {rows[t]} rows in {secs[t]:.3f} s = "
              f"{rows[t] / secs[t]:.0f} rows/s (served store, fenced)",
              flush=True)
    del tables
    tels = {"host": Telemetry(), "device": Telemetry()}
    _, walls = _mt_serve(svc, single, rng, DAY, NUM_CARDS, REQ_BATCHES,
                         launches, tels, "keys")
    print(f"multi-table: served {REQ_BATCHES} batches x {REQ_ROWS} rows: "
          "device-routed == host-routed == single-device == B2-plain, bit "
          f"for bit; per-shard counts equal; B2 launches {launches['keys']} "
          f"(from keys), B1 {launches['fused_ingest']}", flush=True)
    if launches["keys"] != REQ_BATCHES or launches["fused_ingest"] == 0:
        _fail(f"multi-table launches {launches}")
    # every request of a batch waits the batch's wall time
    lat = 1e3 * np.repeat(walls, REQ_ROWS)
    print(f"multi-table request latency (device-routed, {lat.size} requests "
          f"in {len(walls)} batches, query + ingest): p50 "
          f"{np.percentile(lat, 50):.3f} ms, p99 {np.percentile(lat, 99):.3f} "
          f"ms; batch walls {[round(1e3 * w, 3) for w in walls]}", flush=True)
    for path, names in (("device", ("query.route", "route.device",
                                    "query.scatter", "ingest", "request")),
                        ("host", ("query.route", "query.compute",
                                  "query.scatter"))):
        spans = tels[path].metrics.histogram(
            "span_seconds", unit="s", labels=("name", "kind"))
        for name in names:
            kind = "device" if name in ("route.device", "query.compute",
                                        "ingest") else "host"
            print(f"multi-table {path} path span {name}: mean "
                  f"{1e3 * spans.mean(name=name, kind=kind):.3f} ms over "
                  f"{int(spans.count(name=name, kind=kind))}", flush=True)

    # the served store's primary state == B1's plain version over the same
    # batches
    del store._apply_ingest
    ref = store._init_state()
    ref_flat = [t.flatten(0, 1) for t in ref.arrays()]
    for key, ts, lanes in applied:
        fused_ingest_ref(*ref_flat, key, ts, lanes,
                         bucket_size=store.bucket_size)
    errs = [_max_abs_err(a, b) for a, b in zip(store.state.arrays(),
                                               ref.arrays())]
    if any(e != 0.0 for e in errs):
        _fail(f"multi-table primary state differs from B1's plain version: "
              f"{errs}")
    print(f"multi-table primary state ({len(applied)} batches) == B1's plain "
          "version: six arrays bit-exact", flush=True)
    del ref, ref_flat, applied
    print(f"multi-table peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    trace_request(svc, _mt_requests(rng, DAY + 3600, NUM_CARDS), results,
                  key="trace_multitable")
    del svc, store, single
    torch.cuda.empty_cache()

    # modulo routing at 2^16 accounts: B2 ranks from the shard ids
    svc = FeatureService.build(
        "multitable_mod", sharded_view(), num_keys=MT_MOD_ACCOUNTS,
        sharded=True, num_shards=NUM_SHARDS, hash_routing=False,
        mode="preagg", device=dev, **kw)
    single = OnlineFeatureStore(sharded_view(), num_keys=MT_MOD_ACCOUNTS,
                                device=dev, **kw)
    tables = multitable_stream(rng, MT_MOD_ROWS, num_accounts=MT_MOD_ACCOUNTS,
                               num_merchants=MT_MERCHANTS, t_max=DAY)
    _mt_ingest(svc.store, (single,), tables, MT_MOD_SLICES, launches)
    del tables
    _mt_serve(svc, single, rng, DAY, MT_MOD_ACCOUNTS, REQ_BATCHES, launches,
              tels, "shards")
    pad = tels["device"].metrics.counter(
        "padding_rows_total", unit="1", labels=("layer",))
    pad_before = pad.value(layer="shard")
    counts, _ = _mt_serve(svc, single, rng, DAY + 60 * REQ_BATCHES,
                          MT_MOD_ACCOUNTS, 1, launches, tels, "shards",
                          strided=True)
    B = svc.store._route_bucket(REQ_ROWS)
    if counts[0] != REQ_ROWS or counts[0] <= B:
        _fail(f"the strided batch did not collapse onto shard 0: {counts}")
    # the re-dispatch at B = N pads every shard to N rows
    if pad.value(layer="shard") - pad_before != NUM_SHARDS * REQ_ROWS - REQ_ROWS:
        _fail("the strided batch did not re-dispatch at B = N")
    print(f"modulo routing ({MT_MOD_ACCOUNTS} accounts, {NUM_SHARDS} shards): "
          f"{REQ_BATCHES} batches + 1 strided batch (all accounts ≡ 0 mod "
          f"{NUM_SHARDS}: {counts[0]} rows on shard 0 > optimistic B = {B}, "
          f"re-dispatched at B = {REQ_ROWS}) device-routed == host-routed == "
          f"single-device == B2-plain, bit for bit; B2 from shard ids "
          f"{launches['shards']} launches, from keys {launches['keys']} in "
          "all", flush=True)
    if launches["shards"] != REQ_BATCHES + 1 or launches["keys"] != REQ_BATCHES:
        _fail(f"modulo routing launches {launches}")
    del svc, single
    torch.cuda.empty_cache()

    # each path's own counts: ``launches`` stays the main path's
    results["fused_ingest"]["launches_multitable"] = launches["fused_ingest"]
    results["route_rank"]["launches_multitable_keys"] = launches["keys"]
    results["route_rank"]["launches_modulo_shards"] = launches["shards"]

    # offline <-> online consistency of the multi-table view on the card
    tables = multitable_stream(rng, VERIFY_ROWS, num_accounts=MT_VERIFY_ACCOUNTS,
                               num_merchants=MT_VERIFY_MERCHANTS, t_max=DAY)
    tx = tables.pop("transactions")
    per = np.bincount(tables["wires"]["account"], minlength=MT_VERIFY_ACCOUNTS)
    print(f"multi-table consistency: {len(tx['ts'])} transactions on "
          f"{MT_VERIFY_ACCOUNTS} accounts over a day, wires {per.max()} on "
          f"the busiest account (ring {STORE_KW['capacity']})", flush=True)
    for mode, routing in (("preagg", True), ("naive", False)):
        t0 = time.perf_counter()
        rep = verify_view(
            multi_table_view(), tx, num_keys=MT_VERIFY_ACCOUNTS,
            secondary=tables,
            secondary_num_keys={"merchants": MT_VERIFY_MERCHANTS},
            num_shards=NUM_SHARDS, mode=mode, device_routing=routing,
            device=dev, **STORE_KW)
        print(f"{rep.summary()} in {time.perf_counter() - t0:.1f} s: "
              f"per feature {rep.per_feature}", flush=True)
        if not rep.passed:
            _fail(f"verify_view of the multi-table view ({rep.mode}) failed")



# ---------------------------------------------------------------------------
# multi-scenario plane
# ---------------------------------------------------------------------------


def _ms_batch(rng, t_lo, accounts, names, only=None):
    """A mixed request batch: ``_mt_requests`` rows and per-row scenario
    tags, uniform over ``names`` (all ``only`` when given)."""
    rows = _mt_requests(rng, t_lo, accounts)
    pick = rng.integers(0, len(names), REQ_ROWS)
    tags = np.array([names[i] for i in pick]) if only is None else \
        np.full(REQ_ROWS, only)
    return rows, tags


def _ms_groups(rows, tags, names):
    """Each scenario's rows of a mixed batch, in submission order, and the
    batch's ingest groups as ``request_mixed`` ingests them: scenario
    order, each group (key, ts)-sorted."""
    per = {s: {c: v[tags == s] for c, v in rows.items()} for s in names
           if (tags == s).any()}
    return per, [_by_key(g, "account") for g in per.values()]


def _ms_serve(svc, routers, rng, t_lo, accounts, batches, launches, tels,
              variant, saved=None, only=None):
    """Serve ``batches`` mixed batches through ``routers["device"]``
    (``svc``: device-routed, ingest on).  Before each is ingested, its
    answers must equal, bit for bit, ``routers["host"]``'s (a second
    service over the same plane, served with ``device_routing=False``:
    one program a scenario group, ingest off) and the mixed answers with
    B2's plain composition swapped in; both routers' per-(scenario,
    shard) histograms must stay equal; the pump must be one
    ``route.device`` span and one B2 launch (``variant``), and B1's count
    must rise.  ``saved`` (a list) gains each batch's rows, tags and
    answers.  Returns each pump's wall seconds."""
    from repro_torch import kernels
    from repro_torch.core import shard as shard_mod
    from repro_torch.kernels.route.ref import route_keys_ref, route_rank_ref
    from repro_torch.obs import Telemetry, use_telemetry

    plane, store = svc.plane, svc.store
    names = plane.scenarios
    kernel_fns = (shard_mod.route_keys, shard_mod.route_rank)

    def plain_route_keys(key, valid, perm, *, num_shards):
        return route_keys_ref(key, valid, perm, num_shards)

    def plain_route_rank(shard, *, num_shards):
        return route_rank_ref(shard, num_shards)

    def submit(router, rows, tags):
        for i in range(REQ_ROWS):
            router.submit({c: v[i] for c, v in rows.items()},
                          scenario=str(tags[i]))

    dspans = tels["device"].metrics.histogram(
        "span_seconds", unit="s", labels=("name", "kind"))
    walls = []
    for b in range(batches):
        rows, tags = _ms_batch(rng, t_lo + 60 * b, accounts, names, only)
        b2_before = dict(kernels.VARIANT_LAUNCHES["route_rank"])
        store.device_routing = False
        try:
            with use_telemetry(tels["host"]):
                submit(routers["host"], rows, tags)
                host = routers["host"].pump(flush=True)
        finally:
            store.device_routing = True
        shard_mod.route_keys, shard_mod.route_rank = (plain_route_keys,
                                                      plain_route_rank)
        try:
            with use_telemetry(Telemetry()):
                plain = {s: _np_answers(o) for s, o in plane.query_mixed(
                    dict(rows), tags, mode="preagg").items()}
        finally:
            shard_mod.route_keys, shard_mod.route_rank = kernel_fns
        if kernels.VARIANT_LAUNCHES["route_rank"] != b2_before:
            _fail("the host-routed and plain answers launched B2")
        with use_telemetry(tels["device"]):
            submit(routers["device"], rows, tags)
        n_dev = dspans.count(name="route.device", kind="device")
        b1 = kernels.LAUNCHES["fused_ingest"]
        t0 = time.perf_counter()
        with use_telemetry(tels["device"]):
            got = routers["device"].pump(flush=True)
        walls.append(time.perf_counter() - t0)
        n_dev = dspans.count(name="route.device", kind="device") - n_dev
        if n_dev != 1:
            _fail(f"batch {b}: {n_dev} route.device spans in one mixed pump")
        n_b1 = kernels.LAUNCHES["fused_ingest"] - b1
        launches["fused_ingest"] += n_b1
        if n_b1 == 0:
            _fail(f"batch {b}: the mixed pump's ingest did not launch B1")
        after = kernels.VARIANT_LAUNCHES["route_rank"]
        n_b2 = {v: after[v] - b2_before[v] for v in after}
        launches[variant] += n_b2[variant]
        if n_b2[variant] != 1 or sum(n_b2.values()) != 1:
            _fail(f"batch {b}: B2 launched {n_b2} in one mixed dispatch, "
                  f"expected one from {variant}")
        present = sorted(set(tags.tolist()))
        for name, want in (("host-routed", host), ("B2-plain", plain)):
            if sorted(want) != present or sorted(got) != present:
                _fail(f"batch {b}: scenarios answered: device {sorted(got)}, "
                      f"{name} {sorted(want)}, sent {present}")
            for sc in present:
                bad = _same_bits(want[sc], got[sc])
                if bad is not None:
                    x, y = np.asarray(want[sc][bad]), np.asarray(got[sc][bad])
                    i = int(np.flatnonzero(
                        x.view(np.uint8) != y.view(np.uint8))[0]
                        // x.itemsize) if x.shape == y.shape else 0
                    _fail(f"batch {b} {sc}/{bad}: mixed answers differ from "
                          f"the {name} answers (first at row {i}: "
                          f"{y.reshape(-1)[i]!r} vs {x.reshape(-1)[i]!r})")
        for sc, feats in got.items():
            n = int((tags == sc).sum())
            for f, v in feats.items():
                if v.shape != (n,) or not np.all(np.isfinite(v)):
                    _fail(f"batch {b} {sc}/{f}: shape {v.shape} or "
                          "non-finite")
        hd = routers["device"].scenario_shard_histogram()
        hh = routers["host"].scenario_shard_histogram()
        if any(not np.array_equal(hd[sc], hh[sc]) for sc in names):
            _fail(f"batch {b}: (scenario, shard) histograms differ: device "
                  f"{hd} host {hh}")
        if saved is not None:
            saved.append((rows, tags, got))
    return walls


def _ms_routers(svc, host_svc):
    from repro_torch.serve.router import ShardRouter
    from repro_torch.serve.service import BatchScheduler

    def sched():
        return BatchScheduler(buckets=(REQ_ROWS,), max_batch=REQ_ROWS)

    return {"device": ShardRouter(svc, sched()),
            "host": ShardRouter(host_svc, sched(), ingest=False)}


def multiscenario_path(results) -> None:
    """The multi-scenario plane at deployment size: the three views of
    ``multi_scenario_views()`` on one sharded store (2^19 accounts x 8
    shards), mixed batches through the scenario-aware ``ShardRouter``
    (one device-routed dispatch a pump) == the host-routed oracle == the
    B2-plain composition, bit for bit; then each scenario's dedicated
    store, fed the same stream, == the plane's saved answers; then modulo
    routing at 2^16 accounts."""
    from repro_torch import kernels
    from repro_torch.core.online import OnlineFeatureStore
    from repro_torch.data.synthetic import multitable_stream
    from repro_torch.obs import Telemetry, use_telemetry
    from repro_torch.scenarios import multi_scenario_views
    from repro_torch.serve.service import (
        SCENARIO_COL,
        FeatureService,
        MultiScenarioService,
        ServiceStats,
    )

    dev = "cuda"
    kw = dict(secondary_num_keys={"merchants": MT_MERCHANTS}, **STORE_KW)
    rng = np.random.default_rng(SEED + 7)
    torch.cuda.reset_peak_memory_stats()
    views = multi_scenario_views()
    svc = FeatureService.build_multi(
        "plane", views, num_keys=NUM_CARDS, sharded=True,
        num_shards=NUM_SHARDS, mode="preagg", device=dev, **kw)
    store = svc.store
    names = svc.scenarios
    host_svc = MultiScenarioService("plane_host", svc.plane, mode="preagg")
    plane_bytes = _ring_bytes(store)
    for name, nbytes in plane_bytes.items():
        print(f"multi-scenario plane: {name} {nbytes / 1e9:.4f} GB",
              flush=True)
    print(f"multi-scenario plane: {sum(plane_bytes.values()) / 1e9:.3f} GB "
          f"in all ({len(names)} scenarios {names}, {NUM_SHARDS} shards x "
          f"{store.num_keys} accounts, {store.num_lanes} primary lanes)",
          flush=True)

    tables = multitable_stream(rng, MT_ROWS, num_accounts=NUM_CARDS,
                               num_merchants=MT_MERCHANTS, t_max=DAY)
    kernels.reset_launches()
    launches = {"fused_ingest": 0, "keys": 0, "shards": 0}
    secs, rows_in = _mt_ingest(store, (), tables, WARM_SLICES, launches)
    for t in rows_in:
        print(f"multi-scenario ingest {t}: {rows_in[t]} rows in "
              f"{secs[t]:.3f} s = {rows_in[t] / secs[t]:.0f} rows/s "
              "(fenced; once for all scenarios)", flush=True)

    batches = REQ_BATCHES + 1
    svc.stats = ServiceStats(window=batches * REQ_ROWS)
    tels = {"host": Telemetry(), "device": Telemetry()}
    routers = _ms_routers(svc, host_svc)
    saved = []
    walls = _ms_serve(svc, routers, rng, DAY, NUM_CARDS, REQ_BATCHES,
                      launches, tels, "keys", saved)
    # one more batch of one scenario: the other two are absent
    walls += _ms_serve(svc, routers, rng, DAY + 60 * REQ_BATCHES, NUM_CARDS,
                       1, launches, tels, "keys", saved, only=names[1])
    print(f"multi-scenario: served {batches} mixed batches x {REQ_ROWS} rows "
          f"({REQ_BATCHES} over {len(names)} scenarios, 1 of {names[1]} "
          "alone): device-routed == host-routed oracle == B2-plain, bit for "
          "bit; (scenario, shard) histograms equal; one route.device span "
          f"and one B2 launch a pump; B2 {launches['keys']} (from keys), B1 "
          f"{launches['fused_ingest']}", flush=True)
    if launches["keys"] != batches:
        _fail(f"multi-scenario launches {launches}")
    hist = routers["device"].scenario_shard_histogram()
    print("multi-scenario (scenario, shard) histogram: " + "; ".join(
        f"{s} {h.tolist()}" for s, h in hist.items()), flush=True)
    st = svc.stats
    if st.requests != batches * REQ_ROWS or st.batches != batches:
        _fail(f"service stats count {st.requests} requests in {st.batches} "
              "batches")
    lat = 1e3 * np.repeat(walls, REQ_ROWS)
    print(f"multi-scenario request latency ({st.requests} requests in "
          f"{st.batches} mixed batches, query + ingest): ServiceStats p50 "
          f"{st.request_p50_ms:.3f} ms, p99 {st.request_p99_ms:.3f} ms; "
          f"fenced pump walls p50 {np.percentile(lat, 50):.3f} ms, p99 "
          f"{np.percentile(lat, 99):.3f} ms "
          f"{[round(1e3 * w, 3) for w in walls]}", flush=True)
    for path, names_ in (("device", ("query.route", "route.device",
                                     "query.scatter", "ingest", "request")),
                         ("host", ("query.route", "query.compute",
                                   "query.scatter", "request"))):
        spans = tels[path].metrics.histogram(
            "span_seconds", unit="s", labels=("name", "kind"))
        for name in names_:
            kind = "device" if name in ("route.device", "query.compute",
                                        "ingest") else "host"
            print(f"multi-scenario {path} path span {name}: mean "
                  f"{1e3 * spans.mean(name=name, kind=kind):.3f} ms over "
                  f"{int(spans.count(name=name, kind=kind))}", flush=True)

    counts = svc.plane.ingest_row_counts()
    n_tx = len(tables["transactions"]["ts"]) + batches * REQ_ROWS
    want = {"transactions": n_tx, "wires": len(tables["wires"]["ts"]),
            "accounts": NUM_SHARDS * len(tables["accounts"]["ts"]),
            "merchants": NUM_SHARDS * len(tables["merchants"]["ts"])}
    if counts != want:
        _fail(f"ingest_row_counts {counts}, expected {want}")
    print(f"multi-scenario ingest_row_counts {counts}: transactions and "
          f"wires once, accounts and merchants x {NUM_SHARDS} (replicated, "
          "one copy on the card)", flush=True)
    print(f"multi-scenario peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)

    rows, tags = _ms_batch(rng, DAY + 3600, NUM_CARDS, names)
    rows[SCENARIO_COL] = tags
    trace_request(svc, rows, results, key="trace_multiscenario",
                  serve=lambda cols: svc.request_mixed(cols, ingest=False))

    # each scenario's dedicated store, one at a time: the same day and the
    # same request rows in the same order; its answers == the plane's
    ded_bytes = {}
    for v in views:
        ded = OnlineFeatureStore(v, num_keys=NUM_CARDS, device=dev, **kw)
        ded_bytes[v.name] = sum(_ring_bytes(ded).values())
        _mt_ingest(ded, (), tables, WARM_SLICES, {"fused_ingest": 0})
        n_rows = 0
        for b, (rows_b, tags_b, got) in enumerate(saved):
            per, groups = _ms_groups(rows_b, tags_b, names)
            if v.name in per:
                with use_telemetry(Telemetry()):
                    one = _np_answers(ded.query(dict(per[v.name]),
                                                mode="preagg"))
                bad = _same_bits(one, got[v.name])
                if bad is not None:
                    _fail(f"batch {b} {v.name}/{bad}: the plane's answers "
                          "differ from the dedicated store's")
                n_rows += len(per[v.name]["ts"])
            for g in groups:
                ded.ingest(g)
        print(f"multi-scenario: dedicated {v.name} store "
              f"({ded_bytes[v.name] / 1e9:.3f} GB) == the plane, bit for "
              f"bit, on {n_rows} requests in {len(saved)} batches",
              flush=True)
        del ded
        torch.cuda.empty_cache()
    total = sum(plane_bytes.values())
    print(f"multi-scenario bytes: plane {total / 1e9:.3f} GB against "
          f"{sum(ded_bytes.values()) / 1e9:.3f} GB for the "
          f"{len(views)} dedicated stores "
          f"({', '.join(f'{n} {b / 1e9:.3f}' for n, b in ded_bytes.items())})"
          f"; peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)
    del tables, saved, svc, host_svc, routers, store
    torch.cuda.empty_cache()

    # modulo routing at 2^16 accounts: B2 ranks from the shard ids
    svc = FeatureService.build_multi(
        "plane_mod", views, num_keys=MT_MOD_ACCOUNTS, sharded=True,
        num_shards=NUM_SHARDS, hash_routing=False, mode="preagg", device=dev,
        **kw)
    host_svc = MultiScenarioService("plane_mod_host", svc.plane,
                                    mode="preagg")
    tables = multitable_stream(rng, MT_MOD_ROWS, num_accounts=MT_MOD_ACCOUNTS,
                               num_merchants=MT_MERCHANTS, t_max=DAY)
    _mt_ingest(svc.store, (), tables, MT_MOD_SLICES, launches)
    del tables
    _ms_serve(svc, _ms_routers(svc, host_svc), rng, DAY, MT_MOD_ACCOUNTS,
              MS_MOD_BATCHES, launches, tels, "shards")
    print(f"multi-scenario modulo routing ({MT_MOD_ACCOUNTS} accounts): "
          f"{MS_MOD_BATCHES} mixed batches device == host == B2-plain; B2 "
          f"from shard ids {launches['shards']}, from keys "
          f"{launches['keys']} in all", flush=True)
    if launches["shards"] != MS_MOD_BATCHES or launches["keys"] != batches:
        _fail(f"multi-scenario modulo routing launches {launches}")
    del svc, host_svc
    torch.cuda.empty_cache()
    results["fused_ingest"]["launches_multiscenario"] = launches["fused_ingest"]
    results["route_rank"]["launches_multiscenario"] = launches["keys"]
    results["route_rank"]["launches_multiscenario_shards"] = launches["shards"]


# ---------------------------------------------------------------------------
# hot deploy and the offline bridge
# ---------------------------------------------------------------------------


def _flat_tensors(store):
    """(name, tensor) of every state buffer of a store, flat (a
    replicated ring's one copy), the merge-order families included."""
    s = store._flat_state()
    out = [("ring_ts", s.ring.ts), ("ring_vals", s.ring.vals),
           ("cursor", s.ring.cursor), ("bstats", s.bagg.stats),
           ("bbitmap", s.bagg.bitmap), ("bbucket", s.bagg.bucket)]
    out += [(f"b{f}", t) for f, t in s.bagg.families().items()]
    for i, (p, r) in enumerate(zip(store.layout.tables, s.sec)):
        out += [(f"{p.table}[{i}].ts", r.ts), (f"{p.table}[{i}].vals", r.vals),
                (f"{p.table}[{i}].cursor", r.cursor)]
    return out


def _outside_contract(store, tx, slices):
    """Flat (key, bucket slot) cells whose (account, bucket) pair the
    migration's exactness contract does not cover: its rows arrive over
    two or more of the day's ingest slices, and a later slice brings two
    or more (the fold then associates per batch, not per row)."""
    ts = tx["ts"].astype(np.int64)
    batch = np.searchsorted(np.array([(i + 1) * DAY // slices
                                      for i in range(slices)]), ts,
                            side="right")
    bucket = ts // store.bucket_size
    pair = tx["account"].astype(np.int64) * (int(bucket.max()) + 1) + bucket
    o = np.lexsort((batch, pair))
    p, b = pair[o], batch[o]
    grp = np.ones(len(p), bool)
    grp[1:] = (p[1:] != p[:-1]) | (b[1:] != b[:-1])
    starts = np.flatnonzero(grp)
    n = np.diff(np.append(starts, len(p)))
    gp, gb = p[starts], b[starts]
    first = np.ones(len(gp), bool)
    first[1:] = gp[1:] != gp[:-1]
    bad = np.unique(gp[~first & (n >= 2)])
    acct = bad // (int(bucket.max()) + 1)
    bk = bad % (int(bucket.max()) + 1)
    if not len(bad):
        return set(), 0
    s_ids, l_ids = store._route_ids(acct)
    flat = s_ids * store.num_keys + l_ids
    return set((flat * store.num_buckets + bk % store.num_buckets).tolist()), \
        len(bad)


def _hot_equals_cold(hot, cold, tag, outside=frozenset()):
    """Every state buffer of two stores bit for bit; bucket cells may
    differ only where ``outside`` (cells outside the exactness contract)
    says so.  Returns the number of differing bucket cells."""
    nb = hot.num_buckets
    cells = 0
    for (name, a), (_, b) in zip(_flat_tensors(hot), _flat_tensors(cold)):
        if a.shape != b.shape:
            _fail(f"{tag}: {name} shapes {tuple(a.shape)} vs {tuple(b.shape)}")
        av = a.view(torch.int32) if a.dtype == torch.float32 else a
        bv = b.view(torch.int32) if b.dtype == torch.float32 else b
        if torch.equal(av, bv):
            continue
        if name not in ("bstats", "bbitmap"):
            _fail(f"{tag}: hot and cold {name} differ")
        ne = (av != bv).reshape(a.shape[0] * nb, -1).any(dim=1)
        bad = torch.nonzero(ne)[:, 0].cpu().numpy()
        inside = [int(c) for c in bad if int(c) not in outside]
        if inside:
            c = inside[0]
            _fail(f"{tag}: hot and cold {name} differ at {len(inside)} "
                  f"(key, bucket) cells inside the exactness contract (first:"
                  f" flat key {c // nb}, slot {c % nb})")
        cells += len(bad)
    return cells


def _span_line(tel, names, tag):
    spans = tel.metrics.histogram("span_seconds", unit="s",
                                  labels=("name", "kind"))
    parts = []
    for name, kind in names:
        n = int(spans.count(name=name, kind=kind))
        if n:
            parts.append(f"{name} {1e3 * spans.mean(name=name, kind=kind) * n:.3f}"
                         f" ms" + (f" ({n})" if n > 1 else ""))
    print(f"{tag}: " + ", ".join(parts), flush=True)


_MIGRATE_SPANS = (
    ("hot_deploy", "host"), ("hot_deploy.plan", "host"),
    ("migrate.diff", "host"), ("migrate", "host"), ("migrate.carry", "host"),
    ("migrate.relane", "host"), ("migrate.relay", "host"),
    ("migrate.synthesize", "host"), ("migrate.bucket", "host"),
    ("migrate.reroute", "host"), ("migrate.fresh", "host"),
    ("backfill", "device"), ("backfill.ring", "host"),
    ("backfill.bucket", "host"), ("migrate.place", "device"),
    ("hot_deploy.compile", "host"),
)


def _deploy(deploy, tag, *args, **kw):
    """Run a fenced hot deploy (a service's ``hot_deploy`` or a plane's
    ``evolve``) under its own telemetry; returns (report, seconds, tel)."""
    from repro_torch.obs import Telemetry, use_telemetry

    tel = Telemetry()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with use_telemetry(tel):
        report = deploy(*args, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    _span_line(tel, _MIGRATE_SPANS, f"{tag} spans")
    return report, wall, tel


def _cold(views, accounts, tables, extra, kw, tag):
    """A cold plane of ``views`` fed the day (and ``extra`` primary ingest
    batches after it); returns (plane, fenced seconds)."""
    from repro_torch.core.scenario import ScenarioPlane

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cold = ScenarioPlane(views, num_keys=accounts, num_shards=NUM_SHARDS,
                         device="cuda", **kw)
    _mt_ingest(cold.store, (), tables, WARM_SLICES, {"fused_ingest": 0})
    for g in extra:
        cold.ingest(g)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(f"{tag}: cold build + replay of the day {wall:.3f} s", flush=True)
    return cold, wall


def _state_gb(store):
    return sum(t.untyped_storage().nbytes()
               for _, t in _flat_tensors(store)) / 1e9


def deploy_path(results) -> None:
    """Hot deploy and the offline bridge at deployment size: (a) scenario
    #3 hot-added to a warm 2^19-account plane, == a cold plane replaying
    the day, bit for bit, then 8 mixed batches on both; (b) derived lanes
    with a capacity grow; (c) a Signature lane beyond the rings' horizon,
    refused without a source and exact with one; (d) the training-set
    export against the B4-plain swap, and verify_export in both
    routings."""
    from repro_torch import kernels
    from repro_torch.core import windows as win
    from repro_torch.core.expr import (
        Col, Signature, collect_window_aggs, range_window, w_count, w_max,
        w_mean, w_sum,
    )
    from repro_torch.core.scenario import ScenarioPlane
    from repro_torch.core.view import FeatureView
    from repro_torch.data.synthetic import MULTITABLE_DB, multitable_stream
    from repro_torch.kernels.window_agg.ref import fold_levels_ref
    from repro_torch.obs import Telemetry, use_telemetry
    from repro_torch.offline import (
        BackfillSource, export_training_set, verify_export,
    )
    from repro_torch.scenarios import multi_scenario_views, multi_table_view
    from repro_torch.serve.router import ShardRouter
    from repro_torch.serve.service import (
        BatchScheduler, FeatureService, MultiScenarioService,
    )

    kw = dict(secondary_num_keys={"merchants": MT_MERCHANTS}, **STORE_KW)
    tables = multitable_stream(np.random.default_rng(SEED + 7), MT_ROWS,
                               num_accounts=NUM_CARDS,
                               num_merchants=MT_MERCHANTS, t_max=DAY)
    tx = tables["transactions"]
    rng = np.random.default_rng(SEED + 8)
    views = multi_scenario_views()
    launches = {"fused_ingest": 0, "keys": 0, "shards": 0}
    phase_t0 = time.perf_counter()

    # -- (a) hot add of scenario #3 -------------------------------------------
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    svc = FeatureService.build_multi(
        "hot", views[:2], num_keys=NUM_CARDS, sharded=True,
        num_shards=NUM_SHARDS, mode="preagg", device="cuda", **kw)
    store = svc.store
    _mt_ingest(store, (), tables, WARM_SLICES, launches)
    sched = (lambda: BatchScheduler(buckets=(REQ_ROWS,), max_batch=REQ_ROWS))
    warm_groups = []
    router = ShardRouter(svc, sched())
    names2 = svc.scenarios
    for b in range(DEPLOY_WARM_BATCHES):
        rows, tags = _ms_batch(rng, DAY + 60 * b, NUM_CARDS, names2)
        for i in range(REQ_ROWS):
            router.submit({c: v[i] for c, v in rows.items()},
                          scenario=str(tags[i]))
        b1 = kernels.LAUNCHES["fused_ingest"]
        b2 = kernels.VARIANT_LAUNCHES["route_rank"]["keys"]
        with use_telemetry(Telemetry()):
            router.pump(flush=True)
        launches["fused_ingest"] += kernels.LAUNCHES["fused_ingest"] - b1
        launches["keys"] += kernels.VARIANT_LAUNCHES["route_rank"]["keys"] - b2
        warm_groups += _ms_groups(rows, tags, names2)[1]
    before = svc.plane.ingest_row_counts()
    bufs = {n: t.data_ptr() for n, t in _flat_tensors(store)}
    plane_gb = _state_gb(store)
    report, hot_s, _ = _deploy(svc.hot_deploy, "deploy (a)", views[2])
    if not report.exact:
        _fail(f"deploy (a) inexact: {report.describe()}")
    if svc.plane.ingest_row_counts() != before:
        _fail(f"deploy (a) re-ingested: {svc.plane.ingest_row_counts()} vs "
              f"{before}")
    kept = [n for n, t in _flat_tensors(store) if bufs.get(n) == t.data_ptr()]
    print(f"deploy (a): hot_deploy({views[2].name}) onto {names2} at "
          f"{NUM_CARDS} accounts x {NUM_SHARDS} shards ({plane_gb:.3f} GB): "
          f"exact; fenced wall {1e3 * hot_s:.3f} ms; carried {report.carried}"
          f"; migrated {report.migrated}; fresh {report.fresh}; new programs "
          f"{report.new_programs}; {len(kept)} of {len(bufs)} buffers kept "
          f"their data_ptr(); ingest_row_counts unchanged {before}",
          flush=True)
    cold, cold_s = _cold(views, NUM_CARDS, tables, warm_groups, kw,
                         "deploy (a)")
    cells = _hot_equals_cold(store, cold.store, "deploy (a)")
    print(f"deploy (a): hot == cold, {len(_flat_tensors(store))} buffers bit "
          f"for bit ({cells} differing cells); hot_deploy "
          f"{1e3 * hot_s:.3f} ms against the cold build + replay "
          f"{1e3 * cold_s:.3f} ms; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    # 8 mixed batches over all three scenarios: hot (== host-routed router
    # == B2-plain), then the same rows on the cold plane
    host_svc = MultiScenarioService("hot_host", svc.plane, mode="preagg")
    routers = _ms_routers(svc, host_svc)
    saved = []
    tels = {"host": Telemetry(), "device": Telemetry()}
    _ms_serve(svc, routers, rng, DAY + 3600, NUM_CARDS, REQ_BATCHES,
              launches, tels, "keys", saved)
    cold_svc = MultiScenarioService("cold", cold, mode="preagg")
    cold_router = ShardRouter(cold_svc, sched())
    names = cold_svc.scenarios
    for b, (rows, tags, got) in enumerate(saved):
        for i in range(REQ_ROWS):
            cold_router.submit({c: v[i] for c, v in rows.items()},
                               scenario=str(tags[i]))
        b2 = kernels.VARIANT_LAUNCHES["route_rank"]["keys"]
        b1 = kernels.LAUNCHES["fused_ingest"]
        with use_telemetry(Telemetry()):
            want = cold_router.pump(flush=True)
        n_b2 = kernels.VARIANT_LAUNCHES["route_rank"]["keys"] - b2
        launches["keys"] += n_b2
        launches["fused_ingest"] += kernels.LAUNCHES["fused_ingest"] - b1
        if n_b2 != 1 or kernels.LAUNCHES["fused_ingest"] == b1:
            _fail(f"deploy (a) cold batch {b}: B2 {n_b2}, B1 did not rise")
        if sorted(want) != sorted(got):
            _fail(f"deploy (a) batch {b}: scenarios {sorted(got)} vs "
                  f"{sorted(want)}")
        for sc in got:
            bad = _same_bits(want[sc], got[sc])
            if bad is not None:
                _fail(f"deploy (a) batch {b} {sc}/{bad}: hot != cold")
    _hot_equals_cold(store, cold.store, "deploy (a) after serving")
    print(f"deploy (a): {REQ_BATCHES} mixed batches over {names}: hot == "
          "host-routed router == B2-plain == cold plane, bit for bit; one "
          "B2 launch a pump; states still equal after their ingest",
          flush=True)
    del svc, host_svc, router, routers, cold_svc, cold_router, cold, store
    del saved
    torch.cuda.empty_cache()

    # -- (b) derived lanes with a capacity grow -------------------------------
    amt, w1h = Col("amount"), range_window(3600, bucket=64)
    va = FeatureView("va", features={
        "out": w_sum(amt, w1h, union=("wires",)), "cnt": w_count(amt, w1h)},
        database=MULTITABLE_DB)
    vb = FeatureView("vb", features={
        "dbl": w_sum(amt * 2.0, w1h), "mx": w_max(amt * 2.0, w1h),
        "big": w_mean(amt > 20.0, w1h)}, database=MULTITABLE_DB)
    from repro_torch.core.scenario import ScenarioPlane

    acc_b = DEPLOY_B_ACCOUNTS
    tables_b = tables if acc_b == NUM_CARDS else multitable_stream(
        np.random.default_rng(SEED + 9), MT_ROWS * acc_b // NUM_CARDS,
        num_accounts=acc_b, num_merchants=MT_MERCHANTS, t_max=DAY)
    torch.cuda.reset_peak_memory_stats()
    hot = ScenarioPlane([va], num_keys=acc_b, num_shards=NUM_SHARDS,
                        device="cuda", **kw)
    _mt_ingest(hot.store, (), tables_b, WARM_SLICES, launches)
    old_gb = _state_gb(hot.store)
    report, hot_s, _ = _deploy(hot.evolve, "deploy (b)", [va, vb],
                               capacity=DEPLOY_B_CAPACITY)
    if not report.exact or not report.synthesized_lanes:
        _fail(f"deploy (b): {report.describe()}")
    torch.cuda.empty_cache()
    new_gb = _state_gb(hot.store)
    mig_peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"deploy (b): [va] -> [va, vb] at {acc_b} accounts (the full "
          f"count: no cut), ring {STORE_KW['capacity']} -> "
          f"{DEPLOY_B_CAPACITY}: exact; synthesized "
          f"{report.synthesized_lanes}; migrated {report.migrated}; carried "
          f"{report.carried}; state {old_gb:.3f} -> {new_gb:.3f} GB, peak in "
          f"the migration {mig_peak:.2f} GB; fenced wall {1e3 * hot_s:.3f} ms",
          flush=True)
    cold, cold_s = _cold([va, vb], acc_b, tables_b, (),
                         dict(kw, capacity=DEPLOY_B_CAPACITY), "deploy (b)")
    outside, n_pairs = _outside_contract(hot.store, tables_b["transactions"],
                                         WARM_SLICES)
    cells = _hot_equals_cold(hot.store, cold.store, "deploy (b)", outside)
    print(f"deploy (b): hot == cold bit for bit but {cells} bucket cells "
          f"(of the {n_pairs} (account, bucket) pairs outside the exactness "
          f"contract); hot {1e3 * hot_s:.3f} ms against cold "
          f"{1e3 * cold_s:.3f} ms; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    del hot, cold
    torch.cuda.empty_cache()

    # -- (c) backfill beyond the horizon --------------------------------------
    sig = Signature((Col("merchant"),), bits=8)
    mix = FeatureView("merchant_mix", features={
        "sig_cnt_1h": w_count(sig, w1h), "sig_sum_1h": w_sum(sig, w1h)},
        database=MULTITABLE_DB)
    kw_c = dict(kw, capacity=DEPLOY_C_CAPACITY)
    torch.cuda.reset_peak_memory_stats()
    hot = ScenarioPlane(views[:2], num_keys=NUM_CARDS, num_shards=NUM_SHARDS,
                        device="cuda", **kw_c)
    _mt_ingest(hot.store, (), tables, WARM_SLICES, launches)
    wrapped = int((hot.store.state.ring.cursor > DEPLOY_C_CAPACITY).sum())
    probe, _ = _ms_batch(rng, DAY + 7200, NUM_CARDS, hot.scenarios)
    with use_telemetry(Telemetry()):
        before = _np_answers(hot.query(views[0].name, dict(probe)))
    snap = {n: t.data_ptr() for n, t in _flat_tensors(hot.store)}
    try:
        hot.evolve(views[:2] + [mix], capacity=DEPLOY_C_GROWN)
        _fail("deploy (c): the Signature lane deployed without a source")
    except ValueError as e:
        if "backfill" not in str(e):
            _fail(f"deploy (c): refusal does not name backfill: {e}")
        refusal = str(e)
    with use_telemetry(Telemetry()):
        after = _np_answers(hot.query(views[0].name, dict(probe)))
    if _same_bits(before, after) is not None or hot.scenarios != [
            v.name for v in views[:2]] or snap != {
            n: t.data_ptr() for n, t in _flat_tensors(hot.store)}:
        _fail("deploy (c): the refused deploy changed the serving plane")
    print(f"deploy (c): {wrapped} of {NUM_CARDS} account rings of "
          f"{DEPLOY_C_CAPACITY} wrapped; deploying {mix.name} with rings of "
          f"{DEPLOY_C_GROWN} and no source refused ({refusal[:96]}...); the "
          "plane kept its buffers and answers", flush=True)
    src = BackfillSource(MULTITABLE_DB, tables)
    b1 = kernels.LAUNCHES["fused_ingest"]
    report, hot_s, tel = _deploy(hot.evolve, "deploy (c)", views[:2] + [mix],
                                 backfill=src, capacity=DEPLOY_C_GROWN)
    launches["fused_ingest"] += kernels.LAUNCHES["fused_ingest"] - b1
    if not report.exact or not report.backfilled:
        _fail(f"deploy (c): {report.describe()}")
    spans = tel.metrics.histogram("span_seconds", unit="s",
                                  labels=("name", "kind"))
    bf_ms = 1e3 * spans.mean(name="backfill", kind="device")
    print(f"deploy (c): with BackfillSource exact; backfilled "
          f"{len(report.backfilled)} deficits ({[b[:60] for b in report.backfilled]}); "
          f"B1 {kernels.LAUNCHES['fused_ingest'] - b1} launches in the "
          f"splice; peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)
    torch.cuda.empty_cache()
    cold, cold_s = _cold(views[:2] + [mix], NUM_CARDS, tables, (),
                         dict(kw, capacity=DEPLOY_C_GROWN), "deploy (c)")
    outside, n_pairs = _outside_contract(hot.store, tx, WARM_SLICES)
    cells = _hot_equals_cold(hot.store, cold.store, "deploy (c)", outside)
    print(f"deploy (c): hot == cold bit for bit but {cells} bucket cells "
          f"(of the {n_pairs} pairs outside the contract); backfill span "
          f"{bf_ms:.3f} ms, hot_deploy {1e3 * hot_s:.3f} ms against the cold "
          f"build + replay {1e3 * cold_s:.3f} ms", flush=True)
    del hot, cold, src
    torch.cuda.empty_cache()

    # -- (d) export ------------------------------------------------------------
    secondary = {t: tables[t] for t in ("wires", "accounts", "merchants")}
    kernel_fold = win.fold_levels

    def fold_levels_plain(x, seg, *, op):
        return fold_levels_ref(x, seg, op)

    b4_total = 0
    for view in (multi_table_view(), views[2]):
        b4 = kernels.LAUNCHES["fold_levels"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with use_telemetry(Telemetry()):
            ts_k = export_training_set(view, tx, n=EXPORT_LABELS, seed=5,
                                       secondary=secondary, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        n_b4 = kernels.LAUNCHES["fold_levels"] - b4
        b4_total += n_b4
        win.fold_levels = fold_levels_plain
        try:
            with use_telemetry(Telemetry()):
                ts_p = export_training_set(view, tx, label_rows=ts_k.rows,
                                           secondary=secondary, device="cuda")
        finally:
            win.fold_levels = kernel_fold
        bad = _same_bits(ts_k.features, ts_p.features)
        if bad is not None:
            _fail(f"export {view.name}/{bad} differs from the B4-plain run")
        for f, v in ts_k.features.items():
            if v.shape != (EXPORT_LABELS,) or not np.all(np.isfinite(v)):
                _fail(f"export {view.name}/{f}: shape {v.shape} or non-finite")
        folds = [f for f, e in view.features.items() if any(
            wa.agg.value in ("min", "max", "distinct_approx")
            for wa in collect_window_aggs([e]).values())]
        print(f"export {view.name}: {EXPORT_LABELS} labels of {len(tx['ts'])} "
              f"rows in {wall:.3f} s = {len(tx['ts']) / wall:.0f} history "
              f"rows/s ({EXPORT_LABELS / wall:.0f} labels/s); == the B4-plain "
              f"run bit for bit; B4 launched {n_b4} times (features through "
              f"it: {folds or 'none'})", flush=True)
    if b4_total == 0:
        _fail("export: B4 never launched")
    rng_v = np.random.default_rng(SEED + 10)
    vt = multitable_stream(rng_v, VERIFY_ROWS, num_accounts=MT_VERIFY_ACCOUNTS,
                           num_merchants=MT_VERIFY_MERCHANTS, t_max=DAY)
    sec_v = {t: vt[t] for t in ("wires", "accounts", "merchants")}
    view = multi_table_view()
    training = export_training_set(view, vt["transactions"],
                                   n=EXPORT_CHECK_LABELS, seed=3,
                                   secondary=sec_v, device="cuda")
    key_v, ts_v = vt["transactions"]["account"], vt["transactions"]["ts"]
    o = np.lexsort((ts_v, key_v))
    ks, tss = key_v[o], ts_v[o]
    newer = []
    for i in training.rows:
        lo, hi = np.searchsorted(ks, key_v[i], "left"), np.searchsorted(
            ks, key_v[i], "right")
        newer.append(hi - lo - np.searchsorted(tss[lo:hi], ts_v[i], "right"))
    beyond = int((np.asarray(newer) >= EXPORT_CHECK_CAPACITY).sum())
    print(f"verify_export: {beyond} of {len(training)} label rows lie beyond "
          f"the rings' {EXPORT_CHECK_CAPACITY}-row horizon by the end of the "
          "replay", flush=True)
    if beyond == 0 or beyond == len(training):
        _fail("verify_export: the labels do not straddle the horizon")
    for shards in (None, NUM_SHARDS):
        t0 = time.perf_counter()
        with use_telemetry(Telemetry()):
            chk = verify_export(
                view, vt["transactions"], training,
                num_keys=MT_VERIFY_ACCOUNTS, capacity=EXPORT_CHECK_CAPACITY,
                num_buckets=STORE_KW["num_buckets"],
                bucket_size=STORE_KW["bucket_size"], secondary=sec_v,
                secondary_num_keys={"merchants": MT_VERIFY_MERCHANTS},
                num_shards=shards, device="cuda")
        print(f"{chk.summary()} in {time.perf_counter() - t0:.1f} s; per "
              f"feature {chk.per_feature}", flush=True)
        if not chk.passed:
            _fail(f"verify_export (num_shards={shards}) failed")
    print(f"deploy phase: {time.perf_counter() - phase_t0:.1f} s; B1 "
          f"{launches['fused_ingest']}, B2 {launches['keys']} (from keys), "
          f"B4 {b4_total} launches", flush=True)
    results["fused_ingest"]["launches_deploy"] = launches["fused_ingest"]
    results["route_rank"]["launches_deploy"] = launches["keys"]
    results["fold_levels"]["launches_deploy"] = b4_total
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the merge-order bucket families
# ---------------------------------------------------------------------------


def _family_view():
    """``sharded_view()`` plus FIRST / LAST / TOPN_FREQ (n = 0, 1) over its
    1 h window: a layout with both merge-order bucket families."""
    from repro_torch.core.expr import (
        Col, range_window, w_first, w_last, w_topn_freq,
    )
    from repro_torch.core.view import FeatureView
    from repro_torch.scenarios import sharded_view

    base = sharded_view()
    w1h = range_window(3600, bucket=64)
    return FeatureView("families", features={
        **base.features,
        "first_amount_1h": w_first(Col("amount"), w1h),
        "last_amount_1h": w_last(Col("amount"), w1h),
        "top_merchant_1h": w_topn_freq(Col("merchant"), w1h, n=0),
        "second_merchant_1h": w_topn_freq(Col("merchant"), w1h, n=1),
    }, database=base.database)


def _family_bytes(store):
    """(reckoned, allocated) bytes of a store's merge-order families: a
    (key, bucket) holds 18 + 8F (extreme) and 32 (9 + 4F) (tail), a key
    4 (seq)."""
    b = store._flat_state().bagg
    K, NB = b.bucket.shape
    F = b.stats.shape[2]
    cell = ((18 + 8 * F if b.xts is not None else 0)
            + (32 * (9 + 4 * F) if b.tts is not None else 0))
    alloc = sum(t.untyped_storage().nbytes() for t in b.families().values())
    return 4 * K + K * NB * cell, alloc


def _plain_routes():
    """The route module's kernel entry points and their plain versions."""
    from repro_torch.core import shard as shard_mod
    from repro_torch.kernels.route.ref import route_keys_ref, route_rank_ref

    def plain_route_keys(key, valid, perm, *, num_shards):
        return route_keys_ref(key, valid, perm, num_shards)

    def plain_route_rank(shard, *, num_shards):
        return route_rank_ref(shard, num_shards)

    return (shard_mod.route_keys, shard_mod.route_rank), (plain_route_keys,
                                                         plain_route_rank)


def families_path(results) -> None:
    """The merge-order bucket families at deployment size: (a) a day into
    a sharded family store, B1 once a slice, state == the split replay;
    (b) 8 batches through ``ShardRouter`` == host-routed == single-device
    == naive (family features) == B2-plain; (c) ``verify_view`` err 0;
    (d) ``hot_deploy`` of the family view from the rings and with a
    ``BackfillSource``, each == a cold plane."""
    from repro_torch import kernels
    from repro_torch.core import preagg as pg
    from repro_torch.core import shard as shard_mod
    from repro_torch.core import storage as st
    from repro_torch.core.consistency import verify_view
    from repro_torch.core.online import OnlineFeatureStore
    from repro_torch.data.synthetic import MULTITABLE_DB, multitable_stream
    from repro_torch.obs import Telemetry, use_telemetry
    from repro_torch.offline import BackfillSource
    from repro_torch.scenarios import sharded_view
    from repro_torch.serve.router import ShardRouter
    from repro_torch.serve.service import BatchScheduler, FeatureService

    phase_t0 = time.perf_counter()
    kw = dict(secondary_num_keys={"merchants": MT_MERCHANTS}, **FAM_STORE_KW)
    fam = _family_view()
    rng = np.random.default_rng(SEED + 11)
    tables = multitable_stream(rng, MT_ROWS, num_accounts=NUM_CARDS,
                               num_merchants=MT_MERCHANTS, t_max=DAY)
    launches = {"fused_ingest": 0, "keys": 0}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    # -- (a) a day into the family store, against the split replay -----------
    rate = {}
    for name, view in (("without the families", sharded_view()),
                       ("with the families", fam)):
        svc = FeatureService.build(
            "families", view, num_keys=NUM_CARDS, sharded=True,
            num_shards=NUM_SHARDS, mode="preagg", device="cuda", **kw)
        store = svc.store
        if view is not fam:
            secs, rows = _mt_ingest(store, (), tables, WARM_SLICES,
                                    {"fused_ingest": 0})
            rate[name] = rows["transactions"] / secs["transactions"]
            del svc, store
            torch.cuda.empty_cache()
    reck, alloc = _family_bytes(store)
    state_b = sum(t.untyped_storage().nbytes() for _, t in
                  _flat_tensors(store))
    print(f"families store: {NUM_CARDS} accounts x {NUM_SHARDS} shards, "
          f"{FAM_STORE_KW['num_buckets']} buckets of "
          f"{FAM_STORE_KW['bucket_size']} s, F = {store.num_lanes}: families "
          f"reckoned {reck / 1e9:.4f} GB, allocated {alloc / 1e9:.4f} GB "
          f"(tail {store.state.bagg.tval.untyped_storage().nbytes() / 1e9:.4f}"
          f" GB of tval); whole state {state_b / 1e9:.3f} GB", flush=True)
    if reck != alloc:
        _fail(f"families: reckoned {reck} bytes, allocated {alloc}")
    applied = []
    apply_kernel = store._apply_ingest

    def recording_apply(key, ts, lanes):
        applied.append((key, ts, lanes))
        apply_kernel(key, ts, lanes)

    store._apply_ingest = recording_apply
    secs, rows = _mt_ingest(store, (), tables, WARM_SLICES, launches)
    # the bound method holds the store: drop it with the store, not later
    del store._apply_ingest, apply_kernel, recording_apply
    rate["with the families"] = rows["transactions"] / secs["transactions"]
    if launches["fused_ingest"] != WARM_SLICES or len(applied) != WARM_SLICES:
        _fail(f"families ingest: B1 {launches['fused_ingest']} launches for "
              f"{len(applied)} batches, expected one a slice ({WARM_SLICES})")
    print("families ingest (transactions, fenced, 64 slices of the day): "
          + "; ".join(f"{n} {r:.0f} rows/s" for n, r in rate.items())
          + f"; B1 {launches['fused_ingest']} launches", flush=True)
    t0 = time.perf_counter()
    ref = store._flat_state(store._init_state())
    for key, ts, lanes in applied:
        st.ring_ingest(ref.ring, key, ts, lanes)
        pg.bucket_ingest(ref.bagg, key, ts, lanes)
    got_t = dict(_flat_tensors(store))
    names = [n for n, _ in _flat_tensors(store)][:6] + [
        f"b{f}" for f in ref.bagg.families()]
    want_t = dict(zip(
        names, [ref.ring.ts, ref.ring.vals, ref.ring.cursor, ref.bagg.stats,
                ref.bagg.bitmap, ref.bagg.bucket,
                *ref.bagg.families().values()]))
    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    for n in names:
        if not torch.equal(bits(got_t[n]), bits(want_t[n])):
            _fail(f"families: {n} differs from the split replay")
    if not torch.equal(got_t["bseq"], got_t["cursor"]):
        _fail("families: seq differs from the ring cursor")
    print(f"families state ({len(applied)} batches) == the split replay "
          f"(ring_ingest + bucket_ingest): {len(names)} tensors bit for bit "
          f"({', '.join(names[6:])}); seq == cursor; replay "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    del ref, applied, got_t, want_t
    torch.cuda.empty_cache()

    # -- (b) request batches through ShardRouter ------------------------------
    kernel_fns, plain_fns = _plain_routes()
    router = ShardRouter(svc, BatchScheduler(buckets=(REQ_ROWS,),
                                             max_batch=REQ_ROWS))
    tels = {"host": Telemetry(), "device": Telemetry()}
    saved, walls = [], []
    for b in range(REQ_BATCHES):
        rows = _mt_requests(rng, DAY + 60 * b, NUM_CARDS)
        b2_before = dict(kernels.VARIANT_LAUNCHES["route_rank"])
        store.device_routing = False
        try:
            with use_telemetry(tels["host"]):
                host = _np_answers(store.query(dict(rows), mode="preagg"))
        finally:
            store.device_routing = True
        shard_mod.route_keys, shard_mod.route_rank = plain_fns
        try:
            with use_telemetry(Telemetry()):
                plain = _np_answers(store.query(dict(rows), mode="preagg"))
        finally:
            shard_mod.route_keys, shard_mod.route_rank = kernel_fns
        if kernels.VARIANT_LAUNCHES["route_rank"] != b2_before:
            _fail("families: the host-routed and plain answers launched B2")
        with use_telemetry(Telemetry()):
            naive = _np_answers(store.query(dict(rows), mode="naive"))
        for i in range(REQ_ROWS):
            router.submit({c: v[i] for c, v in rows.items()})
        b2_before = dict(kernels.VARIANT_LAUNCHES["route_rank"])
        b1 = kernels.LAUNCHES["fused_ingest"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with use_telemetry(tels["device"]):
            got = router.pump(flush=True)
        walls.append(time.perf_counter() - t0)
        n_b1 = kernels.LAUNCHES["fused_ingest"] - b1
        launches["fused_ingest"] += n_b1
        after = kernels.VARIANT_LAUNCHES["route_rank"]
        n_b2 = {v: after[v] - b2_before[v] for v in after}
        launches["keys"] += n_b2["keys"]
        if n_b2["keys"] != 1 or sum(n_b2.values()) != 1 or n_b1 != 1:
            _fail(f"families batch {b}: B2 {n_b2}, B1 {n_b1} in one pump")
        checks = (("host-routed", host, None), ("B2-plain", plain, None),
                  ("naive", naive, FAM_FEATURES))
        for name, want, feats in checks:
            pick = {f: want[f] for f in (feats or want)}
            bad = _same_bits(pick, {f: got[f] for f in pick})
            if bad is not None:
                _fail(f"families batch {b} feature {bad}: device-routed "
                      f"answers differ from the {name} answers")
        for f, v in got.items():
            if v.shape != (REQ_ROWS,) or not np.all(np.isfinite(v)):
                _fail(f"families batch {b} {f}: shape {v.shape} or "
                      "non-finite")
        saved.append((rows, got))
    counter = tels["device"].metrics.counter
    hits = {a: counter("preagg_hits_total", unit="1",
                       labels=("agg",)).value(agg=a)
            for a in ("first", "last", "topn_freq")}
    falls = {a: counter("preagg_fallback_total", unit="1",
                        labels=("agg",)).value(agg=a)
             for a in ("first", "last", "topn_freq")}
    if min(hits.values()) < REQ_BATCHES or any(falls.values()):
        _fail(f"families: preagg hits {hits}, fallbacks {falls}")
    second = np.concatenate([g["second_merchant_1h"] for _, g in saved])
    lat = 1e3 * np.repeat(walls, REQ_ROWS)
    spans = tels["device"].metrics.histogram(
        "span_seconds", unit="s", labels=("name", "kind"))
    print(f"families: {REQ_BATCHES} batches x {REQ_ROWS} through ShardRouter"
          ": device-routed == host-routed == B2-plain (every feature) == "
          f"naive ({len(FAM_FEATURES)} family features), bit for bit; B2 "
          f"{launches['keys']} launches (one a pump); preagg hits {hits}, "
          f"fallbacks {falls}; second most frequent merchant nonzero in "
          f"{int((second != 0).sum())} of {second.size}", flush=True)
    print(f"families request latency ({lat.size} requests, fenced pump "
          f"walls, query + ingest): p50 {np.percentile(lat, 50):.3f} ms, "
          f"p99 {np.percentile(lat, 99):.3f} ms; route.device span mean "
          f"{1e3 * spans.mean(name='route.device', kind='device'):.3f} ms "
          f"over {int(spans.count(name='route.device', kind='device'))}; "
          f"peak {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)
    del svc, store, router
    torch.cuda.empty_cache()

    # the single-device store, built after the sharded one's answers are
    # saved: the day, then each batch queried and ingested in turn
    single = OnlineFeatureStore(fam, num_keys=NUM_CARDS, device="cuda", **kw)
    _mt_ingest(single, (), tables, WARM_SLICES, {"fused_ingest": 0})
    for b, (rows, got) in enumerate(saved):
        with use_telemetry(Telemetry()):
            one = _np_answers(single.query(dict(rows), mode="preagg"))
        bad = _same_bits(one, got)
        if bad is not None:
            _fail(f"families batch {b} feature {bad}: device-routed answers "
                  "differ from the single-device store's")
        single.ingest(_by_key(rows, "account"))
    print(f"families: the single-device store == the saved device-routed "
          f"answers, {REQ_BATCHES} batches bit for bit; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    del single, saved
    torch.cuda.empty_cache()

    # -- (c) verify_view --------------------------------------------------
    vt = multitable_stream(rng, VERIFY_ROWS, num_accounts=MT_VERIFY_ACCOUNTS,
                           num_merchants=MT_VERIFY_MERCHANTS, t_max=DAY)
    vtx = vt.pop("transactions")
    t0 = time.perf_counter()
    rep = verify_view(
        fam, vtx, num_keys=MT_VERIFY_ACCOUNTS, secondary=vt,
        secondary_num_keys={"merchants": MT_VERIFY_MERCHANTS},
        num_shards=NUM_SHARDS, mode="preagg", device_routing=True,
        device="cuda", **FAM_STORE_KW)
    errs = {f: rep.per_feature[f] for f in FAM_FEATURES}
    print(f"families {rep.summary()} in {time.perf_counter() - t0:.1f} s: "
          f"family features {errs}", flush=True)
    if not rep.passed or any(e != 0.0 for e in errs.values()):
        _fail(f"families verify_view: passed {rep.passed}, errors {errs}")
    del vt, vtx

    # -- (d) hot deploy onto a warm plane that lacks the families ----------
    for tag, cap, backfill in (
            ("deploy from the rings", FAM_STORE_KW["capacity"], None),
            ("deploy with a BackfillSource", DEPLOY_C_CAPACITY,
             BackfillSource(MULTITABLE_DB, tables))):
        kw_d = dict(kw, capacity=cap)
        torch.cuda.reset_peak_memory_stats()
        hot = FeatureService.build_multi(
            "fam_hot", [sharded_view()], num_keys=NUM_CARDS, sharded=True,
            num_shards=NUM_SHARDS, mode="preagg", device="cuda", **kw_d)
        _mt_ingest(hot.store, (), tables, WARM_SLICES, launches)
        b1 = kernels.LAUNCHES["fused_ingest"]
        report, hot_s, _ = _deploy(hot.hot_deploy, f"families {tag}", fam,
                                   backfill=backfill)
        launches["fused_ingest"] += kernels.LAUNCHES["fused_ingest"] - b1
        if not report.exact or (backfill is not None) != bool(
                report.backfilled):
            _fail(f"families {tag}: {report.describe()}")
        cold, cold_s = _cold([sharded_view(), fam], NUM_CARDS, tables, (),
                             kw_d, f"families {tag}")
        outside, n_pairs = ((frozenset(), 0) if backfill is None else
                            _outside_contract(hot.store,
                                              tables["transactions"],
                                              WARM_SLICES))
        cells = _hot_equals_cold(hot.store, cold.store, f"families {tag}",
                                 outside)
        print(f"families {tag} (rings of {cap}, "
              f"{int((hot.store.state.ring.cursor > cap).sum())} wrapped): "
              f"exact; migrated {report.migrated}; backfilled "
              f"{len(report.backfilled)}; hot == cold, "
              f"{len(_flat_tensors(hot.store))} buffers bit for bit but "
              f"{cells} bucket cells (of the {n_pairs} pairs outside the "
              f"contract); hot_deploy {1e3 * hot_s:.3f} ms against the cold "
              f"build + replay {1e3 * cold_s:.3f} ms; peak "
              f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
        del hot, cold
        torch.cuda.empty_cache()
    print(f"families phase: {time.perf_counter() - phase_t0:.1f} s; B1 "
          f"{launches['fused_ingest']}, B2 {launches['keys']} launches",
          flush=True)
    results["fused_ingest"]["launches_families"] = launches["fused_ingest"]
    results["route_rank"]["launches_families"] = launches["keys"]



def _write_csv(path, cols) -> None:
    """A columns dict as CSV: a float32 as ``repr(float(v))`` (its exact
    float64 widening, so ``load_csv``'s float64 parse and float32 cast
    give the same bits back), an int as ``str``."""
    text = [list(map(repr, v.astype(np.float64).tolist()))
            if v.dtype.kind == "f" else list(map(str, v.tolist()))
            for v in cols.values()]
    with open(path, "w") as fh:
        fh.write(",".join(cols) + "\n")
        fh.write("\n".join(map(",".join, zip(*text))))
        fh.write("\n")


def _same_columns(want, got, where) -> None:
    for c, v in want.items():
        g = got[c]
        if g.dtype != v.dtype or g.tobytes() != v.tobytes():
            _fail(f"{where}: column {c!r} ({g.dtype}) differs from the "
                  f"generated one ({v.dtype})")


def _launch_delta(before):
    from repro_torch import kernels

    return {k: kernels.LAUNCHES[k] - before[k]
            for k in ("fused_ingest", "route_rank", "fold_levels")}


def platform_path(results) -> None:
    """The platform surface at deployment size: (a) the main path's day
    written as npz (64 slices) and CSV (the first ``PLATFORM_CSV_SLICES``),
    loaded back through ``data.ingest`` bit for bit, ingested into the
    sharded fraud store and served (device-routed == host-routed); (b) the
    telemetry gate ``obs.check`` on the card; (c) the dashboard;
    (d) the catalog's staleness check; (e) the five example twins."""
    import contextlib
    import importlib
    import io
    import tempfile

    from repro_torch import kernels
    from repro_torch import catalog
    from repro_torch.data import load_table
    from repro_torch.data.synthetic import FRAUD_SCHEMA, fraud_transactions
    from repro_torch.obs import Telemetry, use_telemetry
    from repro_torch.obs import check as obs_check
    from repro_torch.obs import report as obs_report
    from repro_torch.scenarios import fraud_view
    from repro_torch.serve.router import ShardRouter
    from repro_torch.serve.service import BatchScheduler, FeatureService

    phase_t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = dict(kernels.LAUNCHES)
    # -- (a) import a day: npz and CSV back to the generated bits ------------
    rng = np.random.default_rng(SEED)
    slices = [
        fraud_transactions(rng, SLICE_ROWS, NUM_CARDS,
                           i * DAY // WARM_SLICES, (i + 1) * DAY // WARM_SLICES)
        for i in range(WARM_SLICES)
    ]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_import_") as tmp:
        tmp = Path(tmp)
        t0 = time.perf_counter()
        for i, cols in enumerate(slices):
            np.savez(tmp / f"day_{i:02d}.npz", **cols)
        npz_write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        for i, cols in enumerate(slices[:PLATFORM_CSV_SLICES]):
            _write_csv(tmp / f"day_{i:02d}.csv", cols)
        csv_write_s = time.perf_counter() - t0
        npz_bytes = sum(p.stat().st_size for p in tmp.glob("*.npz"))
        csv_bytes = sum(p.stat().st_size for p in tmp.glob("*.csv"))
        t0 = time.perf_counter()
        day = [load_table(tmp / f"day_{i:02d}.npz", FRAUD_SCHEMA, "npz")
               for i in range(WARM_SLICES)]
        npz_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        day_csv = [load_table(tmp / f"day_{i:02d}.csv", FRAUD_SCHEMA, "csv")
                   for i in range(PLATFORM_CSV_SLICES)]
        csv_s = time.perf_counter() - t0
    for i, cols in enumerate(slices):
        _same_columns(cols, day[i], f"npz slice {i}")
    for i, cols in enumerate(day_csv):
        _same_columns(slices[i], cols, f"CSV slice {i}")
    npz_rows = WARM_SLICES * SLICE_ROWS
    csv_rows = PLATFORM_CSV_SLICES * SLICE_ROWS
    print(f"platform import: {npz_rows} rows from {WARM_SLICES} npz files "
          f"({npz_bytes / 1e6:.1f} MB, written in {npz_write_s:.2f} s) in "
          f"{npz_s:.3f} s = {npz_rows / npz_s:.0f} rows/s; {csv_rows} rows "
          f"from {PLATFORM_CSV_SLICES} CSV files ({csv_bytes / 1e6:.1f} MB, "
          f"written in {csv_write_s:.2f} s) in {csv_s:.3f} s = "
          f"{csv_rows / csv_s:.0f} rows/s; every column == the generated "
          "day, dtype and bytes", flush=True)
    del slices, day_csv

    svc = FeatureService.build(
        "platform", fraud_view(), num_keys=NUM_CARDS, sharded=True,
        num_shards=NUM_SHARDS, mode="preagg", device="cuda", **STORE_KW,
    )
    store = svc.store
    state_b = sum(t.numel() * t.element_size() for t in store.state.arrays())
    torch.cuda.synchronize()
    b1 = kernels.LAUNCHES["fused_ingest"]
    t0 = time.perf_counter()
    for cols in day:
        store.ingest(cols)
    torch.cuda.synchronize()
    ingest_s = time.perf_counter() - t0
    if kernels.LAUNCHES["fused_ingest"] - b1 != WARM_SLICES:
        _fail(f"platform: the loaded day's {WARM_SLICES} slices launched B1 "
              f"{kernels.LAUNCHES['fused_ingest'] - b1} times")
    print(f"platform ingest of the loaded day: {npz_rows} rows in "
          f"{ingest_s:.3f} s = {npz_rows / ingest_s:.0f} rows/s into "
          f"{state_b / 1e9:.3f} GB of state ({NUM_SHARDS} shards x "
          f"{store.num_keys} cards)", flush=True)
    del day

    router = ShardRouter(
        svc, BatchScheduler(buckets=(REQ_ROWS,), max_batch=REQ_ROWS))
    b2 = kernels.LAUNCHES["route_rank"]
    for b in range(REQ_BATCHES):
        rows = _request_rows(rng, DAY + 60 * b, NUM_CARDS)
        store.device_routing = False
        with use_telemetry(Telemetry()):
            want = _np_answers(store.query(dict(rows), mode="preagg"))
        store.device_routing = True
        for i in range(REQ_ROWS):
            router.submit({c: v[i] for c, v in rows.items()})
        got = router.pump(flush=True)
        bad = _same_bits(want, got)
        if bad is not None:
            _fail(f"platform batch {b}: {bad} of the device-routed path "
                  "differs from the host-routed path")
        if not (got["tx_count_1h"] >= 1).all():
            _fail("platform: a request does not count itself")
    if kernels.LAUNCHES["route_rank"] - b2 != REQ_BATCHES:
        _fail(f"platform: {REQ_BATCHES} pumps launched B2 "
              f"{kernels.LAUNCHES['route_rank'] - b2} times")
    st = svc.stats
    print(f"platform serving: {REQ_BATCHES} batches x {REQ_ROWS} rows == the "
          f"host-routed path bit for bit; batch wall p50 {st.p50_ms:.3f} ms, "
          f"p99 {st.p99_ms:.3f} ms; peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB", flush=True)
    del svc, store, router
    torch.cuda.empty_cache()
    counted = _launch_delta(before)

    # -- (b) the telemetry gate on the card ------------------------------------
    at = dict(kernels.LAUNCHES)
    seen = {}
    gates = {"schema_check": obs_check.schema_check,
             "overhead_check": obs_check.overhead_check}

    def spy(name):
        def run(**kw):
            seen[name] = gates[name](**kw)
            return seen[name]
        return run

    t0 = time.perf_counter()
    try:
        for name in gates:
            setattr(obs_check, name, spy(name))
        rc = obs_check.main(["all", "--device", "cuda"])
    except AssertionError as e:
        _fail(f"platform: the telemetry gate failed: {e}")
    finally:
        for name, fn in gates.items():
            setattr(obs_check, name, fn)
    if rc != 0 or set(seen) != set(gates):
        _fail(f"platform: obs.check main returned {rc}, ran {sorted(seen)}")
    ovh = seen["overhead_check"]
    snap = seen["schema_check"]
    disp = {(s["labels"]["kernel"], s["labels"]["impl"]): s["value"]
            for s in snap["metrics"]["kernel_dispatch_total"]["series"]}
    print(f"platform gate (obs.check all --device cuda) passed in "
          f"{time.perf_counter() - t0:.1f} s: {len(snap['metrics'])} metrics, "
          f"dispatches {disp}; request medians instrumented "
          f"{1e3 * ovh['instrumented_s']:.3f} ms, disabled "
          f"{1e3 * ovh['disabled_s']:.3f} ms (limit "
          f"{1e3 * ovh['limit_s']:.3f} ms)", flush=True)
    counted = {k: v + _launch_delta(at)[k] for k, v in counted.items()}

    # -- (c) the dashboard (its demo's launches are not counted) -----------------
    md = obs_report.render_markdown(snap)
    missing = [n for n in obs_check.EXPECTED_METRICS if f"`{n}`" not in md]
    demo = Telemetry()
    demo_snap = obs_report.demo_snapshot(demo, device="cuda")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = obs_report.main(["--prom", "--device", "cuda"])
    prom = buf.getvalue()
    missing += [f"prom:{n}" for n, m in demo_snap["metrics"].items()
                if f"# TYPE {n} {m['type']}" not in prom]
    if rc != 0 or missing:
        _fail(f"platform dashboard: missing {missing}")
    print(f"platform dashboard: {len(md.splitlines())} markdown lines naming "
          f"all {len(obs_check.EXPECTED_METRICS)} golden metrics; --prom "
          f"names all {len(demo_snap['metrics'])} families of the demo",
          flush=True)

    # -- (d) the catalog ---------------------------------------------------------
    if catalog.main(["--check"]) != 0:
        _fail("platform: docs/CATALOG_TORCH.md is stale")

    # -- (e) the example twins at their own sizes --------------------------------
    for name in ("quickstart", "recommendation", "multi_table_fraud",
                 "sharded_serving", "multi_scenario"):
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        at = dict(kernels.LAUNCHES)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with use_telemetry(Telemetry()):
            mod.main(device="cuda")
        torch.cuda.synchronize()
        d = _launch_delta(at)
        counted = {k: v + d[k] for k, v in counted.items()}
        print(f"platform example {name}: passed in "
              f"{time.perf_counter() - t0:.2f} s; B1 {d['fused_ingest']}, "
              f"B2 {d['route_rank']}, B4 {d['fold_levels']} launches",
              flush=True)

    d = counted
    print(f"platform phase: {time.perf_counter() - phase_t0:.1f} s; B1 "
          f"{d['fused_ingest']}, B2 {d['route_rank']}, B4 {d['fold_levels']} "
          f"launches over (a), (b) and (e); the whole phase "
          f"{_launch_delta(before)}", flush=True)
    if d["fused_ingest"] <= 0 or d["route_rank"] <= 0:
        _fail(f"platform: B1 / B2 never launched: {d}")
    results["fused_ingest"]["launches_platform"] = d["fused_ingest"]
    results["route_rank"]["launches_platform"] = d["route_rank"]
    if d["fold_levels"]:
        results["fold_levels"]["launches_platform"] = d["fold_levels"]


# ---------------------------------------------------------------------------
# the stress harness and 128 generated scenarios
# ---------------------------------------------------------------------------


def _answer_bytes(v) -> np.ndarray:
    """An answer column as its dtype's name and its bytes: two of these
    are ``np.array_equal`` exactly when the answers are bit for bit the
    same."""
    a = np.ascontiguousarray(
        v.cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
    return np.frombuffer(f"{a.dtype.str}{a.shape}".encode() + a.tobytes(),
                         np.uint8)


def _stress_cli(argv, tag):
    """``python -m repro_torch.stress`` in this process, from a temporary
    working directory (its repro scripts land there), with the harness's
    answer comparisons (flavour parity, spot checks) held to the bits
    (``_answer_bytes``); returns (exit code, the report, the directory's
    files)."""
    import contextlib
    import io
    import os
    import tempfile

    from repro_torch.stress import __main__ as stress_main
    from repro_torch.stress import harness

    seen = []
    run_stress = stress_main.run_stress
    host = harness._host

    def spy(*a, **kw):
        seen.append(run_stress(*a, **kw))
        return seen[-1]

    buf = io.StringIO()
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_stress_") as tmp:
        os.chdir(tmp)
        stress_main.run_stress = spy
        harness._host = _answer_bytes
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = stress_main.main(argv)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        finally:
            stress_main.run_stress = run_stress
            harness._host = host
            os.chdir(cwd)
        files = {p.name: p.read_text() for p in Path(tmp).iterdir()}
    for ln in buf.getvalue().splitlines():
        if not ln.startswith("  verify [PASS]"):
            print(f"{tag}: {ln}", flush=True)
    if len(seen) != 1:
        _fail(f"{tag}: main ran run_stress {len(seen)} times")
    print(f"{tag}: exit {rc} in {wall:.1f} s", flush=True)
    return rc, seen[0], files


def _stress_report_is(rep, tag, deployed, verified):
    """The harness's counts at its defaults: ``deployed`` views, 2 waves,
    3 flavour-parity probes (a probe that differs is a failure), 3 spot
    checks, 576 requests."""
    got = (rep.deployed, rep.waves_survived, rep.parity_batches,
           len(rep.verified), len(rep.spot_checked), rep.requests)
    want = (deployed, 2, 3, verified, 3, 576)
    if got != want:
        _fail(f"{tag}: (deployed, waves, parity probes, verified, spot "
              f"checks, requests) {got}, expected {want}")


def _cms_check(dev) -> None:
    """The count-min sketch on the card == on the CPU, bit for bit: unit
    weights, and float weights over six magnitudes with heavy hitters."""
    from repro_torch.core.signature import cms_init, cms_query, cms_update

    rng = np.random.default_rng(SEED + 14)
    items = np.concatenate([
        rng.integers(0, 1 << 20, CMS_ITEMS).astype(np.int32),
        np.repeat(np.arange(CMS_HOT, dtype=np.int32) * 7919, CMS_HOT_ROWS),
    ])
    rng.shuffle(items)
    w = (rng.standard_normal(items.size)
         * rng.choice([1e-3, 1.0, 1e3], items.size)).astype(np.float32)
    probe = torch.from_numpy(np.unique(items[:4096]))
    for kind, weights in (("unit", None), ("float", torch.from_numpy(w))):
        got = {}
        t0 = time.perf_counter()
        for d in ("cpu", dev):
            sk = cms_init(CMS_DEPTH, CMS_WIDTH, device=d)
            sk = cms_update(sk, torch.from_numpy(items), weights)
            got[d] = (sk.counts.cpu().numpy(),
                      cms_query(sk, probe).cpu().numpy())
        (c0, q0), (c1, q1) = got["cpu"], got[dev]
        if not (np.array_equal(c0.view(np.int32), c1.view(np.int32))
                and np.array_equal(q0.view(np.int32), q1.view(np.int32))):
            _fail(f"stress: count-min sketch ({kind} weights) differs "
                  "between the card and the CPU")
        print(f"stress count-min sketch ({kind} weights): {items.size} items "
              f"(hot ids x{CMS_HOT_ROWS}) into ({CMS_DEPTH}, {CMS_WIDTH}), "
              f"card == CPU bit for bit (counts and {probe.numel()} queries) "
              f"in {time.perf_counter() - t0:.2f} s", flush=True)


def _stress_ladder(dev) -> None:
    """``bench_stress.py``'s ladder on the card: N generated views on one
    8-shard ``ScenarioPlane`` (deploy seconds, lane packing), 900 rows
    ingested, 8 mixed ``query_mixed`` batches of 64 tagged over all N
    (requests/s), the telemetry registry's size."""
    from repro_torch.core.expr import collect_window_aggs
    from repro_torch.core.scenario import ScenarioPlane
    from repro_torch.data.synthetic import STRESS_DB, stress_stream
    from repro_torch.obs import Telemetry, use_telemetry
    from repro_torch.stress.generate import (
        NUM_ENTITIES, NUM_ITEMS, T_MAX, filter_table_knobs, gen_store_kwargs,
        gen_views, stress_rng)
    from repro_torch.stress.harness import _sorted_batch

    rows, batch = STRESS_LADDER_ROWS, STRESS_LADDER_BATCH
    for n in STRESS_LADDER:
        views = gen_views(0, n)
        kw = filter_table_knobs(gen_store_kwargs(0, n), views)
        tel = Telemetry()
        with use_telemetry(tel):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plane = ScenarioPlane(views, num_keys=NUM_ENTITIES,
                                  num_shards=NUM_SHARDS, name=f"stress{n}",
                                  device=dev, **kw)
            torch.cuda.synchronize()
            deploy_s = time.perf_counter() - t0
            exprs = [e for v in views for e in v.features.values()]
            distinct = len(collect_window_aggs(exprs))
            per_view = sum(len(collect_window_aggs(list(v.features.values())))
                           for v in views)
            tabs = stress_stream(stress_rng(0, n, "default", "data"), rows,
                                 num_entities=NUM_ENTITIES,
                                 num_items=NUM_ITEMS, t_max=T_MAX)
            for t in plane.store._sec_names:
                sch = STRESS_DB.table(t)
                plane.ingest_table(t, _sorted_batch(tabs[t], sch.key, sch.ts))
            ev = tabs["events"]
            plane.ingest(_sorted_batch(ev, "entity", "ts"))
            scens = plane.scenarios
            rng = stress_rng(0, n, "default", "bench-traffic")

            def probe(i):
                lo = (i * batch) % (rows - batch)
                cols = {c: v[lo:lo + batch] for c, v in ev.items()}
                tags = np.array([scens[int(t)] for t in
                                 rng.integers(len(scens), size=batch)])
                return cols, tags

            plane.query_mixed(*probe(0))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(STRESS_LADDER_BATCHES):
                plane.query_mixed(*probe(i + 1))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        metrics = tel.metrics.snapshot()
        series = sum(len(m["series"]) for m in metrics.values())
        print(f"stress ladder N={n}: deploy_s {deploy_s!r}; lanes_primary "
              f"{len(plane.store.layout.primary.lanes)}; lanes_shared "
              f"{per_view - distinct} ({per_view} per-view window aggs -> "
              f"{distinct} packed); mixed_qps "
              f"{STRESS_LADDER_BATCHES * batch / dt!r} "
              f"({STRESS_LADDER_BATCHES} x {batch} rows over {len(scens)} "
              f"scenarios, fenced); telemetry registry {len(metrics)} "
              f"metrics, {series} series", flush=True)
        del plane
    torch.cuda.empty_cache()


def _stress_serve(svc, routers, tels, rows, tags, tag):
    """One mixed batch through the device-routed ``ShardRouter`` (one
    pump, ingest off) and through the host-routed one over the same plane:
    every scenario's answers bit for bit, B2 once (from keys) on the
    device path and never on the host path.  Returns (answers, fenced
    seconds of the device pump)."""
    from repro_torch import kernels
    from repro_torch.obs import use_telemetry

    store = svc.store
    n = len(tags)

    def submit(router):
        for i in range(n):
            router.submit({c: v[i] for c, v in rows.items()},
                          scenario=str(tags[i]))

    b2 = dict(kernels.VARIANT_LAUNCHES["route_rank"])
    store.device_routing = False
    try:
        with use_telemetry(tels["host"]):
            submit(routers["host"])
            host = routers["host"].pump(flush=True)
    finally:
        store.device_routing = True
    if kernels.VARIANT_LAUNCHES["route_rank"] != b2:
        _fail(f"{tag}: the host-routed pump launched B2")
    with use_telemetry(tels["device"]):
        submit(routers["device"])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = routers["device"].pump(flush=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    after = kernels.VARIANT_LAUNCHES["route_rank"]
    n_b2 = {v: after[v] - b2[v] for v in after}
    if n_b2["keys"] != 1 or sum(n_b2.values()) != 1:
        _fail(f"{tag}: B2 launched {n_b2} in one mixed pump, expected one "
              "from keys")
    present = sorted(set(tags.tolist()))
    if sorted(got) != present or sorted(host) != present:
        _fail(f"{tag}: scenarios answered: device {len(got)}, host "
              f"{len(host)}, sent {len(present)}")
    for sc in present:
        bad = _same_bits(host[sc], got[sc])
        if bad is not None:
            x, y = np.asarray(host[sc][bad]), np.asarray(got[sc][bad])
            i = int(np.flatnonzero(x.view(np.uint8) != y.view(np.uint8))[0]
                    // x.itemsize) if x.shape == y.shape else 0
            _fail(f"{tag} {sc}/{bad}: device-routed answers differ from the "
                  f"host-routed ones (first at row {i}: {y.reshape(-1)[i]!r} "
                  f"vs {x.reshape(-1)[i]!r})")
        m = int((tags == sc).sum())
        for f, v in got[sc].items():
            if v.shape != (m,) or not np.all(np.isfinite(v)):
                _fail(f"{tag} {sc}/{f}: shape {v.shape} or non-finite")
    return got, wall


def _stress_deployment(results, dev) -> None:
    """The 128 generated views of (0, 128) at a deployment's size: 122 on
    one 8-shard plane of ``STRESS_ENTITIES`` entities, a day of
    ``STRESS_ROWS`` events, mixed batches device == host, two dedicated
    stores, one hot-deploy wave of the 6 held back, one more batch."""
    from repro_torch import kernels
    from repro_torch.core.online import OnlineFeatureStore
    from repro_torch.data.synthetic import STRESS_DB, stress_stream
    from repro_torch.obs import Telemetry, use_telemetry
    from repro_torch.offline.backfill import BackfillSource
    from repro_torch.serve.service import (
        SCENARIO_COL, FeatureService, MultiScenarioService)
    from repro_torch.stress.generate import (
        filter_table_knobs, gen_store_kwargs, gen_views, stress_rng)
    from repro_torch.stress.harness import _sorted_batch

    views = gen_views(0, STRESS_N)
    initial, held = views[:-STRESS_HELD], views[-STRESS_HELD:]
    kw = gen_store_kwargs(0, STRESS_N)
    kw["secondary_num_keys"] = {"items": STRESS_ITEMS}
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    svc = FeatureService.build_multi(
        "stress_deploy", initial, num_keys=STRESS_ENTITIES, sharded=True,
        num_shards=NUM_SHARDS, device=dev, **filter_table_knobs(kw, initial))
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    plane, store = svc.plane, svc.store
    print(f"stress deployment: build_multi of {len(initial)} views on "
          f"{NUM_SHARDS} shards x {STRESS_ENTITIES} entities (items "
          f"{STRESS_ITEMS}) in {build_s!r} s; {store.num_lanes} primary "
          f"lanes, tables {list(store._sec_names)}; state "
          f"{_state_gb(store)!r} GB", flush=True)

    tabs = stress_stream(stress_rng(0, STRESS_N, "default", "data"),
                         STRESS_ROWS, num_entities=STRESS_ENTITIES,
                         num_items=STRESS_ITEMS, t_max=DAY)
    ev = tabs["events"]
    per_entity = np.bincount(ev["entity"], minlength=STRESS_ENTITIES)
    print(f"stress deployment: {STRESS_ROWS} events over {DAY} s, "
          f"{per_entity.max()} on the busiest entity (ring "
          f"{kw['capacity']}); " + ", ".join(
              f"{t} {len(c['ts'])}" for t, c in tabs.items() if t != "events"),
          flush=True)
    if per_entity.max() > kw["capacity"]:
        _fail("stress deployment: the busiest entity overflows its ring")

    log = []
    seen_tables = set()
    rows_in = {}
    secs = {}

    def ingest(table, cols):
        sch = STRESS_DB.table(table)
        b = _sorted_batch(cols, sch.key, sch.ts)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if table == "events":
            plane.ingest(b)
        else:
            plane.ingest_table(table, b)
        torch.cuda.synchronize()
        secs[table] = secs.get(table, 0.0) + time.perf_counter() - t0
        rows_in[table] = rows_in.get(table, 0) + len(b["ts"])
        log.append((table, b))

    def ingest_new_tables():
        for t in store._sec_names:
            if t not in seen_tables:
                seen_tables.add(t)
                ingest(t, tabs[t])

    def backfill_from_log():
        hist = {}
        for t, b in log:
            hist.setdefault(t, []).append(b)
        return BackfillSource(STRESS_DB, {
            t: {c: np.concatenate([b[c] for b in bs]) for c in bs[0]}
            for t, bs in hist.items()})

    b1 = kernels.LAUNCHES["fused_ingest"]
    ingest_new_tables()
    for idx in np.array_split(np.arange(STRESS_ROWS), STRESS_SLICES):
        ingest("events", {c: v[idx] for c, v in ev.items()})
    n_b1 = kernels.LAUNCHES["fused_ingest"] - b1
    for t in rows_in:
        print(f"stress deployment ingest {t}: {rows_in[t]} rows in "
              f"{secs[t]!r} s = {rows_in[t] / secs[t]!r} rows/s (fenced)",
              flush=True)
    print(f"stress deployment: B1 {n_b1} launches over the ingest; state "
          f"{_state_gb(store)!r} GB, peak "
          f"{torch.cuda.max_memory_allocated() / 1e9!r} GB", flush=True)
    if n_b1 < STRESS_SLICES:
        _fail(f"stress deployment: B1 launched {n_b1} times over "
              f"{STRESS_SLICES} event slices")

    def host_routers():
        """The device-routed router over ``svc`` and a host-routed one
        over the same plane, ingest off (the log owns every mutation)."""
        routers = _ms_routers(svc, MultiScenarioService("stress_host", plane))
        for r in routers.values():
            r.ingest = False
        return routers

    routers = host_routers()
    tels = {"host": Telemetry(), "device": Telemetry()}
    rng = stress_rng(0, STRESS_N, "default", "chip-traffic")

    def batch(b, t_lo):
        idx = rng.choice(STRESS_ROWS, size=REQ_ROWS, replace=False)
        rows = {c: v[idx] for c, v in ev.items()}
        rows["ts"] = (t_lo + 60 * b
                      + rng.integers(0, 60, REQ_ROWS)).astype(np.int32)
        names = plane.scenarios
        tags = np.array([names[int(i)] for i in
                         rng.integers(len(names), size=REQ_ROWS)])
        return rows, tags

    saved, walls = [], []
    for b in range(STRESS_BATCHES):
        rows, tags = batch(b, DAY)
        got, wall = _stress_serve(svc, routers, tels, rows, tags,
                                  f"stress deployment batch {b}")
        saved.append((rows, tags, got))
        walls.append(wall)
    spans = tels["device"].metrics.histogram("span_seconds", unit="s",
                                             labels=("name", "kind"))
    print(f"stress deployment: {STRESS_BATCHES} mixed batches x {REQ_ROWS} "
          f"rows over {len(plane.scenarios)} scenarios, device-routed == "
          f"host-routed bit for bit, B2 once a pump; fenced pump p50 "
          f"{1e3 * float(np.percentile(walls, 50))!r} ms, p99 "
          f"{1e3 * float(np.percentile(walls, 99))!r} ms; route.device mean "
          f"{1e3 * spans.mean(name='route.device', kind='device')!r} ms over "
          f"{int(spans.count(name='route.device', kind='device'))}",
          flush=True)

    # two views against a dedicated single-view store replaying the log
    first = next(v for v in initial if "items" in v.tables)
    pick = [first, next(v for v in initial if v is not first
                        and {"refunds", "clicks"} & set(v.tables))]
    for view in pick:
        ded = OnlineFeatureStore.create(
            view, num_keys=STRESS_ENTITIES, device=dev,
            **filter_table_knobs(kw, [view]))
        for t, b in log:
            if t == "events":
                ded.ingest(b)
            elif t in ded._sec_names:
                ded.ingest_table(t, b)
        n = 0
        for b, (rows, tags, got) in enumerate(saved):
            sel = tags == view.name
            if not sel.any():
                continue
            one = _np_answers(ded.query({c: v[sel] for c, v in rows.items()}))
            bad = _same_bits(one, got[view.name])
            if bad is not None:
                _fail(f"stress deployment batch {b} {view.name}/{bad}: the "
                      "plane's answers differ from a dedicated store's")
            n += int(sel.sum())
        if n == 0:
            _fail(f"stress deployment: no request was tagged {view.name}")
        print(f"stress deployment: dedicated {view.name} store (tables "
              f"{view.tables}, {_state_gb(ded)!r} GB) == the plane, bit for "
              f"bit, on {n} requests", flush=True)
        del ded
    torch.cuda.empty_cache()

    rows, tags = batch(STRESS_BATCHES, DAY)
    rows[SCENARIO_COL] = tags
    trace_request(svc, rows, results, key="trace_stress",
                  serve=lambda cols: svc.request_mixed(cols, ingest=False))

    # one hot-deploy wave of the held views, under the harness's protocol
    torch.cuda.reset_peak_memory_stats()
    refused, wave_s = 0, []
    for v in held:
        knobs = filter_table_knobs(
            {k: kw[k] for k in ("table_capacity", "table_ttl",
                                "secondary_num_keys")},
            list(plane.views.values()) + [v])
        try:
            mig, wall, _ = _deploy(svc.hot_deploy, f"stress wave {v.name}",
                                   v, **knobs)
        except ValueError as e:
            if "backfill" not in str(e):
                _fail(f"stress wave {v.name}: hot deploy raised {e}")
            refused += 1
            print(f"stress wave {v.name}: refused without a backfill ({e}); "
                  "retried with a BackfillSource of the ingest log",
                  flush=True)
            mig, wall, _ = _deploy(svc.hot_deploy, f"stress wave {v.name}",
                                   v, backfill=backfill_from_log(), **knobs)
        wave_s.append(wall)
        if not mig.exact:
            _fail(f"stress wave {v.name}: inexact migration: "
                  f"{'; '.join(mig.notes) or mig.diff_summary}")
        print(f"stress wave {v.name}: exact in {wall!r} s", flush=True)
    ingest_new_tables()
    print(f"stress wave: +{len(held)} views ({refused} refused then "
          f"backfilled), {float(np.mean(wave_s))!r} s a view, every migration "
          f"exact; state {_state_gb(store)!r} GB, peak during the wave "
          f"{torch.cuda.max_memory_allocated() / 1e9!r} GB", flush=True)
    if len(plane.scenarios) != STRESS_N:
        _fail(f"stress wave: {len(plane.scenarios)} live scenarios")
    rows, tags = batch(STRESS_BATCHES + 1, DAY)
    _stress_serve(svc, host_routers(), tels, rows, tags,
                  "stress after the wave")
    print(f"stress after the wave: one mixed batch over {STRESS_N} "
          "scenarios, device-routed == host-routed bit for bit", flush=True)
    del svc, routers, plane, store, saved, log
    torch.cuda.empty_cache()


def stress_path(results) -> None:
    """The stress harness on the card: (a) ``--smoke``; (b) its shrink and
    repro with one view forced to fail, the repro script run as a
    subprocess; (c) the N = 128 sweep; (d) ``bench_stress.py``'s ladder;
    (e) the 128 generated views at a deployment's size, with a hot-deploy
    wave.  Also the count-min sketch, card == CPU."""
    import os
    import shlex

    from repro_torch import kernels

    dev = "cuda"
    phase_t0 = time.perf_counter()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    _cms_check(dev)
    before = dict(kernels.LAUNCHES)

    # -- (a) the smoke run ---------------------------------------------------
    at = dict(kernels.LAUNCHES)
    rc, rep, files = _stress_cli(["--smoke", "--device", dev],
                                    "stress (a) --smoke")
    if rc != 0 or not rep.passed or files:
        _fail(f"stress (a): --smoke exit {rc}, files {sorted(files)}: "
              f"{rep.summary()}")
    _stress_report_is(rep, "stress (a)", 16, 6)
    d = _launch_delta(at)
    print(f"stress (a): B1 {d['fused_ingest']}, B2 {d['route_rank']}, B4 "
          f"{d['fold_levels']} launches", flush=True)

    # -- (b) shrink and repro --------------------------------------------------
    view = rep.verified[0].split(":")[0]
    rc, rep, files = _stress_cli(
        ["--smoke", "--force-fail", view, "--device", dev],
        "stress (b) --force-fail")
    fails = [(f.view, f.stage, f.shrunk_rows) for f in rep.failures]
    name = f"stress_repro_{view}.sh"
    if rc != 1 or fails != [(view, "verify", 60)] or list(files) != [name]:
        _fail(f"stress (b): exit {rc}, failures {fails}, files {list(files)}")
    cmd = files[name].strip().splitlines()[-1]
    if not cmd.startswith("PYTHONPATH=src python -m repro_torch.stress "
                          "--repro "):
        _fail(f"stress (b): the repro script runs {cmd!r}")
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    sub = subprocess.run(
        [sys.executable, "-m", "repro_torch.stress", *shlex.split(cmd)[4:]],
        cwd=root, env=dict(os.environ, PYTHONPATH="src"),
        capture_output=True, text=True, timeout=600)
    print(f"stress (b): `{cmd}` exit {sub.returncode} in "
          f"{time.perf_counter() - t0:.1f} s (a subprocess on the card): "
          f"{sub.stdout.strip()}", flush=True)
    if sub.returncode != 0 or not sub.stdout.startswith(f"[PASS] view={view} "):
        _fail(f"stress (b): the repro command failed: {sub.stderr[-2000:]}")

    # -- (c) the N = 128 sweep --------------------------------------------------
    at = dict(kernels.LAUNCHES)
    rc, rep, files = _stress_cli(["--n", str(STRESS_N), "--device", dev],
                                    "stress (c) --n 128")
    if rc != 0 or not rep.passed or files:
        _fail(f"stress (c): exit {rc}: {rep.summary()}")
    _stress_report_is(rep, "stress (c)", STRESS_N, 6)
    d = _launch_delta(at)
    print(f"stress (c): deploy_wall_s {rep.deploy_wall_s!r}, qps "
          f"{rep.qps!r}; B1 {d['fused_ingest']}, B2 {d['route_rank']}, B4 "
          f"{d['fold_levels']} launches", flush=True)
    abc = _launch_delta(before)
    print(f"stress (a)-(c): B1 {abc['fused_ingest']}, B2 "
          f"{abc['route_rank']}, B4 {abc['fold_levels']} launches in-process",
          flush=True)

    # -- (d) the ladder ------------------------------------------------------
    _stress_ladder(dev)

    # -- (e) deployment size --------------------------------------------------
    _stress_deployment(results, dev)

    d = _launch_delta(before)
    print(f"stress phase: {time.perf_counter() - phase_t0:.1f} s; B1 "
          f"{d['fused_ingest']}, B2 {d['route_rank']}, B4 {d['fold_levels']} "
          "launches", flush=True)
    if min(d.values()) <= 0:
        _fail(f"stress: a kernel of the path never launched: {d}")
    results["fused_ingest"]["launches_stress"] = d["fused_ingest"]
    results["route_rank"]["launches_stress"] = d["route_rank"]
    results["fold_levels"]["launches_stress"] = d["fold_levels"]


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
    multitable_path(results)
    multiscenario_path(results)
    deploy_path(results)
    families_path(results)
    platform_path(results)
    stress_path(results)
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
             library_ms=None, **results["route_rank"]),
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
