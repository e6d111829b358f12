"""Time the port's route kernel (B2), signature-embedding kernel (B5),
window-stats kernel (B3), flash attention's backward (B6-bwd), the WKV6
backward (B7-bwd), B6's and B7's kernels above head dim 256 and their
backward kernels above head dim 256 and 64, and B6's float32 forward,
alone, at their paths' shapes, in one checkout of this repository.

Usage, on a machine with an NVIDIA GPU and the CUDA toolkit::

    python3 scripts/torch_kernel_times.py [CHECKOUT] [--kernels b2,b5,b3,b6bwd,b7bwd,b6wide,b7wide,b6bwdwide,b7bwdwide,b6bwdf32,b6f32]

``CHECKOUT`` (default: this repository) is the root of the tree whose
``src/repro_torch`` is timed, so two commits compare on one card by
running the script once per tree, in turns (a, b, b, a, ...).  Shapes:
4,096 keys over 2^19 cards at 8 shards (B2); 4,096 signatures, k = 2, a
2^18 x 512 float32 table, cycling over 8 batches so that launches do not
find their rows in L2 (B5); for B3 the two shapes of ``chip_smoke.py``'s
window-stats phase, built and timed by that script's own helpers (this
repository's ``chip_smoke.py``, whatever the checkout): the main path's
warm state (2^19 cards over 8 shards after a day of 4,194,304
transactions) and the dense day (2^11 cards, 2^20 transactions), 8
batches of 4,096 requests each, windows 1 h and 6 h (on a tree with
B3's two instantiations also the shared-memory one forced at 2 x 2).
Each kernel is timed three ways: eager launches (CUDA events over many
calls: the host's launch path included), the same launches captured in a
CUDA graph, and the device time per launch under ``torch.profiler``; B3
also through its wrapper.  B6-bwd (``b6bwd``, not in the default set):
``attention_bwd`` in bf16 at ``chip_smoke.py``'s ``FA_BWD_SHAPES``, the
forward's lse handed over where the tree takes one, the sha256 of its
gradients (``b6bwd_<shape>_sha256``: two trees' bits compare), CUDA
events over 20 calls after 3 (``b6bwd_<shape>_ms``), the host's enqueue time a call
(``_host_ms``), each launch's device time under ``torch.profiler``
(``_<kernel>_ms``) and their sum (``_device_ms``); beside it SDPA's
backward (``chip_smoke.py``'s ``_sdpa_bwd``, a yardstick the port never
calls) under each backend that takes the shape, the same two ways
(``sdpa_<shape>_<backend>_ms``, ``..._device_ms``: every kernel a call
runs).  B7-bwd (``b7bwd``, not in the default set): ``launch_wkv6_bwd``
at rwkv6-3b's training call, (2, 40, 1024, 64) float32 on the model's
(B, T, H, D) views with no s0 / ds_fin, built by ``chip_smoke.py``'s
``_wkv6_inputs``: CUDA events over 20 calls after 3 (``b7bwd_ms``), the
host's enqueue time a call (``b7bwd_host_ms``), the device time a call
under ``torch.profiler``, the sum over the call's kernels
(``b7bwd_device_ms``, and by kernel ``b7bwd_<kernel>_ms``), and the
wrapper ``wkv6_bwd`` by CUDA events (``b7bwd_wrapper_ms``); the sha256 of
B7's forward output (y and the final state) at that shape with s0 and at
(2, 8, 100, 64) (``b7_fwd_sha256``), so two trees' forward bits compare.
B6 above head dim 256 (``b6wide``, not in the default set): ``attention``
at ``chip_smoke.py``'s ``d512`` shape, (2, 8 over 2, 1,024, 512) causal,
in bf16 and float32: CUDA events over 20 calls after 3
(``b6wide_<dtype>_ms``), the device time a call under ``torch.profiler``
summed over the kernels whose name holds ``fa_wide``
(``b6wide_<dtype>_device_ms``), and SDPA (``chip_smoke.py``'s
``_fa_library_call``, a yardstick the port never calls) the same two ways
(``sdpa_d512_<dtype>_ms``, ``..._device_ms``: every kernel of a call).
B7 above head dim 256 (``b7wide``, not in the default set):
``launch_wkv6`` with s0 at (2, 8, 256, 512) and (2, 8, 1,024, 512)
float32 on the model's views (``chip_smoke.py``'s ``_wkv6_inputs``):
events over 20 after 3 (``b7wide_<T>_ms``), the device time a call of the
kernels whose name holds ``wkv6_wide`` (``b7wide_<T>_device_ms``), and the
chunked plain version ``wkv6_chunked`` by events over 3
(``b7wide_<T>_plain_ms``).
B6-bwd above head dim 256 (``b6bwdwide``, not in the default set):
``attention_bwd`` at ``d512`` in bf16 and float32 (the forward's lse
handed over where the tree's forward writes one): CUDA events over 20 calls after 3
(``b6bwdwide_<dtype>_ms``), the device time a call under
``torch.profiler`` by kernel (``b6bwdwide_<dtype>_<kernel>_ms``) and
summed (``b6bwdwide_<dtype>_device_ms``); in float32 also not causal
(``b6bwdwide_f32_full_...``); SDPA's backward under each
backend that takes the shape the same two ways
(``sdpa_bwd_d512_<dtype>_<backend>_ms``, ``..._device_ms``).  B7-bwd
above head dim 64 (``b7bwdwide``, not in the default set): ``wkv6_bwd``,
the training call (no s0 / ds_fin) on the model's views, at
``chip_smoke.py``'s ``WKV_BWD_WIDE_PATH`` -- rwkv6-3b's width at D = 128
and 256, (2, 8, 256 / 1,024, 512): events over 10 after 2
(``b7bwdwide_<name>_ms``), the device time a call by kernel and
summed (``b7bwdwide_<name>_device_ms``) and the memory a call takes
beyond its inputs (``b7bwdwide_<name>_peak_bytes``); also at
``WKV_BWD_WIDE_BIG`` (``b7bwdwide_big_...``), whose partials pass the
scratch cap.  B6-bwd in float32 (``b6bwdf32``, not in the default set):
``attention_bwd`` at ``chip_smoke.py``'s ``FA_BWD_SHAPES`` and ``d512`` in
float32, the forward's lse handed over where the tree's float32 forward
writes one: CUDA events over 10 calls after 2 (``b6bwdf32_<shape>_ms``),
the device time a call by kernel (``b6bwdf32_<shape>_<kernel>_ms``) and
summed (``b6bwdf32_<shape>_device_ms``); SDPA's float32 backward under
each backend that takes the shape the same two ways
(``sdpa_bwd_f32_<shape>_<backend>_ms``, ``..._device_ms``).  A tree
whose backward has no kernel at these head dims records the error it
raises (``..._error``) in place of its times.  B6's float32 forward up to head
dim 256 (``b6f32``, not in the default set): ``attention`` under
``no_grad`` at every shape of ``chip_smoke.py``'s ``FA_PATH_SHAPES`` with
D <= 256, float32: its output's sha256 (``b6f32_<shape>_sha256``), CUDA
events over 10 calls after 2 (``b6f32_<shape>_ms``), the device time a
call of the kernels whose name holds ``fa_`` under ``torch.profiler``
(``b6f32_<shape>_device_ms``), the bound -- bytes over 3.35 TB/s against
the operations as three TF32 products at 495 TFLOP/s, and at the float32
peak (``b6f32_<shape>_bound_ms``, ``..._bytes_ms``, ``..._tf32x3_ms``,
``..._f32_peak_ms``) -- and SDPA in float32 under each backend that takes
the shape, the same two ways (``sdpa_f32_<shape>_<backend>_ms``,
``..._device_ms``).
Entries a
tree does not have (the route kernel from keys, B5 from signatures) are
left out.  Prints one JSON line.
"""

import json
import sys
from pathlib import Path

import numpy as np
import torch


def _events_ms(fn, reps=200, warm=10):
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _graph_ms(fn, reps=50):
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    return _events_ms(g.replay, 5, 1) / reps


def _device_ms(fn, name, reps=50):
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in p.key_averages()
            if e.device_type == DeviceType.CUDA and name in e.key]
    n = sum(e.count for e in hits)
    return (sum(e.self_device_time_total for e in hits) / 1e3 / n
            if n else float("nan"))


def _b3(out) -> None:
    """B3 at chip_smoke.py's two shapes, timed by its helpers; a tree from
    before B3 took its windows by value hands them over as a tensor."""
    import chip_smoke as cs
    from repro_torch.data.synthetic import fraud_transactions
    from repro_torch.kernels.window_agg import ops as wops
    from repro_torch.scenarios import fraud_view
    from repro_torch.serve.service import FeatureService

    B = cs.STORE_KW["bucket_size"]
    if hasattr(wops, "plan_window_stats"):
        def launch(args, o):
            wops.launch_window_stats(*args, cs.WINDOWS, o, B)
    else:
        wt = torch.tensor(cs.WINDOWS, dtype=torch.int32, device="cuda")

        def launch(args, o):
            wops.launch_window_stats(*args, wt, o, B)

    svc = FeatureService.build(
        "fraud", fraud_view(), num_keys=cs.NUM_CARDS, sharded=True,
        num_shards=cs.NUM_SHARDS, mode="preagg", device="cuda", **cs.STORE_KW,
    )
    rng = np.random.default_rng(cs.SEED)
    for i in range(cs.WARM_SLICES):
        svc.store.ingest(fraud_transactions(
            rng, cs.SLICE_ROWS, cs.NUM_CARDS, i * cs.DAY // cs.WARM_SLICES,
            (i + 1) * cs.DAY // cs.WARM_SLICES))
    dense = cs._dense_store()
    for tag, st, cards, t0 in (("main", svc.store, cs.NUM_CARDS, cs.DAY),
                               ("dense", dense, cs.DENSE_CARDS, cs.DAY)):
        batches = cs._ws_batches(st, rng, cards, t0)
        times = cs._ws_times(batches, launch, wops.window_stats, B)
        out.update({f"b3_{tag}_{k}": v for k, v in times.items()})
        if hasattr(wops, "WindowStatsLaunch"):
            # the shared-memory instantiation at the fraud view's 2 x 2: it
            # folds each slot as it loads it
            plan = wops.plan_window_stats
            wops.plan_window_stats = lambda nw, lanes: (wops.WindowStatsLaunch(
                0, nw, 0, lanes, False, 8, 8 * 9 * nw * lanes * 128),)
            try:
                times = cs._ws_times(batches, launch, wops.window_stats, B)
            finally:
                wops.plan_window_stats = plan
            out.update({f"b3_{tag}_general_{k}": v for k, v in times.items()})


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_kernel_times: needs an NVIDIA GPU")
    argv = sys.argv[1:]
    todo = {"b2", "b5", "b3"}
    if "--kernels" in argv:
        i = argv.index("--kernels")
        todo = set(argv[i + 1].split(","))
        del argv[i:i + 2]
    repo = Path(__file__).resolve().parents[1]
    root = Path(argv[0]) if argv else repo
    sys.path.insert(0, str(root / "src"))
    sys.path.insert(1, str(repo))  # chip_smoke.py's helpers, for B3
    from repro_torch.kernels import build
    names = {"b2": ["route_rank"], "b5": ["signature_embed"],
             "b3": ["window_stats", "fused_ingest", "route_rank"],
             "b6bwd": ["flash_attention", "flash_attention_bwd"],
             "b7bwd": ["wkv6", "wkv6_bwd"],
             "b6wide": ["flash_attention"], "b7wide": ["wkv6"],
             "b6bwdwide": ["flash_attention", "flash_attention_bwd"],
             "b6bwdf32": ["flash_attention", "flash_attention_bwd"],
             "b6f32": ["flash_attention"],
             "b7bwdwide": ["wkv6", "wkv6_bwd"]}
    build.build(sorted({n for k in todo for n in names[k]}))
    out = {"tree": str(root)}
    if "b3" in todo:
        _b3(out)
    if "b6bwd" in todo:
        _b6_bwd(out)
    if "b7bwd" in todo:
        _b7_bwd(out)
    if "b6wide" in todo:
        _b6_wide(out)
    if "b7wide" in todo:
        _b7_wide(out)
    if "b6bwdwide" in todo:
        _b6_bwd_wide(out)
    if "b6bwdf32" in todo:
        _b6_bwd_f32(out)
    if "b6f32" in todo:
        _b6_f32(out)
    if "b7bwdwide" in todo:
        _b7_bwd_wide(out)
    if todo & {"b2", "b5"}:
        _b2_b5(out, todo)
    print(json.dumps(out))


def _b6_bwd(out) -> None:
    """B6's backward at chip_smoke.py's training-path shapes, bf16."""
    import inspect
    import time

    import chip_smoke as cs
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import ops

    takes_lse = "lse" in inspect.signature(ops.attention_bwd).parameters
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 21)
    for name, shape in cs.FA_BWD_SHAPES.items():
        causal, window = shape[5:]
        kw = dict(causal=causal, window=window)
        q, k, v = cs._fa_inputs(gen, shape, torch.bfloat16)
        if takes_lse:
            o, kw["lse"] = ops.attention_with_lse(q, k, v, **kw)
        else:
            o = ops.attention(q, k, v, **kw)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(q.dtype)

        def call():
            return ops.attention_bwd(q, k, v, o, do, **kw)

        out[f"b6bwd_{name}_sha256"] = _sha256(call())
        out[f"b6bwd_{name}_ms"] = _events_ms(call, 20, 3)
        t0 = time.perf_counter()
        for _ in range(20):
            call()
        out[f"b6bwd_{name}_host_ms"] = 1e3 * (time.perf_counter() - t0) / 20
        _by_kernel(call, r"bwd_(delta|dq|dkdv|reduce)\w*_kernel",
                   f"b6bwd_{name}", out)
        for backend in (SDPBackend.FLASH_ATTENTION,
                        SDPBackend.EFFICIENT_ATTENTION,
                        SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
            try:
                with sdpa_kernel([backend]):
                    fn = cs._sdpa_bwd(q, k, v, do, shape)
                    fn()
            except RuntimeError:
                continue
            key = f"sdpa_{name}_{backend.name.lower()}"
            out[f"{key}_ms"] = _events_ms(fn, 20, 3)
            out[f"{key}_device_ms"] = _profiled_ms(fn, None)
            del fn
        del q, k, v, o, do, kw
        torch.cuda.empty_cache()


def _b7_bwd(out) -> None:
    """B7's backward at rwkv6-3b's training call; B7's forward bits."""
    import hashlib
    import time

    import chip_smoke as cs

    from repro_torch.kernels.wkv6 import ops

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 22)
    sha = hashlib.sha256()
    for shape in ((2, 40, 1024, 64), (2, 8, 100, 64)):
        r, k, v, lw, u, s0 = cs._wkv6_inputs(gen, shape)
        with torch.no_grad():
            y, s_fin = ops.wkv6(r, k, v, lw, u, s0)
        torch.cuda.synchronize()
        for x in (y, s_fin):
            sha.update(x.contiguous().cpu().numpy().tobytes())
    out["b7_fwd_sha256"] = sha.hexdigest()

    train = (2, 40, 1024, 64)
    r, k, v, lw, u, _ = cs._wkv6_inputs(gen, train)
    dy = torch.randn((train[0], train[2], train[1], 64), generator=gen,
                     device="cuda").transpose(1, 2)
    outs = [torch.empty_like(t) for t in (r, k, v, lw)]
    du_part = torch.empty((train[0], train[1], 64), device="cuda")

    def call():
        ops.launch_wkv6_bwd(r, k, v, lw, dy, u, None, None, *outs, du_part,
                            None)

    out["b7bwd_ms"] = _events_ms(call, 20, 3)
    t0 = time.perf_counter()
    for _ in range(20):
        call()
    out["b7bwd_host_ms"] = 1e3 * (time.perf_counter() - t0) / 20
    _by_kernel(call, r"(wkv6_bwd\w*kernel)", "b7bwd", out)

    out["b7bwd_wrapper_ms"] = _events_ms(
        lambda: ops.wkv6_bwd(r, k, v, lw, u, None, dy), 20, 3)


def _profiled_ms(fn, match, reps=5) -> float:
    """Device time a call of ``fn``: the kernels whose name holds
    ``match`` (every kernel when it is None), under ``torch.profiler``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in p.key_averages()
               if e.device_type == DeviceType.CUDA
               and (match is None or match in e.key)) / 1e3 / reps


def _b6_wide(out) -> None:
    """B6 above head dim 256 at chip_smoke.py's d512 shape, both dtypes,
    beside SDPA."""
    import chip_smoke as cs

    from repro_torch.kernels.flash_attention import ops

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 23)
    shape = cs.FA_PATH_SHAPES["d512"]
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        q, k, v = cs._fa_inputs(gen, shape, dtype)

        def call():
            ops.attention(q, k, v, causal=shape[5], window=shape[6])

        lib = cs._fa_library_call(q, k, v, shape)
        out[f"b6wide_{tag}_ms"] = _events_ms(call, 20, 3)
        out[f"b6wide_{tag}_device_ms"] = _profiled_ms(call, "fa_wide")
        out[f"sdpa_d512_{tag}_ms"] = _events_ms(lib, 20, 3)
        out[f"sdpa_d512_{tag}_device_ms"] = _profiled_ms(lib, None)
        del q, k, v, lib
        torch.cuda.empty_cache()


def _b7_wide(out) -> None:
    """B7 above head dim 256 at (2, 8, T, 512), T = 256 and 1,024."""
    import chip_smoke as cs

    from repro_torch.kernels.wkv6 import ops

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 24)
    for shape in (cs.WKV_WIDE_TIMED, cs.WKV_WIDE_TIMED_LONG):
        r, k, v, lw, u, s0 = cs._wkv6_inputs(gen, shape)
        y, s = torch.empty_like(r), torch.empty_like(s0)

        def call():
            ops.launch_wkv6(r, k, v, lw, u, s0, y, s)

        tag = f"b7wide_{shape[2]}"
        out[f"{tag}_ms"] = _events_ms(call, 20, 3)
        out[f"{tag}_device_ms"] = _profiled_ms(call, "wkv6_wide")
        out[f"{tag}_plain_ms"] = _events_ms(
            lambda: ops.wkv6_chunked(r, k, v, lw, u, s0), 3, 1)
        del r, k, v, lw, u, s0, y, s
        torch.cuda.empty_cache()


def _by_kernel(fn, pattern, key, out, reps=5) -> None:
    """Each CUDA kernel of a call of ``fn`` whose name ``pattern`` finds,
    its device time a call under ``torch.profiler`` as
    ``<key>_<group 1>_ms``, and their sum as ``<key>_device_ms``."""
    import re

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as p:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for e in p.key_averages():
        m = re.search(pattern, e.key)
        if e.device_type == DeviceType.CUDA and m:
            k = f"{key}_{m.group(1)}_ms"
            out[k] = out.get(k, 0.0) + e.self_device_time_total / 1e3 / reps
            total += e.self_device_time_total / 1e3 / reps
    out[f"{key}_device_ms"] = total


def _b6_bwd_wide(out) -> None:
    """B6's backward above head dim 256 at chip_smoke.py's d512 shape, both
    dtypes, beside SDPA's backward under each backend."""
    import chip_smoke as cs
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attention import ops

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 25)
    shape = cs.FA_PATH_SHAPES["d512"]
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        q, k, v = cs._fa_inputs(gen, shape, dtype)
        do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
        key = f"b6bwdwide_{tag}"
        try:
            try:
                o, lse = ops.attention_with_lse(q, k, v)
            except ValueError:  # a float32 forward that writes no lse
                o, lse = ops.attention(q, k, v), None

            def call():
                ops.attention_bwd(q, k, v, o, do, lse=lse)

            call()
            out[f"{key}_ms"] = _events_ms(call, 20, 3)
            _by_kernel(call, r"(bwd_\w+?_kernel)", key, out)
            if dtype == torch.float32:
                # the same call over every key (twice the query-key
                # pairs, each dK / dV block the causal first tile's walk)
                o_full = ops.attention(q, k, v, causal=False)

                def full():
                    ops.attention_bwd(q, k, v, o_full, do, causal=False)

                full()
                _by_kernel(full, r"(bwd_\w+?_kernel)", f"{key}_full", out)
                del o_full
        except (NotImplementedError, ValueError) as e:
            out[f"{key}_error"] = f"{type(e).__name__}: {str(e)[:120]}"
        for backend in (SDPBackend.FLASH_ATTENTION,
                        SDPBackend.EFFICIENT_ATTENTION,
                        SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
            try:
                with sdpa_kernel([backend]):
                    fn = cs._sdpa_bwd(q, k, v, do, shape)
                    fn()
            except RuntimeError:
                continue
            sk = f"sdpa_bwd_d512_{tag}_{backend.name.lower()}"
            out[f"{sk}_ms"] = _events_ms(fn, 20, 3)
            out[f"{sk}_device_ms"] = _profiled_ms(fn, None)
            del fn
        del q, k, v, do
        torch.cuda.empty_cache()


def _sha256(tensors) -> str:
    """The sha256 of the tensors' bytes, in order: two trees' bits compare
    by it."""
    import hashlib

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _sdpa_backends(out, key, make) -> None:
    """``make()`` (a call) under each SDPA backend that takes it: CUDA
    events over 10 calls after 2 (``<key>_<backend>_ms``) and the device
    time a call, every kernel (``..._device_ms``)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    for backend in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
                    SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        k = f"{key}_{backend.name.lower()}"
        with sdpa_kernel([backend]):
            try:
                fn = make()
                fn()
            except RuntimeError:
                continue
            out[f"{k}_ms"] = _events_ms(fn, 10, 2)
            out[f"{k}_device_ms"] = _profiled_ms(fn, None)
        del fn
        torch.cuda.empty_cache()


def _b6_bwd_f32(out) -> None:
    """B6's backward in float32 at chip_smoke.py's training-path shapes
    and d512, beside SDPA's backward under each backend."""
    import chip_smoke as cs

    from repro_torch.kernels.flash_attention import ops

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 26)
    shapes = dict(cs.FA_BWD_SHAPES, d512=cs.FA_PATH_SHAPES["d512"])
    for name, shape in shapes.items():
        causal, window = shape[5:]
        kw = dict(causal=causal, window=window)
        q, k, v = cs._fa_inputs(gen, shape, torch.float32)
        do = torch.randn(q.shape, generator=gen, device="cuda")
        key = f"b6bwdf32_{name}"
        try:
            try:
                o, lse = ops.attention_with_lse(q, k, v, **kw)
            except ValueError:  # a float32 forward that writes no lse
                o, lse = ops.attention(q, k, v, **kw), None

            def call():
                ops.attention_bwd(q, k, v, o, do, lse=lse, **kw)

            call()
            out[f"{key}_ms"] = _events_ms(call, 10, 2)
            _by_kernel(call, r"(bwd_\w+?_kernel)", key, out)
            del o, lse
        except (NotImplementedError, ValueError, RuntimeError) as e:
            out[f"{key}_error"] = f"{type(e).__name__}: {str(e)[:120]}"
        _sdpa_backends(out, f"sdpa_bwd_f32_{name}",
                       lambda: cs._sdpa_bwd(q, k, v, do, shape))
        del q, k, v, do
        torch.cuda.empty_cache()


def _b6_f32(out) -> None:
    """B6's float32 forward at chip_smoke.py's path shapes up to head dim
    256, beside SDPA in float32 under each backend that takes the shape."""
    import chip_smoke as cs

    from repro_torch.kernels.flash_attention import ops

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 35)
    for name, shape in cs.FA_PATH_SHAPES.items():
        if shape[4] > 256:
            continue
        causal, window = shape[5:]
        q, k, v = cs._fa_inputs(gen, shape, torch.float32)
        key = f"b6f32_{name}"
        nbytes, flop = cs._fa_cost(shape, 4)
        by_bytes = 1e3 * nbytes / cs.HBM_BYTES_PER_S
        by_ops = 3e3 * flop / cs.TF32_FLOP_PER_S
        out.update({f"{key}_bytes_ms": by_bytes, f"{key}_tf32x3_ms": by_ops,
                    f"{key}_f32_peak_ms": 1e3 * flop / cs.FP32_FLOP_PER_S,
                    f"{key}_bound_ms": max(by_bytes, by_ops)})
        with torch.no_grad():
            def fwd():
                return ops.attention(q, k, v, causal=causal, window=window)

            out[f"{key}_sha256"] = _sha256([fwd()])
            out[f"{key}_ms"] = _events_ms(fwd, 10, 2)
            out[f"{key}_device_ms"] = _profiled_ms(fwd, "fa_")
            _sdpa_backends(out, f"sdpa_f32_{name}",
                           lambda: cs._fa_library_call(q, k, v, shape))
        del q, k, v
        torch.cuda.empty_cache()


def _b7_bwd_wide(out) -> None:
    """B7's backward above head dim 64 at chip_smoke.py's
    WKV_BWD_WIDE_PATH, the training call (no s0 / ds_fin)."""
    import chip_smoke as cs

    from repro_torch.kernels.wkv6 import ops

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 26)
    shapes = dict(cs.WKV_BWD_WIDE_PATH, big=cs.WKV_BWD_WIDE_BIG)
    for name, shape in shapes.items():
        r, k, v, lw, u, _ = cs._wkv6_inputs(gen, shape)
        dy = torch.randn(shape, generator=gen, device="cuda")
        key = f"b7bwdwide_{name}"

        def call():
            ops.wkv6_bwd(r, k, v, lw, u, None, dy)

        try:
            torch.cuda.synchronize()
            held = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            call()
            torch.cuda.synchronize()
            out[f"{key}_peak_bytes"] = torch.cuda.max_memory_allocated() - held
            out[f"{key}_ms"] = _events_ms(call, 10, 2)
            _by_kernel(call, r"(wkv6_bwd\w*?_kernel)", key, out)
        except (NotImplementedError, RuntimeError) as e:
            out[f"{key}_error"] = f"{type(e).__name__}: {str(e)[:120]}"
        del r, k, v, lw, u, dy
        torch.cuda.empty_cache()


def _b2_b5(out, todo) -> None:
    from repro_torch.core.hashing import KeyPermutation
    from repro_torch.core.signature import multi_hash_ids
    from repro_torch.kernels.route import ops as rops
    from repro_torch.kernels.signature import ops as sops

    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    perm = KeyPermutation(1 << 19)
    keys = rng.integers(0, 1 << 19, 4096).astype(np.int32)
    if "b2" in todo:
        shard = torch.as_tensor((perm(keys) % 8).astype(np.int32), device=dev)

        def rank():
            return rops.route_rank(shard, num_shards=8)

        out["route_rank_eager"] = _events_ms(rank)
        out["route_rank_device"] = _device_ms(rank, "route")
        if hasattr(rops, "route_keys"):
            k = torch.as_tensor(keys, device=dev)
            v = torch.ones(4096, dtype=torch.bool, device=dev)

            def route():
                return rops.route_keys(k, v, perm, num_shards=8)

            out["route_keys_eager"] = _events_ms(route)
            out["route_keys_device"] = _device_ms(route, "route_kernel")

    if "b5" not in todo:
        return
    g = torch.Generator(device=dev).manual_seed(6)
    table = torch.randn((1 << 18, 512), generator=g, device=dev) * 0.02
    w = torch.full((2,), 0.5, device=dev)
    sigs = [torch.as_tensor(rng.integers(0, 2**20, 4096).astype(np.int32),
                            device=dev) for _ in range(8)]
    ids = [multi_hash_ids(s, 2, 1 << 18) for s in sigs]
    o = torch.empty((4096, 512), device=dev)
    step = iter(range(10**9))

    def nxt():
        return next(step) % 8

    def from_ids():
        sops.launch_signature_embed(table, ids[nxt()], w, o)

    out["b5_ids_eager"] = _events_ms(from_ids, 80, 8)
    out["b5_ids_graph"] = _graph_ms(from_ids, 80)
    out["b5_ids_device"] = _device_ms(from_ids, "signature_embed", 80)
    out["b5_wrapper_eager"] = _events_ms(
        lambda: sops.signature_embed(table, sigs[nxt()], w, num_hashes=2),
        80, 8)
    if hasattr(sops, "launch_signature_embed_sig"):
        def from_sig():
            sops.launch_signature_embed_sig(table, sigs[nxt()], w, o)

        out["b5_sig_eager"] = _events_ms(from_sig, 80, 8)
        out["b5_sig_graph"] = _graph_ms(from_sig, 80)
        out["b5_sig_device"] = _device_ms(from_sig, "signature_embed", 80)


if __name__ == "__main__":
    main()
