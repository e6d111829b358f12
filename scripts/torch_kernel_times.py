"""Time the port's route kernel (B2) and signature-embedding kernel (B5)
alone, at the main path's shapes, in one checkout of this repository.

Usage, on a machine with an NVIDIA GPU and the CUDA toolkit::

    python3 scripts/torch_kernel_times.py [CHECKOUT]

``CHECKOUT`` (default: this repository) is the root of the tree whose
``src/repro_torch`` is timed, so two commits compare on one card by
running the script once per tree, in turns (a, b, b, a, ...).  Shapes:
4,096 keys over 2^19 cards at 8 shards (B2); 4,096 signatures, k = 2, a
2^18 x 512 float32 table, cycling over 8 batches so that launches do not
find their rows in L2 (B5).  Each kernel is timed three ways: eager
launches (CUDA events over many calls: the host's launch path included),
the same launches captured in a CUDA graph, and its device time per launch
under ``torch.profiler``.  Entries a tree does not have (the route kernel
from keys, B5 from signatures) are left out.  Prints one JSON line.
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


def main() -> None:
    if not torch.cuda.is_available():
        sys.exit("torch_kernel_times: needs an NVIDIA GPU")
    root = Path(sys.argv[1] if len(sys.argv) > 1 else
                Path(__file__).resolve().parents[1])
    sys.path.insert(0, str(root / "src"))
    from repro_torch.core.hashing import KeyPermutation
    from repro_torch.core.signature import multi_hash_ids
    from repro_torch.kernels.route import ops as rops
    from repro_torch.kernels.signature import ops as sops

    dev = torch.device("cuda", 0)
    out = {}
    rng = np.random.default_rng(0)
    perm = KeyPermutation(1 << 19)
    keys = rng.integers(0, 1 << 19, 4096).astype(np.int32)
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
    print(json.dumps(out))


if __name__ == "__main__":
    main()
