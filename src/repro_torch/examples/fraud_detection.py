"""Scenario 2 (§3.3) — online fraud detection, end to end: the twin of the
reference package's ``examples/fraud_detection.py``.

The full production loop on a reduced scale:

  1. design the fraud feature view (trailing windows + device novelty),
  2. offline: export the training set, train the scoring transformer
     (featinsight-fraud smoke config) on those features, through the
     scoring service's own forward,
  3. online: deploy view + model as a ScoringService, replay the unseen
     tail of the stream through it (query -> score -> ingest),
  4. report: serving latency / QPS, and recall vs an amount-threshold
     baseline — the paper's claim is that window features lift recall
     while staying inside the latency budget.

Offline/online consistency (§2) is what makes step 2 -> 3 legitimate:
the model trains on offline features and serves on online features
computed by the same definition.  On the card the export runs the
fold-levels kernel (B4), training runs flash attention (B6) forward and
backward, the replay's queries and ingests the fused ingest kernel (B1)
and its scoring B6's forward.

Run:  PYTHONPATH=src python -m repro_torch.examples.fraud_detection [--steps 150] [--device D]
"""

from __future__ import annotations

import argparse
import time
from typing import Dict

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs.featinsight_fraud import smoke_config
from repro_torch.convert import reference_names
from repro_torch.core import FeatureRegistry, OfflineEngine, OnlineFeatureStore
from repro_torch.data.synthetic import fraud_stream
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamWConfig, adamw_init, adamw_update
from repro_torch.scenarios import fraud_view
from repro_torch.serve.service import FeatureService, ScoringService

N_ROWS = 4_000
NUM_CARDS = 64
SPLIT = 0.8

# the canonical fraud view (repro_torch.scenarios / docs/CATALOG_TORCH.md)
# includes a 6h window: the online stores need enough pre-agg buckets to
# cover it
STORE_KW = dict(num_keys=NUM_CARDS, num_buckets=512, bucket_size=64)


def main(steps: int = 150, device="cuda") -> Dict:
    dev = resolve_device(device)
    rng = np.random.default_rng(42)
    cols, label = fraud_stream(rng, N_ROWS, num_cards=NUM_CARDS, t_max=40_000)
    n_train = int(N_ROWS * SPLIT)
    print(f"stream: {N_ROWS} tx, fraud rate {label.mean():.3f}")

    # ---- 1+2. offline: view -> training set -> train scorer ----------------
    view = fraud_view()
    registry = FeatureRegistry()
    registry.register(view)
    engine = OfflineEngine(device=dev)
    train_cols = {c: v[:n_train] for c, v in cols.items()}
    feats = engine.export_training_set(view, train_cols, label=None)
    fnames = sorted(view.features)
    X = np.stack([feats[f] for f in fnames], -1).astype(np.float32)
    y = label[:n_train]
    mu, sd = X.mean(0), X.std(0) + 1e-6

    cfg = smoke_config()
    model = build_model(cfg, seed=0, device=dev)
    own = dict(model.named_parameters())
    params = {n: own[n] for n in reference_names(model)}
    opt = adamw_init(params)
    ocfg = AdamWConfig(lr_peak=1e-3, warmup_steps=10, decay_steps=steps,
                       weight_decay=0.01)
    table = torch.as_tensor(rng.normal(0, 0.02, (1 << 12, cfg.d_model)),
                            dtype=torch.float32, device=dev)

    fs_stub = FeatureService(
        "fraud_svc", view,
        OnlineFeatureStore(view, device=dev, **STORE_KW), registry,
    )
    svc = ScoringService(fs_stub, model, table)

    def featvec(Xb):
        Z = (Xb - mu) / sd
        pad = np.zeros((Z.shape[0], cfg.d_model - Z.shape[1]), np.float32)
        return torch.as_tensor(np.concatenate([Z, pad], -1), device=dev)

    def loss_fn(fv, emb, yb):
        prob = svc._score(fv, emb)
        eps = 1e-6
        return -torch.mean(
            yb * torch.log(prob + eps) + (1 - yb) * torch.log(1 - prob + eps)
            + 0.0 * prob
        )

    emb0 = torch.zeros((256, cfg.d_model), dtype=torch.float32, device=dev)
    plist = list(params.values())
    t0 = time.perf_counter()
    losses = []
    for step in range(steps):
        idx = rng.integers(0, n_train, 256)
        fv = featvec(X[idx])
        yb = torch.as_tensor(y[idx], dtype=torch.float32, device=dev)
        loss = loss_fn(fv, emb0[: len(idx)], yb)
        gs = torch.autograd.grad(loss, plist)
        grads = {n: g.to(torch.float32) for n, g in zip(params, gs)}
        new, opt, _ = adamw_update(ocfg, grads, opt, cfg.pdtype)
        with torch.no_grad():
            for n, p in params.items():
                p.copy_(new[n])
        losses.append(float(loss.detach()))
        if step % 50 == 0 or step == steps - 1:
            print(f"  train step {step:4d} loss {losses[-1]:.4f}")
    print(f"offline training: {steps} steps "
          f"in {time.perf_counter() - t0:.1f}s")

    # ---- 3. online: deploy + replay the unseen tail -------------------------
    store = OnlineFeatureStore(view, device=dev, **STORE_KW)
    order = np.lexsort((train_cols["ts"], train_cols["card"]))
    store.ingest({c: v[order] for c, v in train_cols.items()})
    fsvc = FeatureService("fraud_svc", view, store, registry)

    probs = np.zeros(N_ROWS - n_train, np.float32)
    B = 50  # divides the 800-row tail
    with torch.inference_mode():
        # warm the serving path before the timed replay
        warm = {c: v[:B] for c, v in train_cols.items()}
        store.query(warm)
        svc._score(featvec(np.zeros((B, len(fnames)), np.float32)), emb0[:B])
        fsvc.stats.batches = fsvc.stats.requests = 0
        fsvc.stats.total_latency_s = 0.0
        t0 = time.perf_counter()
        for i in range(n_train, N_ROWS, B):
            j = min(i + B, N_ROWS)
            rows = {c: v[i:j] for c, v in cols.items()}
            out = fsvc.request(rows, ingest=True)  # query then ingest
            Xb = np.stack([np.asarray(out[f]) for f in fnames], -1)
            pr = svc._score(featvec(Xb), emb0[: j - i])
            probs[i - n_train:j - n_train] = pr.cpu().numpy()
        dt = time.perf_counter() - t0
    n_served = N_ROWS - n_train
    print(f"online serving: {n_served} tx in {dt:.2f}s "
          f"({n_served / dt:.0f} QPS, {fsvc.stats.mean_latency_ms:.2f} ms/batch)")

    # ---- 4. recall vs baseline ----------------------------------------------
    y_test = label[n_train:]
    k = max(1, int(y_test.sum()))

    def recall_at_k(score):
        top = np.argsort(-score)[:k]
        return y_test[top].sum() / max(1, y_test.sum())

    r_model = recall_at_k(probs)
    r_base = recall_at_k(cols["amount"][n_train:])
    print(f"recall@{k}: featinsight-features model {r_model:.2f} "
          f"vs amount-threshold baseline {r_base:.2f}")
    print("fraud_detection OK")
    return {"losses": losses, "probs": probs, "recall_model": r_model,
            "recall_baseline": r_base, "k": k, "features": feats,
            "qps": n_served / dt}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.strip().splitlines()[0])
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    a = ap.parse_args()
    main(a.steps, device=a.device)
