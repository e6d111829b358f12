"""Guards on the PyTorch port's boundaries.

* No JAX: importing every module of ``repro_torch`` (in a fresh
  subprocess) loads neither ``jax`` nor ``repro``, and no source file of
  the port imports them (AST scan).
* No silent CPU: the only place a device string is turned into the CPU is
  :func:`repro_torch.resolve_device`, which a caller reaches only by
  passing ``device="cpu"``; no other module names the CPU device, and on
  a machine without a GPU every entry point raises unless asked for the
  CPU.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
SOURCES = sorted(PKG.rglob("*.py"))


def _module_names():
    for p in SOURCES:
        rel = p.relative_to(PKG.parent).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        yield ".".join(parts)


def test_port_imports_no_jax_in_subprocess():
    mods = list(_module_names())
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'repro' or m.startswith('repro.'))\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = str(PKG.parent)
    res = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        env=env, timeout=120,
    )
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(mods) >= 20


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_port_source_imports_no_jax_and_names_no_cpu(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for name in _imports(tree):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {name}"
    if path == PKG / "__init__.py":
        return  # resolve_device: the one place "cpu" is a valid answer
    for node in ast.walk(tree):
        if isinstance(node, ast.Constant) and node.value == "cpu":
            raise AssertionError(
                f"{path}:{node.lineno}: names the CPU device; only "
                "repro_torch.resolve_device may"
            )


def test_entry_points_refuse_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("checks the no-GPU behaviour")
    from repro_torch import resolve_device
    from repro_torch.convert import online_state_from_numpy
    from repro_torch.core.online import OnlineFeatureStore
    from repro_torch.core.shard import ShardedOnlineStore
    from repro_torch.scenarios import fraud_view
    from repro_torch.serve.service import FeatureService

    view = fraud_view()
    kw = dict(num_keys=64, num_buckets=512)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        OnlineFeatureStore(view, **kw)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ShardedOnlineStore(view, num_shards=4, **kw)
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        FeatureService.build("f", view, sharded=True, num_shards=2, **kw)
    from repro_torch.core.consistency import verify_view
    from repro_torch.core.engine import OfflineEngine

    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        OfflineEngine()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        verify_view(view, {}, num_keys=64, num_buckets=512)
    arrays = [np.zeros(1, t) for t in (np.int32, np.float32, np.int32,
                                      np.float32, np.int32, np.int32)]
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        online_state_from_numpy(arrays, bucket_size=64)
    # asked for the CPU, they run
    store = ShardedOnlineStore(view, num_shards=4, device="cpu", **kw)
    assert store.state.ring.ts.device.type == "cpu"


@pytest.mark.parametrize("num_shards", [None, 4])
def test_out_of_range_keys_rejected(num_shards):
    """Keys outside [0, num_keys) raise on ingest and query instead of
    addressing another key's state (or, on a GPU, memory past the state)."""
    from repro_torch.scenarios import fraud_view
    from repro_torch.serve.service import FeatureService

    svc = FeatureService.build(
        "f", fraud_view(), num_keys=64, num_buckets=512, device="cpu",
        sharded=num_shards is not None, num_shards=num_shards,
    )
    for bad in (64, -1):
        cols = dict(card=np.array([3, bad], np.int32),
                    ts=np.array([10, 11], np.int32),
                    amount=np.ones(2, np.float32),
                    mcc=np.zeros(2, np.int32), device=np.zeros(2, np.int32),
                    geo=np.zeros(2, np.int32))
        with pytest.raises(ValueError, match="out of range"):
            svc.store.ingest(dict(cols))
        with pytest.raises(ValueError, match="out of range"):
            svc.request(dict(cols), ingest=False)
