"""Manifest checkpoints: save / restore, atomic and asynchronous.

The reference package's ``repro.ckpt.manifest`` with its on-disk
contract, so either package reads the other's checkpoints::

    ckpt_dir/step_000000123/
      manifest.json        # step, leaves [{path, file, shape, dtype}], treedef null
      leaf_000000.npy ...  # one file per leaf
      COMMITTED            # written last; restore ignores dirs without it

A tree is a nested mapping of tensors (or numpy arrays, or scalars).  Its
leaves are flattened in JAX's order -- dict keys sorted at every level,
paths joined with "/" -- so the same tree gives the same leaf list in
both packages.  A bfloat16 leaf is stored as its uint16 bits with
``"bfloat16"`` in the manifest.

* **Atomicity** -- leaves and manifest are written into ``.tmp-step_X``,
  the directory is renamed into place, then ``COMMITTED`` is written; a
  crash mid-save never corrupts the latest checkpoint.
* **Async** -- ``save(..., blocking=False)`` copies every leaf to host
  memory at once (so later in-place updates of the model cannot reach the
  snapshot) and writes on a background thread; ``wait()`` joins.
* **keep** -- after each save only the newest ``keep`` committed steps
  stay.

The reference's ``shardings`` (device_put to a new mesh on restore) is
``device`` here: one card has no mesh to reshard onto.
"""

from __future__ import annotations

import concurrent.futures as cf
import json
import os
import pathlib
import shutil
import threading
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["CheckpointManager", "flatten_tree", "unflatten_like"]


def flatten_tree(tree: Any, prefix: Tuple[str, ...] = ()
                 ) -> List[Tuple[str, Any]]:
    """(path, leaf) of every leaf, JAX's order: keys sorted at each level."""
    if isinstance(tree, Mapping):
        out = []
        for k in sorted(tree, key=str):
            out += flatten_tree(tree[k], prefix + (str(k),))
        return out
    return [("/".join(prefix), tree)]


def unflatten_like(like: Any, leaves: List[Any]) -> Any:
    """``leaves`` (in :func:`flatten_tree` order) put into ``like``'s
    structure."""
    it = iter(leaves)

    def build(node):
        if isinstance(node, Mapping):
            return {k: build(node[k]) for k in sorted(node, key=str)}
        return next(it)

    return build(like)


def _to_host(leaf) -> Tuple[np.ndarray, str]:
    """A host copy of ``leaf`` as numpy, and its dtype's name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            bits = t.view(torch.int16).cpu().numpy().view(np.uint16)
            return np.array(bits, copy=True), "bfloat16"
        a = np.array(t.cpu().numpy(), copy=True)
        return a, str(a.dtype)
    a = np.array(leaf, copy=True)
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype: str) -> torch.Tensor:
    if dtype == "bfloat16":
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(np.array(bits, copy=True)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = pathlib.Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep
        self._pool = cf.ThreadPoolExecutor(max_workers=2)
        self._pending: List[cf.Future] = []
        self._lock = threading.Lock()

    # -- save ----------------------------------------------------------------

    def save(self, step: int, tree: Any, blocking: bool = True) -> None:
        """Snapshot ``tree`` to host memory now, then write it (on a
        background thread unless ``blocking``)."""
        flat = flatten_tree(tree)
        host = [_to_host(leaf) for _, leaf in flat]
        manifest = {
            "step": step,
            "treedef": None,
            "leaves": [
                {"path": p, "file": f"leaf_{i:06d}.npy",
                 "shape": list(a.shape), "dtype": dt}
                for i, ((p, _), (a, dt)) in enumerate(zip(flat, host))
            ],
        }

        def write():
            tmp = self.dir / f".tmp-step_{step:09d}"
            final = self.dir / f"step_{step:09d}"
            if tmp.exists():
                shutil.rmtree(tmp)
            tmp.mkdir(parents=True)
            for i, (a, _) in enumerate(host):
                np.save(tmp / f"leaf_{i:06d}.npy", a)
            (tmp / "manifest.json").write_text(json.dumps(manifest, indent=2))
            if final.exists():
                shutil.rmtree(final)
            os.replace(tmp, final)
            (final / "COMMITTED").write_text("ok")
            self._gc()

        if blocking:
            write()
        else:
            with self._lock:
                self._pending.append(self._pool.submit(write))

    def wait(self) -> None:
        """Join every pending background save (raising its error)."""
        with self._lock:
            pending, self._pending = self._pending, []
        for f in pending:
            f.result()

    # -- restore -------------------------------------------------------------

    def latest_step(self) -> Optional[int]:
        steps = [int(p.name.split("_")[1]) for p in self.dir.glob("step_*")
                 if (p / "COMMITTED").exists()]
        return max(steps) if steps else None

    def manifest(self, step: int) -> Dict:
        return json.loads(
            (self.dir / f"step_{step:09d}" / "manifest.json").read_text())

    def restore(self, step: Optional[int] = None, *, like: Any,
                device=None) -> Any:
        """Load a committed checkpoint (default: the latest) into ``like``'s
        structure, each leaf a tensor in its saved dtype -- on ``device``
        when given, else in host memory.  The leaf paths must be
        ``like``'s."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {self.dir}")
        d = self.dir / f"step_{step:09d}"
        manifest = self.manifest(step)
        want = [p for p, _ in flatten_tree(like)]
        have = [leaf["path"] for leaf in manifest["leaves"]]
        if want != have:
            raise ValueError(
                f"checkpoint step {step}: its leaves {have[:4]}... are not "
                f"like's {want[:4]}... ({len(have)} vs {len(want)})")
        dev = None if device is None else resolve_device(device)
        leaves = []
        for leaf in manifest["leaves"]:
            t = _from_host(np.load(d / leaf["file"]), leaf["dtype"])
            leaves.append(t if dev is None else t.to(dev))
        return unflatten_like(like, leaves)

    # -- gc ------------------------------------------------------------------

    def _gc(self) -> None:
        steps = sorted(
            p for p in self.dir.glob("step_*") if (p / "COMMITTED").exists()
        )
        for p in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(p, ignore_errors=True)
