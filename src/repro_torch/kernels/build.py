"""Build and load the hand-written CUDA kernels (``kernels/csrc/*.cu``).

Each source has a plain C interface and is compiled by ``nvcc`` into its
own shared library, loaded with ``ctypes``.  Builds run at first use into
``build/repro_torch/`` at the repository root (listed in ``.gitignore``),
from the sources in the checkout alone; the file name carries a hash of
the source and flags, so an edited kernel is never served from a stale
library.  :func:`build` starts one ``nvcc`` per missing library, all at
once, and waits for all of them.

Flags: ``sm_90a`` (Hopper), C++17, ``-O3`` and ``-fmad=false`` — the
ingest kernel's float sums must round exactly like the plain version's
separate multiply and add, so no fused multiply-add may form (the same
holds for the window-stats kernel's sumsq lane).  A kernel that wants
fused multiply-adds spells them with ``fmaf`` (the WKV6 scan and flash
attention do).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

__all__ = ["SOURCES", "build", "library", "build_dir"]

CSRC = Path(__file__).resolve().parent / "csrc"

# kernel name -> source file under csrc/
SOURCES: Dict[str, str] = {
    "fused_ingest": "fused_ingest.cu",
    "route_rank": "route_rank.cu",
    "fold_levels": "fold_levels.cu",
    "window_stats": "window_stats.cu",
    "signature_embed": "signature_embed.cu",
    "wkv6": "wkv6.cu",
    "flash_attention": "flash_attention.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
# kernel name -> nvcc's output (ptxas register / shared-memory report)
BUILD_LOGS: Dict[str, str] = {}


def build_dir() -> Path:
    """``<repo>/build/repro_torch`` (src/repro_torch/kernels -> repo)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
            "the CUDA kernels can only be built on a machine with the "
            "CUDA toolkit"
        )
    return str(path)


def _target(name: str) -> Path:
    src = CSRC / SOURCES[name]
    digest = hashlib.sha1(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:12]
    return build_dir() / f"{name}-{digest}.so"


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Path]:
    """Compile every missing library among ``names`` (default: all), one
    ``nvcc`` process per source, started together.  Returns name -> path.
    Raises with nvcc's output if any build fails."""
    names = list(SOURCES if names is None else names)
    out = {n: _target(n) for n in names}
    todo = [n for n in names if not out[n].exists()]
    if not todo:
        return out
    build_dir().mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for n in todo:
        tmp = out[n].with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[n])]
        procs[n] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
        )
    failed = []
    for n, (p, tmp) in procs.items():
        log, _ = p.communicate()
        BUILD_LOGS[n] = log
        if p.returncode != 0:
            failed.append(f"--- {n} (nvcc exit {p.returncode}) ---\n{log}")
            continue
        os.replace(tmp, out[n])
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return out


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build([name])[name]
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib
