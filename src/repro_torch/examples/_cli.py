"""The examples' one command-line option."""

from __future__ import annotations

import argparse


def device_arg(doc: str, argv=None) -> str:
    """``--device`` (default ``cuda``; ``cpu`` runs the plain versions)."""
    ap = argparse.ArgumentParser(description=doc.strip().splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return ap.parse_args(argv).device
