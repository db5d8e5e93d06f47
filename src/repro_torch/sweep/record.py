"""``BENCH_*.json`` emission: one schema, every artifact, every commit.

The port's copy of the JAX package's ``sweep/record.py`` (same
``SCHEMA_VERSION``, same keys), which the port's sweep and benchmark
scripts write through.  Every payload and every row carries
``schema_version`` and ``git_sha`` (``GITHUB_SHA`` in CI, ``git
rev-parse`` locally, ``"unknown"`` outside a checkout).

``payload["backend"]`` is the torch device type the run used (``"cuda"``
or ``"cpu"``); on the card, ``payload["nvidia_smi"]`` holds the card's
name and power limit as ``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader`` prints them.
"""
from __future__ import annotations

import json
import os
import platform
import subprocess
import time

import torch

__all__ = ["SCHEMA_VERSION", "git_sha", "make_payload", "nvidia_smi", "stamp_rows",
           "write_json"]

SCHEMA_VERSION = 1


def git_sha() -> str:
    """Current commit SHA: CI env var first, then git, else "unknown"."""
    sha = os.environ.get("GITHUB_SHA")
    if sha:
        return sha
    try:
        return subprocess.run(
            ["git", "rev-parse", "HEAD"], capture_output=True, text=True,
            check=True, timeout=10,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "unknown"


def nvidia_smi() -> str:
    """The first card's name and power limit, as nvidia-smi prints them
    (``"nvidia-smi failed"`` when it cannot be run)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi failed"
    return out[0] if out else "nvidia-smi failed"


def stamp_rows(rows: list[dict], sha: str | None = None) -> list[dict]:
    """Stamp ``schema_version`` + ``git_sha`` into every row, in place."""
    sha = sha or git_sha()
    for r in rows:
        r.setdefault("schema_version", SCHEMA_VERSION)
        r.setdefault("git_sha", sha)
    return rows


def make_payload(suite: str, rows: list[dict], *, quick: bool | None = None,
                 extra: dict | None = None, device: str | torch.device) -> dict:
    """The common artifact envelope around stamped rows; ``device`` is the
    device the rows were computed on."""
    device = torch.device(device).type
    payload = {
        "suite": suite,
        "schema_version": SCHEMA_VERSION,
        "git_sha": git_sha(),
        "unix_time": time.time(),
        "backend": device,
        "machine": platform.machine(),
    }
    if quick is not None:
        payload["quick"] = quick
    if device == "cuda":
        payload["nvidia_smi"] = nvidia_smi()
    if extra:
        payload.update(extra)
    payload["rows"] = stamp_rows(rows, sha=payload["git_sha"])
    return payload


def write_json(path: str, payload: dict) -> None:
    with open(path, "w") as f:
        json.dump(payload, f, indent=2)
    print(f"wrote {path}")
