"""The card a run measures: its name, count and power limit, and its
peak memory."""

from __future__ import annotations

import subprocess


def power_limit() -> str:
    """nvidia-smi's power limit of each card, or what it said instead."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return out.stdout.strip().replace("\n", "; ") or out.stderr.strip()


def describe(torch, count: int) -> dict:
    """The result's "device" entry (without the memory peak)."""
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": count}
