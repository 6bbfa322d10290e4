"""What a measurement ran on: the JAX device and the card's name and
power limit, so that every reported number carries its hardware."""

from __future__ import annotations

import subprocess
from typing import List

import jax


def jax_device() -> dict:
    """Platform, device kind and device count as JAX reports them."""
    devs = jax.devices()
    return {"platform": devs[0].platform, "kind": devs[0].device_kind,
            "count": len(devs)}


def card_lines() -> List[str]:
    """``nvidia-smi --query-gpu=name,power.limit`` lines, one per card
    (empty where there is no NVIDIA driver)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    return [line.strip() for line in out.splitlines() if line.strip()]
