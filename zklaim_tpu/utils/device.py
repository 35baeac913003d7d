"""The device a measurement runs on.

Measurement entry points (chip_smoke.py, bench.py, tools/) run only on a
GPU and name it in what they print; none falls back to the CPU."""

from __future__ import annotations

import subprocess
import sys

import jax


def device_info() -> dict:
    dev = jax.devices()[0]
    return {"platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices())}


def require_gpu(prog: str) -> dict:
    """device_info() of the GPU JAX runs on; exits with code 2 and a
    message when JAX found no GPU."""
    info = device_info()
    if info["platform"] != "gpu":
        print(f"{prog}: needs a GPU, JAX found {info['platform']!r}",
              file=sys.stderr)
        raise SystemExit(2)
    return info


def gpu_name_and_power() -> str:
    """`nvidia-smi` name and power limit of the cards, read by a child
    process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()
