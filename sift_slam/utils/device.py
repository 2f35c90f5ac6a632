"""The accelerator a measurement or check runs on."""

from __future__ import annotations

import subprocess

import jax


def require_gpu() -> jax.Device:
    """JAX's first device, which must be a GPU.

    A measurement or check that finds no card fails (``SystemExit`` with
    a non-zero code); it never carries on on the CPU.
    """
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"needs a GPU; JAX's first device is {dev.platform} "
            f"({dev.device_kind})"
        )
    return dev


def gpu_name_and_power_limit() -> str:
    """What ``nvidia-smi --query-gpu=name,power.limit`` prints, one line
    per card. A card may be set below its maximum power and then runs
    slower under load, so every timing is reported beside this."""
    return subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        check=True,
        capture_output=True,
        text=True,
        timeout=60,
    ).stdout.strip()
