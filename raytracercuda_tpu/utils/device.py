"""Which accelerator a measurement ran on.

Every entry point that reports a time (`chip_smoke.py`, `bench.py`,
`scripts/bench_configs.py`) names the card it ran on and refuses to run on
anything but a GPU: a number from a CPU fallback would read as a device
number.
"""

from __future__ import annotations

import subprocess


def card_line() -> str:
    """``<name>, <power limit>`` of each visible card, as ``nvidia-smi``
    reports them.  Runs in a child process that never touches JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def device_record() -> dict:
    """``{"platform", "kind", "count"}`` as JAX reports the devices."""
    import jax

    devices = jax.devices()
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind,
            "count": len(devices)}


def require_gpu() -> dict:
    """`device_record`, or SystemExit when JAX's default devices are not
    GPUs.  There is no CPU fallback."""
    rec = device_record()
    if rec["platform"] != "gpu":
        raise SystemExit(
            f"no GPU: JAX's default platform is {rec['platform']!r} "
            f"({rec['kind']}); this entry point measures the card and does "
            "not fall back to another platform")
    return rec


def peak_bytes(device) -> int | None:
    """``memory_stats()["peak_bytes_in_use"]`` of ``device`` (None where the
    platform keeps no statistics)."""
    stats = device.memory_stats()
    return None if not stats else stats.get("peak_bytes_in_use")
