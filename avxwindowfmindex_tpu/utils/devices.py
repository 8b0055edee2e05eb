"""Facts about the accelerators this program runs on, keyed by
``jax.Device.device_kind``.

One table serves the capacity planner (device memory) and the roofline
(peak device-memory bandwidth). A kind that is not in the table raises:
a default would size an index, or grade a kernel, against a machine the
program is not running on. The CPU backend is not in the table either;
it has no device metric to report.
"""

from __future__ import annotations

import dataclasses
import subprocess
from typing import Dict, Optional


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    name: str
    hbm_bytes: int  # device memory on the data sheet
    hbm_bytes_per_sec: float  # peak device-memory bandwidth
    source: str


DEVICES: Dict[str, DeviceSpec] = {
    "nvidia h100 80gb hbm3": DeviceSpec(
        name="NVIDIA H100 SXM5 80GB",
        hbm_bytes=80_000_000_000,
        hbm_bytes_per_sec=3.35e12,
        source="NVIDIA H100 Tensor Core GPU data sheet, SXM form factor",
    ),
}


class UnknownDeviceError(LookupError):
    """The device kind has no entry in :data:`DEVICES`."""


def lookup(device_kind: str) -> DeviceSpec:
    """The table entry for a ``device_kind`` string (case-insensitive)."""
    spec = DEVICES.get(device_kind.strip().lower())
    if spec is None:
        raise UnknownDeviceError(
            f"no device facts for device kind {device_kind!r}; known kinds: "
            f"{sorted(DEVICES)} (add an entry with its data-sheet source to "
            "utils/devices.py)"
        )
    return spec


def detect(device=None) -> DeviceSpec:
    """The table entry for ``device`` (default: the first JAX device)."""
    if device is None:
        import jax

        device = jax.devices()[0]
    return lookup(device.device_kind)


def nvidia_smi_name_and_power_limit() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` output, one line per
    card. A card set below its maximum power limit runs slower under
    load, so every measurement is reported beside this. The child
    process reads the driver only; it does not open a card for JAX."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()


def allocator_limit_bytes(device=None) -> int:
    """Device bytes the JAX allocator will hand out on ``device``.

    This is ``memory_stats()["bytes_limit"]``: with JAX's default
    preallocation it is three quarters of the card's memory, or the
    share ``XLA_PYTHON_CLIENT_MEM_FRACTION`` sets. The device must be in :data:`DEVICES`.
    """
    if device is None:
        import jax

        device = jax.devices()[0]
    lookup(device.device_kind)
    stats: Optional[dict] = device.memory_stats()
    if not stats or "bytes_limit" not in stats:
        raise UnknownDeviceError(
            f"device {device!r} reports no allocator limit (memory_stats()"
            " has no bytes_limit)"
        )
    return int(stats["bytes_limit"])
