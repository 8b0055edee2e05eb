"""The device-facts table (utils/devices.py): known kinds resolve, every
other kind raises, and the allocator budget comes from memory_stats."""

import pytest

from avxwindowfmindex_tpu.utils import devices


@pytest.mark.parametrize(
    "kind",
    ["NVIDIA H100 80GB HBM3", "nvidia h100 80gb hbm3",
     " NVIDIA H100 80GB HBM3\n"],
)
def test_h100_kind_strings_resolve(kind):
    spec = devices.lookup(kind)
    assert spec.hbm_bytes == 80_000_000_000
    assert spec.hbm_bytes_per_sec == 3.35e12
    assert "data sheet" in spec.source


@pytest.mark.parametrize(
    "kind",
    ["cpu", "AMD Instinct MI300X", "NVIDIA A100-SXM4-80GB", "H100", ""],
)
def test_unknown_kinds_raise(kind):
    with pytest.raises(devices.UnknownDeviceError):
        devices.lookup(kind)


def test_detect_on_the_cpu_backend_raises():
    with pytest.raises(devices.UnknownDeviceError, match="cpu"):
        devices.detect()


class _Device:
    device_kind = "NVIDIA H100 80GB HBM3"

    def __init__(self, stats):
        self._stats = stats

    def memory_stats(self):
        return self._stats


def test_allocator_limit_is_bytes_limit():
    dev = _Device({"bytes_limit": 63_000_000_000, "bytes_in_use": 5})
    assert devices.allocator_limit_bytes(dev) == 63_000_000_000


@pytest.mark.parametrize("stats", [None, {"bytes_in_use": 5}],
                         ids=["no-stats", "no-limit"])
def test_allocator_limit_without_stats_raises(stats):
    with pytest.raises(devices.UnknownDeviceError, match="bytes_limit"):
        devices.allocator_limit_bytes(_Device(stats))
