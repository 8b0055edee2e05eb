"""Device-memory capacity planner (utils/capacity.py).

Reference sizing guidance anchor: /root/reference/README.md:188-213
(seed-table memory vs k, SA ratio trade). The planner budgets from the
allocator limit the device reports (memory_stats()["bytes_limit"]) and
raises for a device kind without an entry in utils/devices.py.
"""

import pytest

from avxwindowfmindex_tpu.models.config import AlphabetType
from avxwindowfmindex_tpu.utils import capacity as cap
from avxwindowfmindex_tpu.utils import devices

H100_KIND = "NVIDIA H100 80GB HBM3"
BUDGET_60GB = 60_000_000_000  # a little under JAX's default 75% of 80 GB
BUDGET_95GB = 95_000_000_000
BUDGET_16GB = 16_000_000_000


class _FakeDevice:
    def __init__(self, kind, bytes_limit=BUDGET_60GB):
        self.device_kind = kind
        self._limit = bytes_limit

    def memory_stats(self):
        return {"bytes_limit": self._limit, "bytes_in_use": 0}


def test_detect_hbm_device_kind_strings(monkeypatch):
    """Only kinds in the device-facts table get a budget, and the budget
    is the allocator's limit, not the data sheet's size. Unknown kinds
    raise instead of being budgeted as some default card."""
    import jax

    cases = {
        H100_KIND: 60_000_000_000,
        "nvidia h100 80gb hbm3": 59_000_000_000,
        "AMD Instinct MI300X": None,
        "NVIDIA A100-SXM4-80GB": None,
        "mystery accelerator": None,
    }
    for kind, limit in cases.items():
        fake = _FakeDevice(kind, limit or 1)
        monkeypatch.setattr(jax, "devices", lambda f=fake: [f])
        if limit is None:
            with pytest.raises(devices.UnknownDeviceError):
                cap.detect_budget_bytes()
        else:
            got, note = cap.detect_budget_bytes()
            assert got == limit, (kind, got, note)


def test_planner_budgets_from_bytes_limit(monkeypatch):
    import jax

    fake = _FakeDevice(H100_KIND, bytes_limit=7_000_000_000)
    monkeypatch.setattr(jax, "devices", lambda: [fake])
    plan = cap.plan_capacity(3_100_000_000, batch=1 << 20)
    assert plan.hbm_bytes == 7_000_000_000
    assert plan.budget == int(0.9 * 7_000_000_000) - cap.workspace_bytes(
        1 << 20, 25
    )
    assert plan.per_chip_bytes <= plan.budget
    assert any("allocator limit" in n for n in plan.notes)


def test_planner_raises_on_cpu_device():
    with pytest.raises(devices.UnknownDeviceError):
        cap.plan_capacity(1_000_000)


@pytest.mark.parametrize("num_bases", [248_956_422, 3_100_000_000],
                         ids=["chr1", "hg38"])
def test_plan_60gb_budget(num_bases):
    """Under an H100 process's ~60 GB budget the richest configuration
    fits both a chromosome and the whole genome: seed k 14, dense SA at
    ratio 4, the digram table and pair rows, on one card."""
    plan = cap.plan_capacity(num_bases, hbm_bytes=BUDGET_60GB,
                             batch=1 << 22)
    assert plan.engine == "replicated" and not plan.wide
    assert plan.seed_k == 14
    assert plan.device_sa_ratio == 4
    assert plan.ngram and plan.pair_rows
    assert plan.per_chip_bytes <= plan.budget


def test_component_bytes_exact_dna():
    comp = cap.component_bytes(
        64_000_000, AlphabetType.DNA, seed_k=14, sa_ratio=8,
        device_sa_ratio=4, ngram=True,
    )
    nb = -(-64_000_001 // 256)
    assert comp["packed"] == nb * 128
    assert comp["packed_pair"] == nb * 256
    assert comp["ngram"] == nb * 384
    assert comp["seed_table"] == 4**14 * 8
    assert comp["sampled_sa"] == -(-64_000_001 // 4) * 4


def test_degradation_ladder_order():
    """Shrinking HBM drops k first, then dense SA, then digram."""
    picks = []
    for hbm in (16e9, 13e9, 8e9, 6.2e9):
        p = cap.plan_capacity(3_100_000_000, hbm_bytes=int(hbm),
                              batch=1 << 20)
        picks.append((p.seed_k, p.device_sa_ratio, p.ngram))
    ks = [p[0] for p in picks]
    assert ks[0] >= ks[-1]
    assert picks[0][1] == 4 and picks[0][2]
    # at 6.2 GB the dense SA and/or digram must be gone
    assert picks[-1][1] is None or not picks[-1][2]


def test_wide_plan():
    plan = cap.plan_capacity(5_000_000_000, hbm_bytes=BUDGET_95GB,
                             batch=1 << 20)
    assert plan.wide and not plan.ngram
    assert any("2^32" in n for n in plan.notes)
    # wide dense SA is a real option (models/index.py wide densify +
    # build-time device_sa_ratio): a 95 GB budget holds 5G bases with
    # the dense row — 8 B/sample at ratio 4
    assert plan.device_sa_ratio == 4
    assert plan.components["sampled_sa"] == -(-5_000_000_001 // 4) * 8


def test_wide_plan_dense_sa_int32_guard():
    # past 2^31 dense samples the option cannot exist (int32 gather);
    # the planner must drop it rather than emit an unusable plan
    corpus = 9_000_000_000  # bwt/2 > 2^31
    plan = cap.plan_capacity(
        corpus, hbm_bytes=2 * BUDGET_95GB, batch=1 << 20, device_sa_ratio=2
    )
    assert plan.wide and plan.device_sa_ratio is None
    assert any("int32 sample-gather" in n for n in plan.notes)


def test_range_sharded_when_exceeding_chip():
    corpus = 12_000_000_000  # ~15 GB of packed rows alone at wide
    with pytest.raises(ValueError, match="range-sharded|mesh"):
        cap.plan_capacity(corpus, hbm_bytes=int(6e9), n_devices=1,
                          batch=1 << 20)
    plan = cap.plan_capacity(corpus, hbm_bytes=int(6e9), n_devices=8,
                             batch=1 << 20)
    assert plan.engine == "range_sharded"
    assert plan.per_chip_bytes <= plan.budget
    assert plan.per_chip_bytes < plan.index_bytes


def test_amino_plan():
    plan = cap.plan_capacity(16_000_000, AlphabetType.AMINO,
                             hbm_bytes=BUDGET_16GB, batch=1 << 20,
                             kmer_len=20)
    assert plan.engine == "replicated"
    assert plan.seed_k == 6  # amino cap: 20^6 * 8 = 512 MB
    assert not plan.ngram  # n-gram engine is nucleotide-only
    assert plan.device_sa_ratio == 4


def test_seed_k_never_exceeds_kmer_len():
    plan = cap.plan_capacity(64_000_000, hbm_bytes=BUDGET_16GB, batch=1 << 20,
                             kmer_len=12)
    assert plan.seed_k <= 12


def test_index_configuration_roundtrip():
    plan = cap.plan_capacity(1_000_000, hbm_bytes=BUDGET_16GB, batch=1 << 16)
    cfg = plan.index_configuration()
    assert cfg.kmer_length_in_seed_table == plan.seed_k
    assert cfg.suffix_array_compression_ratio == plan.sa_ratio
    assert "replicated" in plan.summary()
