"""Roofline accounting sanity tests (engine-parameterized model)."""

import pytest

from avxwindowfmindex_tpu.utils import devices, roofline

H100 = devices.lookup("NVIDIA H100 80GB HBM3")
RATES = {"single": 250e6, "pair": 120e6, "ngram_pair": 60e6}


def test_range_phase_rows_digram_pair():
    # 25-mer, k=12: 13 extension letters = 6 digram gathers + 1 single
    rows = roofline.range_phase_rows(25, 12, ngram_n=2, pair_rows=True)
    assert rows == {"ngram_pair": 6.0, "pair": 1.0}
    # k=13 aligns parity with n=2: the tail disappears
    rows13 = roofline.range_phase_rows(25, 13, ngram_n=2, pair_rows=True)
    assert rows13 == {"ngram_pair": 6.0}


def test_range_phase_rows_single_step():
    rows = roofline.range_phase_rows(25, 12, ngram_n=1, pair_rows=True)
    assert rows == {"pair": 13.0}
    classic = roofline.range_phase_rows(25, 12, ngram_n=1, pair_rows=False)
    assert classic == {"single": 26.0}
    # classic n-gram step gathers its pair table twice per step
    ng_classic = roofline.range_phase_rows(25, 12, ngram_n=2, pair_rows=False)
    assert ng_classic == {"ngram_pair": 12.0, "single": 2.0}


def test_backtrace_schedule_rows():
    # ratio 8 at 1M batch: 8-step first pass + telescoping 45% levels
    got = roofline.backtrace_rows_per_position(8, batch=1 << 20)
    assert 8.0 < got < 8.0 / (1 - 0.45) + 8.0 * 0.1
    assert roofline.backtrace_rows_per_position(1) == 0.0
    # small batches skip the compaction levels (only first pass + net)
    small = roofline.backtrace_rows_per_position(8, batch=1024)
    assert small < got


def test_report_fractions_are_ceilings():
    """A throughput at the calibrated gather rate itself must land at
    fraction <= 1; the HBM byte fraction is far below 1."""
    rates = {"single": 250e6, "pair": 120e6, "ngram_pair": 60e6}
    row_bytes = {"single": 128, "pair": 256, "ngram_pair": 384}
    rep = roofline.report(
        3.2e6,
        kmer_len=25,
        seed_k=12,
        ratio=8,
        ngram_n=2,
        pair_rows=True,
        locate_positions_per_query=1.0,
        row_bytes=row_bytes,
        rates=rates,
        chip=H100,
    )
    assert rep["chip"] == H100.name
    assert rep["fraction_of_gather_ceiling"] <= 1.0
    assert 0 < rep["fraction_of_hbm_sol"] < 0.2
    assert set(rep["phases"]) == {"range", "backtrace"}
    shares = [p["share_of_gather_time"] for p in rep["phases"].values()]
    assert abs(sum(shares) - 1.0) < 0.01
    # a throughput EQUAL to the model ceiling reports exactly 1.0
    ceiling = rep["gather_ceiling_qps"]
    rep2 = roofline.report(
        ceiling, kmer_len=25, seed_k=12, ratio=8, ngram_n=2,
        pair_rows=True, locate_positions_per_query=1.0,
        row_bytes=row_bytes, rates=rates, chip=H100,
    )
    assert abs(rep2["fraction_of_gather_ceiling"] - 1.0) < 0.01


def test_report_self_consistency_count_vs_locate():
    """Locate's ceiling must be strictly below count's (extra backtrace
    rows), and rows/bytes must grow with the locate phase."""
    kw = dict(
        kmer_len=25, seed_k=12, ratio=8, ngram_n=2, pair_rows=True,
        chip=H100,
        rates={"single": 250e6, "pair": 120e6, "ngram_pair": 60e6},
        row_bytes={"single": 128, "pair": 256, "ngram_pair": 384},
    )
    count = roofline.report(6e6, locate_positions_per_query=0.0, **kw)
    locate = roofline.report(3e6, locate_positions_per_query=1.0, **kw)
    assert locate["gather_ceiling_qps"] < count["gather_ceiling_qps"]
    assert locate["rows_per_query"] > count["rows_per_query"]
    assert locate["bytes_per_query"] > count["bytes_per_query"]
    assert "backtrace" not in count["phases"]


def test_report_zero_gather_workload():
    """kmer_len == seed_k in count mode: zero gathers per query must
    report an unbounded roofline, not divide by zero."""
    out = roofline.report(
        1e6, kmer_len=12, seed_k=12, ratio=8, ngram_n=1,
        chip=H100, rates=RATES,
        row_bytes={"single": 128, "pair": 256},
    )
    assert out["rows_per_query"] == 0.0
    assert out["hbm_speed_of_light_qps"] is None
    # locate still walks the backtrace schedule per position
    out2 = roofline.report(
        1e6, kmer_len=12, seed_k=12, ratio=8, ngram_n=1,
        locate_positions_per_query=1.0, chip=H100, rates=RATES,
        row_bytes={"single": 128, "pair": 256},
    )
    assert out2["rows_per_query"] > 8.0


@pytest.mark.parametrize("rates", [None, {}], ids=["none", "empty"])
def test_report_without_rates_raises(rates):
    """There are no default gather rates: a report needs rates measured
    in the same process."""
    with pytest.raises(ValueError, match="measured"):
        roofline.report(
            1e6, kmer_len=25, seed_k=12, ratio=8, ngram_n=2, chip=H100,
            rates=rates,
            row_bytes={"single": 128, "pair": 256, "ngram_pair": 384},
        )


def test_report_on_cpu_device_raises():
    """Without an explicit chip the report grades against the active
    device's peak, and the CPU backend has none."""
    with pytest.raises(devices.UnknownDeviceError):
        roofline.report(
            1e6, kmer_len=25, seed_k=12, ratio=8, ngram_n=2, rates=RATES,
            row_bytes={"single": 128, "pair": 256, "ngram_pair": 384},
        )


def test_hbm_speed_of_light_uses_device_peak():
    rep = roofline.report(
        1e6, kmer_len=25, seed_k=12, ratio=8, ngram_n=1, pair_rows=True,
        chip=H100, rates=RATES, row_bytes={"single": 128, "pair": 256},
    )
    # 13 one-gather pair steps of 256 B each per count query
    assert rep["bytes_per_query"] == 13 * 256
    assert rep["hbm_speed_of_light_qps"] == round(3.35e12 / (13 * 256))


def test_table_row_bytes_matches_device_layout():
    from avxwindowfmindex_tpu.models.config import AlphabetType

    rb = roofline.table_row_bytes(AlphabetType.DNA, ngram_n=2)
    assert rb == {"single": 128, "pair": 256, "ngram_pair": 384}
    aa = roofline.table_row_bytes(AlphabetType.AMINO, ngram_n=1)
    assert aa["single"] == 256 and aa["pair"] == 512
