"""Roofline accounting: measured throughput vs gather/HBM ceilings.

The reference has no profiling subsystem (SURVEY.md §5); this program
reports the rank/occurrence inner loop against the card's peak
device-memory bandwidth (utils/devices.py). The search pipeline is
gather-bound, so the roofline is expressed two ways:

  - bytes: fused-row bytes moved per query vs peak HBM bandwidth
    (far below 1.0 for random row gathers);
  - rows:  row-gather descriptors per query vs a MEASURED gather rate
    for each table actually touched — the practical ceiling.

A hardcoded rows-per-query model once drifted from the engine it graded
(it assumed 2 single-row gathers per extension letter while the bench
ran digram + pair rows) and reported 219% of its own ceiling. So the row
schedule is derived from the ACTIVE engine configuration (ngram n, pair
rows on/off, the compaction backtrace schedule), and the per-table
gather rates must come from a calibration run in the same process on
the same tables (bench.py ``_calibrate_gather_rates``): fractions are
ceilings by construction, not by assumption. There are no default
rates.

Tables and their per-gather row bytes (nucleotide engine):

  single      dev.packed        128 B   backtrace LF walk
  pair        dev.packed_pair   256 B   one-gather single-letter step
  ngram_pair  NgramIndex.packed 512 B   one-gather n-letter step (n=2)
"""

from __future__ import annotations

from typing import Dict, Optional

from . import devices


def range_phase_rows(
    kmer_len: int,
    seed_k: int,
    *,
    ngram_n: int = 1,
    pair_rows: bool = True,
) -> Dict[str, float]:
    """Row gathers per query for the range (extension) phase, by table.

    ngram_n >= 2: floor(m/n) one-gather n-steps over the ngram pair
    table + (m mod n) single-letter steps; ngram_n == 1: m single
    steps. With pair rows each single step is ONE pair-row gather;
    without, two single-row gathers (the classic formulation). The
    classic n-gram step gathers its pair table twice (start-1 and end).
    """
    m = max(0, kmer_len - seed_k)
    rows: Dict[str, float] = {}
    if ngram_n >= 2:
        steps = m // ngram_n
        tail = m % ngram_n
        if steps:
            rows["ngram_pair"] = float(steps * (1 if pair_rows else 2))
    else:
        tail = m
    if tail:
        if pair_rows:
            rows["pair"] = float(tail)
        else:
            rows["single"] = float(2 * tail)
    return rows


def backtrace_rows_per_position(ratio: int, batch: int = 1 << 20) -> float:
    """SCHEDULED single-row gathers per initial backtrace position.

    Models search.backtrace_all's sync-free schedule: one ratio-step
    masked pass over the full batch (masked rows still gather), then
    nested 45%-sized compaction levels of ratio steps each while the
    level holds >= 4096 rows, then a masked while_loop finisher over
    the innermost level (its expected trips ~ the max residual chain
    over <4096 rows, bounded by a few ratio; counted as one more
    ratio-step term). This is the cost the schedule PAYS, not the
    useful-work floor (~(ratio-1)/2 steps per position).
    """
    if ratio <= 1:
        return 0.0
    routed, mono = backtrace_rows_split(ratio, batch=batch)
    return routed + mono


def backtrace_rows_split(
    ratio: int, batch: int = 1 << 20, routed_min_batch: Optional[int] = None
) -> tuple:
    """(routed_rows, mono_rows) per initial backtrace position.

    Same schedule walk as ``backtrace_rows_per_position`` but split by
    which passes the slab-routed gather (ops/route.py) serves: a pass
    routes when its level's row count reaches ``routed_min_batch``
    (from ``route.min_routed_batch`` on the real table). With
    routed_min_batch None everything is mono."""
    if ratio <= 1:
        return 0.0, 0.0
    routed = mono = 0.0

    def add(rows, level_rows):
        nonlocal routed, mono
        if routed_min_batch is not None and level_rows >= routed_min_batch:
            routed += rows
        else:
            mono += rows

    add(float(ratio), batch)  # first full-batch pass
    m = 0.45
    while m * batch >= 4096 and m < 1.0:
        add(ratio * m, m * batch)
        m *= 0.45
    add(ratio * m, m * batch)  # while_loop finisher over the last level
    return routed, mono


def table_row_bytes(alphabet=None, *, ngram_n: int = 2) -> Dict[str, int]:
    """Per-gather row bytes for each table of the active engine."""
    from ..models import index as index_mod
    from ..models.config import AlphabetType

    alphabet = alphabet or AlphabetType.DNA
    single = index_mod.device_row_bytes(alphabet)
    out = {"single": single, "pair": index_mod.device_pair_row_bytes(alphabet)}
    if alphabet != AlphabetType.AMINO and ngram_n >= 2:
        from ..ops import ngram as ngram_ops

        out["ngram_pair"] = ngram_ops._geometry_pair(ngram_n)[4]
    return out


def report(
    queries_per_sec: float,
    *,
    kmer_len: int,
    seed_k: int,
    ratio: int,
    ngram_n: int = 1,
    pair_rows: bool = True,
    locate_positions_per_query: float = 0.0,
    row_bytes: Optional[Dict[str, int]] = None,
    rates: Optional[Dict[str, float]] = None,
    batch: int = 1 << 20,
    chip: Optional[devices.DeviceSpec] = None,
    bt_routed_min_batch: Optional[int] = None,
) -> dict:
    """Roofline summary for a measured throughput on the active engine.

    ``locate_positions_per_query``: backtrace positions ENTERING the LF
    walk per query — 0 for count, 1 for first-hit locate, and
    capacity/num_queries for full-hit-list locate (the schedule walks
    the padded capacity batch, so honesty requires the padded figure).
    ``rates``: per-table gather rates (rows/s) measured in the same
    process (bench.py's calibration stage); required. ``chip``: the
    device-facts entry whose peak bandwidth grades the bytes (default:
    the active device's; an unknown kind raises).
    """
    if not rates:
        raise ValueError(
            "roofline.report needs gather rates measured in this process "
            "(bench.py _calibrate_gather_rates); there are no defaults"
        )
    chip = chip or devices.detect()
    row_bytes = row_bytes or table_row_bytes(ngram_n=ngram_n)

    range_rows = range_phase_rows(
        kmer_len, seed_k, ngram_n=ngram_n, pair_rows=pair_rows
    )
    # backtrace rows split by which schedule passes the slab-routed
    # gather serves (its bare rate differs from the mono gather's):
    # the ceiling uses the ROUTED calibrated rate for those
    # rows so the fraction stays an honest <= 1.0 share of what the
    # schedule's gathers could at best sustain
    use_routed = (
        "single_routed" in rates and bt_routed_min_batch is not None
    )
    bt_routed_rows, bt_mono_rows = backtrace_rows_split(
        ratio, batch=batch,
        routed_min_batch=bt_routed_min_batch if use_routed else None,
    )
    bt_routed_rows *= locate_positions_per_query
    bt_mono_rows *= locate_positions_per_query
    bt_rows = bt_routed_rows + bt_mono_rows

    def phase_summary(rows_by_table: Dict[str, float]) -> dict:
        rows = sum(rows_by_table.values())
        bytes_q = sum(
            n * row_bytes[t] for t, n in rows_by_table.items()
        )
        secs = sum(n / rates[t] for t, n in rows_by_table.items())
        return {
            "rows_per_query": round(rows, 3),
            "bytes_per_query": round(bytes_q, 1),
            "gather_seconds_per_query": secs,
        }

    phases = {"range": phase_summary(range_rows)}
    if bt_rows:
        bt_secs = bt_mono_rows / rates["single"]
        if bt_routed_rows:
            bt_secs += bt_routed_rows / rates["single_routed"]
        phases["backtrace"] = {
            "rows_per_query": round(bt_rows, 3),
            # sampled-SA resolve: one 4 B element gather per position
            # (bytes only; element gathers are not row-rate-bound)
            "bytes_per_query": round(
                bt_rows * row_bytes["single"]
                + 4.0 * locate_positions_per_query,
                1,
            ),
            "gather_seconds_per_query": bt_secs,
        }
        if bt_routed_rows:
            phases["backtrace"]["routed_rows_per_query"] = round(
                bt_routed_rows, 3
            )

    total_secs = sum(p["gather_seconds_per_query"] for p in phases.values())
    total_bytes = sum(p["bytes_per_query"] for p in phases.values())
    total_rows = sum(p["rows_per_query"] for p in phases.values())
    if total_secs == 0:
        # kmer_len == seed_k count: the seed table answers everything
        return {
            "chip": chip.name,
            "rows_per_query": 0.0,
            "bytes_per_query": 0.0,
            "gather_ceiling_qps": None,
            "hbm_speed_of_light_qps": None,
            "fraction_of_gather_ceiling": None,
            "fraction_of_hbm_sol": None,
        }
    ceiling_qps = 1.0 / total_secs
    sol_qps = chip.hbm_bytes_per_sec / total_bytes
    out = {
        "chip": chip.name,
        "rates_rows_per_sec": {
            t: round(r)
            for t, r in rates.items()
            if t in row_bytes or t.endswith("_routed")
        },
        "rows_per_query": round(total_rows, 2),
        "bytes_per_query": round(total_bytes, 1),
        "gather_ceiling_qps": round(ceiling_qps),
        "hbm_speed_of_light_qps": round(sol_qps),
        "fraction_of_gather_ceiling": round(queries_per_sec / ceiling_qps, 4),
        "fraction_of_hbm_sol": round(queries_per_sec / sol_qps, 4),
        "phases": {
            name: {
                **{
                    k: v
                    for k, v in p.items()
                    if k != "gather_seconds_per_query"
                },
                "share_of_gather_time": round(
                    p["gather_seconds_per_query"] / total_secs, 3
                ),
            }
            for name, p in phases.items()
        },
    }
    return out
