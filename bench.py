"""Headline benchmark: batched k-mer search throughput on one GPU.

Mirrors the reference's measurement harness (tuning/search/timeSearch.c:
sample valid kmers from the source sequence, time
awFmParallelSearchLocate/Count over repeated runs) on the flagship
BASELINE.json config: 25-mer nucleotide count+locate over a random
corpus, SA ratio 8, seed table k sized to the card by the capacity
planner (utils/capacity.py; the reference's own README treats k as the
primary tuning knob).

Timing hygiene: every stage discards one timed warm-up run after
compilation, then reports the MEDIAN of AWFM_BENCH_RUNS runs with the
per-run times in the meta line, so a single host hiccup cannot poison
the headline.

Prints a meta line, then ONE JSON headline line:
  {"metric": ..., "value": N, "unit": "queries/s", "vs_baseline": N}

The headline is full-hit-list locate (every position of every range
resolved, AwFmSearch.c:161-246 / AwFmParallelSearch.c:315-365), the
reference's real locate workload. vs_baseline denominator: the
reference's 64-thread AVX2 CPU throughput for this workload. The repo
publishes no numbers (BASELINE.md), so we use a cost-model estimate
pinned here for cross-round comparability: each seeded 25-mer does 13
extension steps x 2 block fetches; a 2-socket 64-thread x86 server
sustains ~150M random cache-line fetches/s from DRAM, giving ~2.5M
locate-queries/s (count ~3.5M/s). These match the rank-step cost model
in BASELINE.md and err generous toward the CPU.

Runs as one process on one card. It needs a device in the device-facts
table (utils/devices.py) and fails on any other, the CPU included.
"""

from __future__ import annotations

import json
import math
import os
import sys
import time

import numpy as np


def _log(msg):
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


BASELINE_COUNT_QPS = 3.5e6
BASELINE_LOCATE_QPS = 2.5e6

NUM_BASES = int(os.environ.get("AWFM_BENCH_BASES", 64_000_000))
# 4M queries = four 1M compiled chunks, each stage's host sync
# amortized over 4 chunks. AWFM_BENCH_QUERIES overrides.
NUM_QUERIES = int(os.environ.get("AWFM_BENCH_QUERIES", 4_194_304))
KMER_LEN = int(os.environ.get("AWFM_BENCH_KMER_LEN", 25))
# Seed k is THE reference tuning knob (/root/reference/README.md:196-202,
# 268 MB at k=12 on CPU). Unless AWFM_BENCH_SEED_K pins it, the capacity
# planner sizes it to the card's allocator budget.
SEED_K_OVERRIDE = int(os.environ.get("AWFM_BENCH_SEED_K", 0))
RUNS = int(os.environ.get("AWFM_BENCH_RUNS", 5))


def _default_multihit_kmer_len() -> int:
    """Multi-hit kmer length scaled to the corpus: target ~16 expected
    hits/query (bases / 4^len ~ 16), floor 11. At 64M bases this is 11;
    at hg38 scale 14, where a fixed 11 would enumerate ~740 hits/query."""
    return max(11, math.ceil(math.log(NUM_BASES / 16, 4)))


# multi-hit locate stage (the reference's real locate workload is
# multi-hit, AwFmParallelSearch.c:315-365): short kmers -> many hits
# per query. 11-mers over 64M random bases average ~16 hits each.
MULTIHIT_KMER_LEN = int(
    os.environ.get("AWFM_BENCH_MULTIHIT_KMER_LEN", 0)
) or _default_multihit_kmer_len()
# 512K multi-hit queries below genome scale, 128K at genome scale: the
# stage sizes one workspace to its exact total hit count (search.py
# locate_flat_device), which at genome scale sits beside ~14.5 GB of
# tables. Neither size is derived for the H100 yet.
MULTIHIT_QUERIES = int(os.environ.get("AWFM_BENCH_MULTIHIT_QUERIES", 0)) or (
    1 << 17 if NUM_BASES >= 1_000_000_000 else 1 << 19
)


def _device_meta(jax) -> dict:
    """What the numbers were measured on: JAX's view of the device and
    nvidia-smi's name and power limit (a card set below its maximum
    limit runs slower under load)."""
    from avxwindowfmindex_tpu.utils import devices

    d = jax.devices()[0]
    smi = devices.nvidia_smi_name_and_power_limit().splitlines()[0]
    name, power_limit = (part.strip() for part in smi.split(",", 1))
    return {
        "platform": d.platform,
        "device_kind": d.device_kind,
        "device_count": len(jax.devices()),
        "nvidia_smi_name": name,
        "nvidia_smi_power_limit": power_limit,
    }


def _time_stage(name, fn, runs=None):
    """Compile + warm-up (discarded) + median-of-N timed runs.

    Returns (median_seconds, [per-run seconds]). The discarded warm-up
    absorbs one-off stalls (allocator growth, cache residency).
    """
    _log(f"compiling {name}")
    fn()
    t0 = time.time()
    fn()
    _log(f"{name} warm-up (discarded): {time.time() - t0:.3f}s")
    times = []
    for _ in range(runs or RUNS):
        t0 = time.time()
        fn()
        times.append(time.time() - t0)
    med = float(np.median(times))
    _log(f"{name}: median {med:.3f}s of {[round(t, 3) for t in times]}")
    return med, [round(t, 4) for t in times]


def _count_overlapping(hay: bytes, needle: bytes) -> int:
    """Exact overlapping occurrence count (host oracle for spot checks)."""
    n = 0
    i = hay.find(needle)
    while i != -1:
        n += 1
        i = hay.find(needle, i + 1)
    return n


def _calibrate_gather_rates(tables, batch, runs=3, seg_lo=4, seg_hi=20):
    """Measured random row-gather rate per device table (rows/s).

    The roofline's gather ceiling must come from a measurement on the
    SAME tables in the same process (a hardcoded rate once produced a
    219%-of-ceiling report). Kernel: a dependent
    pseudo-random walk — each step gathers `batch` rows and derives the
    next indices from the gathered bytes, mirroring the search's
    serial-steps-of-parallel-gathers structure while doing near-zero
    arithmetic, so the measured rate is a CEILING for any real kernel
    with this access pattern. The constant per-dispatch and readback
    overhead is cancelled by differencing a seg_hi-step walk against a
    seg_lo-step walk (interleaved runs, medians).
    """
    import functools

    import jax
    import jax.numpy as jnp

    from avxwindowfmindex_tpu.ops import route as route_ops

    @functools.partial(jax.jit, static_argnames=("seg",))
    def walk(table, idx, *, seg):
        nb = jnp.uint32(table.shape[0])
        for _ in range(seg):
            rows = table[idx]
            # the next index consumes EVERY row byte: a single-byte use
            # would let XLA narrow the gather to 1 B/row and measure a
            # descriptor rate, not a full-row gather. The row-sum reduce
            # is small next to the row fetch.
            nxt = (
                idx.astype(jnp.uint32) * jnp.uint32(1103515245)
                + jnp.sum(rows.astype(jnp.uint32), axis=1)
                + jnp.uint32(12345)
            )
            idx = (nxt % nb).astype(jnp.int32)
        return idx

    @functools.partial(jax.jit, static_argnames=("seg", "plan"))
    def walk_routed(table, idx, *, seg, plan):
        # the slab-routed counterpart, costs included exactly as the
        # production backtrace pays them: one unstable sort per step
        # (payload arity is free) + the per-slab scan gather. covered
        # is ignored — this is a bare-rate ceiling, not an exact walk.
        nb = jnp.uint32(table.shape[0])
        for _ in range(seg):
            si, _ = jax.lax.sort((idx, idx), num_keys=1, is_stable=False)
            rows, _cov = route_ops.routed_gather(table, si, plan)
            nxt = (
                si.astype(jnp.uint32) * jnp.uint32(1103515245)
                + jnp.sum(rows.astype(jnp.uint32), axis=1)
                + jnp.uint32(12345)
            )
            idx = (nxt % nb).astype(jnp.int32)
        return idx

    def _difference_rate(run):
        run(seg_lo)  # compile + warm both programs
        run(seg_hi)
        lo_times, hi_times = [], []
        for _ in range(runs):
            t0 = time.time()
            run(seg_lo)
            lo_times.append(time.time() - t0)
            t0 = time.time()
            run(seg_hi)
            hi_times.append(time.time() - t0)
        dt = float(np.median(hi_times)) - float(np.median(lo_times))
        if dt <= 0:  # noise floor: fall back to the raw hi-walk rate
            return batch * seg_hi / float(np.median(hi_times))
        return batch * (seg_hi - seg_lo) / dt

    rng = np.random.default_rng(99)
    rates = {}
    for name, table in tables.items():
        if table is None:
            continue
        nb = table.shape[0]
        idx0 = jnp.asarray(
            rng.integers(0, nb, size=batch).astype(np.int32)
        )

        rate = _difference_rate(
            lambda seg: int(np.asarray(walk(table, idx0, seg=seg)[0]))
        )
        rates[name] = rate
        _log(
            f"calib {name}: {rate / 1e6:.1f}M rows/s "
            f"(row {table.shape[1]} B, {nb} rows)"
        )
        plan = route_ops.plan_for(nb, table.shape[1], batch)
        if plan is not None:
            rate_r = _difference_rate(
                lambda seg: int(
                    np.asarray(walk_routed(table, idx0, seg=seg, plan=plan)[0])
                )
            )
            rates[name + "_routed"] = rate_r
            _log(
                f"calib {name}_routed: {rate_r / 1e6:.1f}M rows/s "
                f"(sort included, k={plan.k}, cap={plan.cap})"
            )
    return rates


def main():
    global NUM_QUERIES
    import jax
    import jax.numpy as jnp

    from avxwindowfmindex_tpu.utils import devices
    from avxwindowfmindex_tpu.utils.capacity import plan_capacity
    from avxwindowfmindex_tpu.utils.compile_cache import enable_compile_cache

    chip = devices.detect()  # raises off the device-facts table
    enable_compile_cache()
    device_meta = _device_meta(jax)
    _log(f"device: {device_meta}")
    seed_k = SEED_K_OVERRIDE or plan_capacity(
        NUM_BASES, batch=NUM_QUERIES, kmer_len=KMER_LEN
    ).seed_k

    from avxwindowfmindex_tpu import IndexConfiguration, AlphabetType, SearchEngine, create_index
    from avxwindowfmindex_tpu.ops import ngram as ngram_ops
    from avxwindowfmindex_tpu.search import (
        _ngram_ranges_steploop,
        _ranges_steploop,
        _resolve_samples,
        _round_up,
        total_hits_host,
        backtrace_all,
        locate_flat_device,
    )

    t_start = time.time()
    rng = np.random.default_rng(1234)
    seq_arr = rng.choice(np.frombuffer(b"acgt", np.uint8), size=NUM_BASES)
    cfg = IndexConfiguration(
        suffix_array_compression_ratio=8,
        kmer_length_in_seed_table=seed_k,
        alphabet_type=AlphabetType.DNA,
    )
    _log(f"building index: {NUM_BASES} bases, seed k={seed_k}")
    seq_bytes = seq_arr.tobytes()
    # also cut a denser device-side SA (the in-memory-SA locate trade,
    # create_index(device_sa_ratio=...)): measured as a separate
    # meta stage below; the HEADLINE stages keep the protocol ratio 8
    dense_ratio = int(os.environ.get("AWFM_BENCH_DEVICE_SA_RATIO", 4))
    # AWFM_BENCH_CACHE=<dir>: warm-start repeated protocol runs from a
    # .awfmx artifact + finished n-gram rows (the hg38 host build takes
    # about an hour; loading is minutes). Keyed on every build input.
    cache_dir = os.environ.get("AWFM_BENCH_CACHE", "")
    art_path = ng_cache_path = None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        cache_key = (
            f"b{NUM_BASES}_k{seed_k}"
            f"_r{cfg.suffix_array_compression_ratio}_d{dense_ratio}"
        )
        art_path = os.path.join(cache_dir, cache_key + ".awfmx")
    t0 = time.time()
    if art_path and os.path.exists(art_path):
        from avxwindowfmindex_tpu.io.artifact import load_artifact

        index = load_artifact(art_path)
        build_s = time.time() - t0
        _log(f"index loaded from cache in {build_s:.1f}s ({art_path})")
    else:
        index = create_index(
            seq_bytes, cfg, device_sa_ratio=dense_ratio or None
        )
        build_s = time.time() - t0
        _log(f"index built in {build_s:.1f}s")
        if art_path:
            from avxwindowfmindex_tpu.io.artifact import save_artifact

            t0 = time.time()
            save_artifact(index, art_path, compress=False)
            _log(f"index cached in {time.time() - t0:.1f}s ({art_path})")
    dev = index.to_device()
    dev_dense = None
    if index.device_sa is not None:
        import dataclasses as _dc

        # to_device prefers the dense SA when present; the protocol dev
        # swaps the config-ratio samples back in
        dev_dense = dev
        dev = _dc.replace(
            dev,
            sampled_sa=jnp.asarray(index.sampled_sa.astype(np.uint32)),
            ratio=int(cfg.suffix_array_compression_ratio),
        )
    ngram_n = int(os.environ.get("AWFM_BENCH_NGRAM", 2))
    if cache_dir:
        prebias = os.environ.get("AWFM_MS_PREBIAS", "1")
        # keyed ONLY on what shapes the rows (corpus size, n, prebias):
        # seed_k / sa ratios don't enter the pair table, so sweeps over
        # them must warm-start from the same file
        ng_cache_path = os.path.join(
            cache_dir, f"b{NUM_BASES}_ng{ngram_n}_pb{prebias}.npz"
        )
    t0 = time.time()
    dig = ngram_ops.build_ngram_device(
        index, ngram_n, cache_path=ng_cache_path
    )
    digram_build_s = time.time() - t0
    _log(f"{ngram_n}-gram index built in {digram_build_s:.1f}s")

    # sample query kmers from the sequence (guaranteed hits, like
    # timeSearch.c's kmer sampling)
    starts = rng.integers(0, NUM_BASES - KMER_LEN, size=NUM_QUERIES)
    windows = np.lib.stride_tricks.sliding_window_view(seq_arr, KMER_LEN)
    kmer_mat_ascii = windows[starts]
    from avxwindowfmindex_tpu.models import alphabet as alpha

    mat = alpha.NT_ASCII_TO_INDEX[kmer_mat_ascii]

    # fixed-size chunks: one compiled shape regardless of NUM_QUERIES;
    # big chunks amortize per-dispatch overhead on serial step chains
    chunk_q = min(
        NUM_QUERIES, int(os.environ.get("AWFM_BENCH_CHUNK_Q", 1_048_576))
    )
    if NUM_QUERIES % chunk_q != 0:  # round down to a whole number of chunks
        NUM_QUERIES = (NUM_QUERIES // chunk_q) * chunk_q
    # the query batch is uploaded ONCE and the timed stages measure
    # steady-state device throughput; the one-time upload is reported
    # as query_upload_seconds.
    t0 = time.time()
    chunks = [
        jax.block_until_ready(jnp.asarray(mat[lo : lo + chunk_q]))
        for lo in range(0, NUM_QUERIES, chunk_q)
    ]
    upload_s = time.time() - t0
    _log(f"query upload: {upload_s:.2f}s for {NUM_QUERIES} kmers")
    chunk_len = np.full(chunk_q, KMER_LEN, dtype=np.int32)

    # locate stages dispatch at a LARGER chunk (the routed backtrace's
    # compaction levels stay above the routing break-even) while count
    # keeps chunk_q; neither chunk size is derived for the H100 yet.
    lchunk_q = min(
        NUM_QUERIES,
        int(os.environ.get("AWFM_BENCH_LOCATE_CHUNK_Q", 4_194_304)),
    )
    if NUM_QUERIES % lchunk_q != 0:
        lchunk_q = chunk_q
    if lchunk_q == chunk_q:
        lchunks = chunks
    else:
        lchunks = [
            jax.block_until_ready(jnp.asarray(mat[lo : lo + lchunk_q]))
            for lo in range(0, NUM_QUERIES, lchunk_q)
        ]

    # Cross-engine parity at bench scale: the single-step and digram
    # engines must produce IDENTICAL ranges for every query. Both runs
    # here are the exact (internally synced) formulations; the compare
    # reduces on device and reads back one scalar per chunk.
    mismatches = 0
    for cm in chunks:
        s1, e1 = _ranges_steploop(dev, cm, chunk_len, seeded=True)
        s2, e2 = _ngram_ranges_steploop(
            dev, dig, cm, kmer_len=KMER_LEN, seed_k=seed_k
        )
        mismatches += int(
            np.asarray(jnp.sum(((s1 != s2) | (e1 != e2)).astype(jnp.uint32)))
        )
    assert mismatches == 0, (
        f"single-step vs digram range mismatch on {mismatches} queries"
    )
    _log("cross-engine parity: single-step == digram on all chunks")

    def _finish(total, pend, redo_fn):
        """ONE combined readback of the result + all deferred pair-window
        flag counts; a flagged batch (rare: ranges wider than 512 mid-
        extension) falls back to the exact synchronous formulation."""
        vals = np.asarray(
            jnp.concatenate(
                [total[None]] + [c[None].astype(jnp.uint32) for c, _ in pend]
            )
        )
        if len(vals) > 1 and vals[1:].any():
            _log("pair-window flags present; re-running stage exactly")
            redo_fn()

    def run_count(defer=True):
        total = jnp.uint32(0)
        pend = []
        for cm in chunks:
            s, e = _ranges_steploop(
                dev, cm, chunk_len, seeded=True, defer=pend if defer else None
            )
            counts = jnp.where(s <= e, e - s + jnp.uint32(1), jnp.uint32(0))
            total = total + counts[0]
        if not defer:
            _ = int(np.asarray(total))
            return
        _finish(total, pend, lambda: run_count(defer=False))

    med, count_times = _time_stage("count_step", run_count)
    count_qps = NUM_QUERIES / med

    # double-step (digram) count: two letters per gather
    def run_count2(defer=True):
        total = jnp.uint32(0)
        pend = []
        for cm in chunks:
            s, e = _ngram_ranges_steploop(
                dev, dig, cm, kmer_len=KMER_LEN, seed_k=seed_k,
                defer=pend if defer else None,
            )
            c = jnp.where(s <= e, e - s + jnp.uint32(1), jnp.uint32(0))
            total = total + c[0]
        if not defer:
            _ = int(np.asarray(total))
            return
        _finish(total, pend, lambda: run_count2(defer=False))

    med, count2_times = _time_stage("digram_count", run_count2)
    count2_qps = NUM_QUERIES / med

    # locate (first hit): resolve the range start of every query — the
    # per-hit backtrace cost in isolation. Locate stages use digram
    # ranges, with the fixup readback deferred.
    def locate_step(cm, pend):
        s, e = _ngram_ranges_steploop(
            dev, dig, cm, kmer_len=KMER_LEN, seed_k=seed_k, defer=pend
        )
        valid = s <= e
        pos = jnp.where(valid, s, jnp.uint32(0))
        p, off = backtrace_all(dev, pos)
        hits = _resolve_samples(dev, p, off)
        return jnp.where(valid, hits, jnp.uint32(0))

    def run_locate(defer=True):
        total = jnp.uint32(0)
        pend = []
        for cm in lchunks:
            hits = locate_step(cm, pend if defer else None)
            total = total + hits[0]
        if not defer:
            _ = int(np.asarray(total))
            return
        _finish(total, pend, lambda: run_locate(defer=False))

    med, locate_times = _time_stage("locate_first_hit", run_locate)
    locate_qps = NUM_QUERIES / med

    # locate (full hit list): resolve EVERY position of every range —
    # the reference's actual locate workload (AwFmParallelSearch.c:
    # 315-365). Capacity sized per chunk from the true total (rounded
    # coarsely so every chunk shares one compiled shape).
    chunk_ranges = []
    total_hits = 0
    for cm in lchunks:
        s, e = _ngram_ranges_steploop(
            dev, dig, cm, kmer_len=KMER_LEN, seed_k=seed_k
        )
        chunk_ranges.append((s, e))
        total_hits += total_hits_host(s, e)
    cap = _round_up(
        max(total_hits_host(s, e) for s, e in chunk_ranges), 65536
    )
    _log(f"total hits {total_hits} over {NUM_QUERIES} queries; capacity {cap}")

    def run_locate_all(defer=True):
        total = jnp.uint32(0)
        pend = []
        for cm in lchunks:
            s, e = _ngram_ranges_steploop(
                dev, dig, cm, kmer_len=KMER_LEN, seed_k=seed_k,
                defer=pend if defer else None,
            )
            hits, _qid, mask = locate_flat_device(dev, s, e, capacity=cap)
            total = total + hits[0]
        if not defer:
            _ = int(np.asarray(total))
            return
        _finish(total, pend, lambda: run_locate_all(defer=False))

    med, locate_all_times = _time_stage("locate_all", run_locate_all)
    locate_all_qps = NUM_QUERIES / med
    locate_all_hps = total_hits / med

    # locate (full hit list) with the DENSE device SA: same answers,
    # device_sa_ratio-length LF chains instead of ratio-8 ones
    dense_qps = None
    dense_times = None
    if dev_dense is not None:
        def run_locate_all_dense(defer=True):
            total = jnp.uint32(0)
            pend = []
            for cm in lchunks:
                s, e = _ngram_ranges_steploop(
                    dev_dense, dig, cm, kmer_len=KMER_LEN, seed_k=seed_k,
                    defer=pend if defer else None,
                )
                hits, _qid, _mask = locate_flat_device(
                    dev_dense, s, e, capacity=cap
                )
                total = total + hits[0]
            if not defer:
                _ = int(np.asarray(total))
                return
            _finish(total, pend, lambda: run_locate_all_dense(defer=False))

        med, dense_times = _time_stage(
            f"locate_all_dense_sa_r{dense_ratio}", run_locate_all_dense
        )
        dense_qps = NUM_QUERIES / med

    # locate (multi-hit): the reference's real locate workload resolves
    # MANY positions per query (AwFmParallelSearch.c:315-365); random
    # 25-mers are ~all unique, so this stage uses short kmers to stress
    # capacity sizing, enumeration and qid grouping at million-hit scale.
    mh_len = MULTIHIT_KMER_LEN
    mh_q = MULTIHIT_QUERIES
    mh_starts = rng.integers(0, NUM_BASES - mh_len, size=mh_q)
    windows_mh = np.lib.stride_tricks.sliding_window_view(seq_arr, mh_len)
    mh_ascii = windows_mh[mh_starts]
    mh_mat = jax.block_until_ready(
        jnp.asarray(alpha.NT_ASCII_TO_INDEX[mh_ascii])
    )
    mh_lengths = np.full(mh_q, mh_len, dtype=np.int32)
    mh_seeded = mh_len >= seed_k
    s, e = _ranges_steploop(dev, mh_mat, mh_lengths, seeded=mh_seeded)
    mh_total = total_hits_host(s, e)
    mh_cap = _round_up(mh_total, 65536)
    _log(
        f"multihit: {mh_total} hits over {mh_q} {mh_len}-mers "
        f"({mh_total / mh_q:.1f} hits/query); capacity {mh_cap}"
    )

    def run_multihit():
        s, e = _ranges_steploop(dev, mh_mat, mh_lengths, seeded=mh_seeded)
        hits, _qid, _mask = locate_flat_device(dev, s, e, capacity=mh_cap)
        _ = int(np.asarray(hits[0]))

    med, mh_times = _time_stage("locate_multihit", run_multihit)
    mh_qps = mh_q / med
    mh_hps = mh_total / med

    # optional profiler trace of one locate pass (jax.profiler; view
    # with tensorboard or xprof) — SURVEY.md §5 tracing subsystem
    profile_dir = os.environ.get("AWFM_BENCH_PROFILE")
    if profile_dir:
        _log(f"capturing profiler trace to {profile_dir}")
        with jax.profiler.trace(profile_dir):
            run_locate_all()

    # exact correctness spot checks against a host oracle (overlapping
    # bytes.find scan) — counts must MATCH, not merely be >= 1
    engine = SearchEngine(index)
    sample = rng.integers(0, NUM_QUERIES, size=32)
    sample_kmers = [kmer_mat_ascii[i].tobytes() for i in sample]
    want = np.array([_count_overlapping(seq_bytes, k) for k in sample_kmers])
    got = engine.count(sample_kmers)
    assert (got == want).all(), (
        f"count mismatch vs host oracle: {got[got != want]} != "
        f"{want[got != want]}"
    )
    _log("count spot check: 32/32 exact vs host-scan oracle")

    # multi-hit locate correctness: every returned position must match
    # the query (soundness, all 64), and the highest-frequency sampled
    # kmer's hit list must be COMPLETE vs the host scan
    mh_sample = rng.integers(0, mh_q, size=64)
    mh_sample_kmers = [mh_ascii[i].tobytes() for i in mh_sample]
    mh_hits = engine.locate(mh_sample_kmers)
    max_pos = NUM_BASES - mh_len
    for kb, hits_i in zip(mh_sample_kmers, mh_hits):
        assert (hits_i <= max_pos).all(), "hit beyond last valid window"
        pat = np.frombuffer(kb, dtype=np.uint8)
        assert (windows_mh[hits_i] == pat[None, :]).all(), (
            f"locate returned a non-matching position for {kb!r}"
        )
    freq_i = int(np.argmax([len(h) for h in mh_hits]))
    freq_want = _count_overlapping(seq_bytes, mh_sample_kmers[freq_i])
    assert len(mh_hits[freq_i]) == freq_want, (
        f"multi-hit completeness: {len(mh_hits[freq_i])} != {freq_want}"
    )
    _log(
        "multihit spot check: 64/64 sound, most-frequent kmer complete "
        f"({freq_want} hits)"
    )

    # roofline vs MEASURED per-table gather rates (utils/roofline.py)
    from avxwindowfmindex_tpu.utils import roofline

    # calibration batch must be large enough to hide gather latency
    # behind throughput (the walk's steps are serially dependent), so
    # calibrate at the 1M protocol batch.
    rates = _calibrate_gather_rates(
        {
            "single": dev.packed,
            "pair": dev.packed_pair,
            "ngram_pair": dig.packed,
        },
        batch=1 << 20,
    )
    rb = roofline.table_row_bytes(AlphabetType.DNA, ngram_n=ngram_n)
    from avxwindowfmindex_tpu.ops import route as route_ops

    bt_min = route_ops.min_routed_batch(
        dev.packed.shape[0], dev.packed.shape[1]
    )
    roof_kw = dict(
        kmer_len=KMER_LEN, seed_k=seed_k, ratio=dev.ratio,
        rates=rates, row_bytes=rb, bt_routed_min_batch=bt_min, chip=chip,
    )
    count_roof = roofline.report(count_qps, ngram_n=1, **roof_kw)
    count2_roof = roofline.report(count2_qps, ngram_n=ngram_n, **roof_kw)
    locate_roof = roofline.report(
        locate_qps, ngram_n=ngram_n,
        locate_positions_per_query=1.0, batch=lchunk_q, **roof_kw,
    )
    locate_all_roof = roofline.report(
        locate_all_qps, ngram_n=ngram_n,
        locate_positions_per_query=cap / lchunk_q, batch=cap, **roof_kw,
    )
    dense_roof = None
    if dev_dense is not None:
        dense_roof = roofline.report(
            dense_qps, kmer_len=KMER_LEN, seed_k=seed_k,
            ratio=dense_ratio, ngram_n=ngram_n,
            locate_positions_per_query=cap / lchunk_q, batch=cap,
            rates=rates, row_bytes=rb, bt_routed_min_batch=bt_min,
            chip=chip,
        )
    # unseeded multihit range phase = (L-1) classic single steps of two
    # single-row gathers each: modeled as seed_k=1 + pair_rows=False
    multihit_roof = roofline.report(
        mh_qps, kmer_len=mh_len,
        seed_k=seed_k if mh_seeded else 1,
        ratio=dev.ratio, ngram_n=1, pair_rows=mh_seeded,
        locate_positions_per_query=mh_cap / mh_q,
        rates=rates, row_bytes=rb, batch=mh_cap,
        bt_routed_min_batch=bt_min, chip=chip,
    )
    meta = {
        **device_meta,
        "roofline_peak_hbm_bytes_per_sec": chip.hbm_bytes_per_sec,
        "roofline_peak_source": chip.source,
        "num_bases": NUM_BASES,
        "num_queries": NUM_QUERIES,
        "kmer_len": KMER_LEN,
        "seed_k": seed_k,
        "runs": RUNS,
        "build_seconds": round(build_s, 2),
        "digram_build_seconds": round(digram_build_s, 2),
        "query_upload_seconds": round(upload_s, 2),
        "count_qps": round(count_qps),
        "count_times": count_times,
        "count_ngram_qps": round(count2_qps),
        "count_ngram_times": count2_times,
        "ngram_n": ngram_n,
        "locate_first_hit_qps": round(locate_qps),
        "locate_first_hit_times": locate_times,
        "locate_all_qps": round(locate_all_qps),
        "locate_all_hits_per_sec": round(locate_all_hps),
        "locate_all_times": locate_all_times,
        "total_hits": total_hits,
        "device_sa_ratio": dense_ratio if dev_dense is not None else None,
        "locate_all_dense_sa_qps": (
            round(dense_qps) if dense_qps else None
        ),
        "locate_all_dense_sa_times": dense_times,
        "multihit_kmer_len": mh_len,
        "multihit_queries": mh_q,
        "multihit_total_hits": mh_total,
        "multihit_hits_per_query": round(mh_total / mh_q, 2),
        "multihit_qps": round(mh_qps),
        "multihit_hits_per_sec": round(mh_hps),
        "multihit_times": mh_times,
        "total_seconds": round(time.time() - t_start, 1),
        "gather_rates_rows_per_sec": {
            t: round(r) for t, r in rates.items()
        },
        "count_roofline": count_roof,
        "count_ngram_roofline": count2_roof,
        "locate_roofline": locate_roof,
        "locate_all_roofline": locate_all_roof,
        "locate_all_dense_sa_roofline": dense_roof,
        "multihit_roofline": multihit_roof,
    }
    print(json.dumps({"meta": meta}))
    # distinct metric name at genome scale, so a genome-scale row and
    # the 64M row never share a name
    scale_tag = "_hg38" if NUM_BASES >= 3_000_000_000 else ""
    print(
        json.dumps(
            {
                "metric": f"nt25{scale_tag}_locate_all_queries_per_sec",
                "value": round(locate_all_qps),
                "unit": "queries/s",
                "vs_baseline": round(locate_all_qps / BASELINE_LOCATE_QPS, 3),
            }
        )
    )


if __name__ == "__main__":
    main()
