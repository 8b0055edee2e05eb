"""64-bit-capacity batched search: count/locate beyond 2^32 positions.

Mirrors the 32-bit engine paths in search.py over the (hi, lo) u32-pair
arithmetic of ops/rank64.py, restoring the reference's full u64 capacity
(AwFmIndex.h:94-109; SA math AwFmSuffixArray.c:12-18) on device. The
structure is deliberately parallel to search.py: a lax.scan formulation
(the CPU backend) and a host-driven step loop (accelerator backends),
plus the compacting backtrace driver.

SearchEngine dispatches here automatically when its device view is a
DeviceIndex64 (FmIndex.to_device picks that for bwtLength >= 2^32, or
when forced with wide=True). Results are bit-identical to the 32-bit
path wherever both apply (tests/test_index64.py).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .ops import rank64 as r64
from .ops.rank64 import DeviceIndex64

# shared drivers/helpers (search.py imports this module only lazily, so
# the module-level import is cycle-free); _flag_count/_flag_indices are
# batch-shape-generic and shared with the 32-bit pair-fixup path
from .search import (
    _bt_schedule,
    _flag_count as _flag_count64,
    _flag_indices as _flag_indices64,
    _fuse_steps,
    _round_up,
    _round_up_pow2,
    _use_step_loop,
)

_U0 = jnp.uint32(0)
_U1 = jnp.uint32(1)


# ---------------------------------------------------------------------------
# Seeding / extension
# ---------------------------------------------------------------------------

@jax.jit
def _seed_lookup64(dev, last_k_letters):
    card = dev.cardinality
    seed_k = dev.kmer_length_in_seed_table
    powers = np.array(
        [card ** (seed_k - 1 - j) for j in range(seed_k)], dtype=np.uint32
    )
    table_idx = jnp.sum(
        last_k_letters.astype(jnp.uint32) * powers[None, :], axis=1
    ).astype(jnp.int32)
    seeded = dev.seed_table[table_idx]  # (B, 4) [s_lo, s_hi, e_lo, e_hi]
    return seeded[:, 1], seeded[:, 0], seeded[:, 3], seeded[:, 2]


@jax.jit
def _initial_range64(dev, last_letters):
    lett = last_letters.astype(jnp.int32)
    s_hi = dev.prefix_hi[lett]
    s_lo = dev.prefix_lo[lett]
    e_hi, e_lo = r64.sub64_small(
        dev.prefix_hi[lett + 1], dev.prefix_lo[lett + 1], _U1
    )
    return s_hi, s_lo, e_hi, e_lo


@jax.jit
def _step_masked64(dev, s_hi, s_lo, e_hi, e_lo, letters, active):
    return r64.backward_step64(
        dev, s_hi, s_lo, e_hi, e_lo, letters.astype(jnp.int32), active
    )


@functools.partial(jax.jit, static_argnames=("seg",))
def _steps_fused64(dev, s_hi, s_lo, e_hi, e_lo, *letter_cols, seg):
    for s in range(seg):
        s_hi, s_lo, e_hi, e_lo = r64.backward_step64(
            dev, s_hi, s_lo, e_hi, e_lo, letter_cols[s].astype(jnp.int32)
        )
    return s_hi, s_lo, e_hi, e_lo


# -- pair-row (one-gather) steps; mirrors search._ranges_steploop_pair ------

@jax.jit
def _step_masked64_pair(dev, s_hi, s_lo, e_hi, e_lo, bad, letters, active):
    return r64.backward_step64_pair(
        dev, s_hi, s_lo, e_hi, e_lo, letters.astype(jnp.int32), bad, active
    )


@functools.partial(jax.jit, static_argnames=("seg",))
def _steps_fused64_pair(dev, s_hi, s_lo, e_hi, e_lo, bad, *letter_cols, seg):
    for s in range(seg):
        s_hi, s_lo, e_hi, e_lo, bad = r64.backward_step64_pair(
            dev, s_hi, s_lo, e_hi, e_lo, letter_cols[s].astype(jnp.int32), bad
        )
    return s_hi, s_lo, e_hi, e_lo, bad


def _use_pair_rows64() -> bool:
    import os

    return os.environ.get("AWFM_PAIR_ROWS", "1") != "0"


@functools.partial(jax.jit, static_argnames=("n_steps", "seeded"))
def _ranges_scan64(dev, kmers, lengths, *, n_steps, seeded):
    """Single-program scan formulation (CPU backends)."""
    seed_k = dev.kmer_length_in_seed_table
    if seeded:
        card = dev.cardinality
        idxs = (
            lengths[:, None]
            - seed_k
            + jnp.arange(seed_k, dtype=jnp.int32)[None, :]
        )
        last_k = jnp.take_along_axis(kmers, idxs, axis=1)
        s_hi, s_lo, e_hi, e_lo = _seed_lookup64(dev, last_k)
        first = lengths - seed_k - 1
    else:
        last = jnp.take_along_axis(kmers, (lengths - 1)[:, None], axis=1)[:, 0]
        s_hi, s_lo, e_hi, e_lo = _initial_range64(dev, last)
        first = lengths - 2

    def step(carry, t):
        sh, sl, eh, el = carry
        pos_in_kmer = first - t
        active = pos_in_kmer >= 0
        lett = jnp.take_along_axis(
            kmers, jnp.maximum(pos_in_kmer, 0)[:, None], axis=1
        )[:, 0].astype(jnp.int32)
        sh, sl, eh, el = r64.backward_step64(dev, sh, sl, eh, el, lett, active)
        return (sh, sl, eh, el), None

    if n_steps > 0:
        (s_hi, s_lo, e_hi, e_lo), _ = jax.lax.scan(
            step,
            (s_hi, s_lo, e_hi, e_lo),
            jnp.arange(n_steps, dtype=jnp.int32),
        )
    return s_hi, s_lo, e_hi, e_lo


def _ranges_steploop64(dev, mat: np.ndarray, lengths: np.ndarray,
                       seeded: bool, pair: bool, put=None):
    """Host-driven extension loop -> device (s_hi, s_lo, e_hi, e_lo, bad).

    ``pair``: route through the one-gather pair-window step
    (r64.backward_step64_pair); queries whose range outgrew the
    512-position window are flagged on device (``bad``; None when
    pair=False) and must be re-run by the caller through this same loop
    with pair=False (exact two-gather), mirroring
    search._ranges_steploop_pair. ranges64 folds the flag count into
    its single result readback — no extra host sync.

    ``put`` maps host arrays onto the device(s); pass a sharding
    device_put for query-data-parallel meshes (the per-step programs
    are GSPMD-partitionable: batch-elementwise plus replicated-table
    gathers, no collectives — same contract as search._ranges_steploop).
    """
    if put is None:
        put = jnp.asarray
    b, l = mat.shape
    if seeded:
        k = dev.kmer_length_in_seed_table
        idxs = np.clip(
            lengths[:, None] - k + np.arange(k)[None, :], 0, l - 1
        )
        s_hi, s_lo, e_hi, e_lo = _seed_lookup64(
            dev, put(np.take_along_axis(mat, idxs, axis=1))
        )
        n_steps = max(0, l - k)
        pos = lengths[:, None] - k - 1 - np.arange(n_steps)[None, :]
    else:
        s_hi, s_lo, e_hi, e_lo = _initial_range64(
            dev,
            put(
                np.take_along_axis(mat, (lengths - 1)[:, None], axis=1)[:, 0]
            ),
        )
        n_steps = l - 1
        pos = lengths[:, None] - 2 - np.arange(n_steps)[None, :]
    letters = np.take_along_axis(mat, np.clip(pos, 0, l - 1), axis=1)
    active = pos >= 0
    bad = put(np.zeros(b, dtype=bool)) if pair else None
    # ONE bulk host->device put of the letters matrix, then device-side
    # column slices (same pattern as search._steploop_letters)
    letters_dev = put(letters) if n_steps > 0 else None
    if bool(active.all()):
        fuse = _fuse_steps(dev.alphabet)
        for lo in range(0, n_steps, fuse):
            seg = list(range(lo, min(lo + fuse, n_steps)))
            cols = [letters_dev[:, t] for t in seg]
            if pair:
                s_hi, s_lo, e_hi, e_lo, bad = _steps_fused64_pair(
                    dev, s_hi, s_lo, e_hi, e_lo, bad, *cols, seg=len(seg)
                )
            else:
                s_hi, s_lo, e_hi, e_lo = _steps_fused64(
                    dev, s_hi, s_lo, e_hi, e_lo, *cols, seg=len(seg)
                )
    else:
        active_dev = put(active)
        for t in range(n_steps):
            col = letters_dev[:, t]
            act = active_dev[:, t]
            if pair:
                s_hi, s_lo, e_hi, e_lo, bad = _step_masked64_pair(
                    dev, s_hi, s_lo, e_hi, e_lo, bad, col, act
                )
            else:
                s_hi, s_lo, e_hi, e_lo = _step_masked64(
                    dev, s_hi, s_lo, e_hi, e_lo, col, act
                )
    return s_hi, s_lo, e_hi, e_lo, bad


@jax.jit
def _join_for_readback64(s_hi, s_lo, e_hi, e_lo, bad):
    """One flat u32 array [flag_count, s_hi, s_lo, e_hi, e_lo] so the
    whole result (including the pair-window flag check) crosses to the
    host in a single readback."""
    cnt = (
        _flag_count64(bad).astype(jnp.uint32)
        if bad is not None
        else jnp.uint32(0)
    )
    return jnp.concatenate([cnt[None], s_hi, s_lo, e_hi, e_lo])


def ranges64(dev: DeviceIndex64, mat: np.ndarray, lengths: np.ndarray,
             seeded: bool, put=None, pad_multiple: int = 1) -> np.ndarray:
    """Final BWT ranges for an encoded batch -> (B, 2) uint64 host array.

    ``put``/``pad_multiple``: see _ranges_steploop64 — sharding hook and
    fixup sub-batch divisibility for query-data-parallel meshes
    (parallel/dist.py shards over n_dev devices).
    """
    b, l = mat.shape
    if not _use_step_loop():
        k = dev.kmer_length_in_seed_table
        n_steps = max(0, l - k) if seeded else l - 1
        pp = put if put is not None else jnp.asarray
        s_hi, s_lo, e_hi, e_lo = _ranges_scan64(
            dev, pp(mat), pp(lengths),
            n_steps=n_steps, seeded=seeded,
        )
        bad = None
    else:
        # Seeded batches use the one-gather pair-window step (seed
        # ranges are nearly always narrower than a block); unseeded
        # batches start from whole-letter ranges spanning many blocks,
        # so they keep the classic two-gather step.
        pair = seeded and dev.pair_fused and _use_pair_rows64()
        s_hi, s_lo, e_hi, e_lo, bad = _ranges_steploop64(
            dev, mat, lengths, seeded, pair, put
        )
    flat = np.asarray(_join_for_readback64(s_hi, s_lo, e_hi, e_lo, bad))
    cnt = int(flat[0])
    s_hi_h, s_lo_h, e_hi_h, e_lo_h = (
        flat[1 : 1 + b],
        flat[1 + b : 1 + 2 * b],
        flat[1 + 2 * b : 1 + 3 * b],
        flat[1 + 3 * b :],
    )
    start = (s_hi_h.astype(np.uint64) << np.uint64(32)) | s_lo_h.astype(
        np.uint64
    )
    end = (e_hi_h.astype(np.uint64) << np.uint64(32)) | e_lo_h.astype(
        np.uint64
    )
    out = np.stack([start, end], axis=1)
    if cnt:
        # rare: some range outgrew the pair window mid-extension — re-run
        # just those queries through the exact two-gather loop and merge
        # on host (the full result is already host-resident)
        from .utils import metrics

        metrics.counter("search64.pair_fixup.flagged").add(cnt)
        # keep the FULL padded index set (duplicate index-0 fill entries
        # recompute identical exact values) so the sub-batch shape is a
        # bounded power of two — slicing to cnt would compile a fresh
        # program set per distinct flag count (see search._fixup_flagged)
        m = _round_up(_round_up_pow2(min(cnt, b), floor=64), pad_multiple)
        idx = np.asarray(_flag_indices64(bad, m=m))
        sub = ranges64_exact(dev, mat[idx], lengths[idx], seeded, put)
        out[idx] = sub
    return out


def ranges64_exact(dev: DeviceIndex64, mat: np.ndarray, lengths: np.ndarray,
                   seeded: bool, put=None) -> np.ndarray:
    """ranges64 through the classic two-gather step only (fixup path)."""
    s_hi, s_lo, e_hi, e_lo, _ = _ranges_steploop64(
        dev, mat, lengths, seeded, pair=False, put=put
    )
    start = (np.asarray(s_hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        s_lo
    ).astype(np.uint64)
    end = (np.asarray(e_hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        e_lo
    ).astype(np.uint64)
    return np.stack([start, end], axis=1)


# ---------------------------------------------------------------------------
# Backtrace / locate
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("seg",))
def _backtrace_steps_fused64(dev, p_hi, p_lo, off, *, seg):
    for _ in range(seg):
        done = r64.mod_small64(p_hi, p_lo, dev.ratio) == _U0
        _, lf_hi, lf_lo = r64.letter_and_lf_at64(dev, p_hi, p_lo)
        p_hi = jnp.where(done, p_hi, lf_hi)
        p_lo = jnp.where(done, p_lo, lf_lo)
        off = jnp.where(done, off, off + _U1)
    return p_hi, p_lo, off


@jax.jit
def _undone_count64(dev, p_hi, p_lo):
    return jnp.sum(
        r64.mod_small64(p_hi, p_lo, dev.ratio) != _U0, dtype=jnp.int32
    )


def _mask_pad_slots64(p_hi, p_lo, off, idx, b):
    """Pad slots (idx == b) become dropped done-sentinels — position 0
    is sampled, walks nothing, and `_scatter_back64` drops the
    out-of-bounds index. Mirrors search._mask_pad_slots: row-0
    duplicates are harmless for the mono gather but are a cap-overflow
    bomb for any future slab-routed wide formulation."""
    pad = idx >= jnp.int32(b)
    safe = jnp.where(pad, jnp.int32(0), idx)
    z = jnp.uint32(0)
    return (
        idx,
        jnp.where(pad, z, p_hi[safe]),
        jnp.where(pad, z, p_lo[safe]),
        jnp.where(pad, z, off[safe]),
    )


@functools.partial(jax.jit, static_argnames=("m",))
def _gather_undone64(dev, p_hi, p_lo, off, *, m):
    b = p_lo.shape[0]
    idx = jnp.nonzero(
        r64.mod_small64(p_hi, p_lo, dev.ratio) != _U0, size=m, fill_value=b
    )[0].astype(jnp.int32)
    return _mask_pad_slots64(p_hi, p_lo, off, idx, b)


@jax.jit
def _scatter_back64(p_hi, p_lo, off, idx, s_hi, s_lo, s_off):
    # pad slots carry idx == parent batch size: dropped explicitly
    return (
        p_hi.at[idx].set(s_hi, mode="drop"),
        p_lo.at[idx].set(s_lo, mode="drop"),
        off.at[idx].set(s_off, mode="drop"),
    )


@functools.partial(jax.jit, static_argnames=("m",))
def _gather_undone_cumsum64(dev, p_hi, p_lo, off, *, m):
    """Wide counterpart of search._gather_undone_cumsum (padded slots
    are dropped done-sentinels; _mask_pad_slots64)."""
    b = p_lo.shape[0]
    mask = r64.mod_small64(p_hi, p_lo, dev.ratio) != _U0
    pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
    src = jnp.where(mask, pos, m)
    idx = (
        jnp.full((m,), b, dtype=jnp.int32)
        .at[src]
        .set(jnp.arange(b, dtype=jnp.int32), mode="drop")
    )
    return _mask_pad_slots64(p_hi, p_lo, off, idx, b)


@jax.jit
def _backtrace_to_sampled_carry64(dev, p_hi, p_lo, off):
    """Masked while_loop finisher carrying existing offsets (hi/lo).

    Sync-free; exits after one gather-free cond eval when every row is
    already sampled — the wide exactness net."""

    def cond(state):
        ph, pl, _ = state
        return ~jnp.all(r64.mod_small64(ph, pl, dev.ratio) == _U0)

    def body(state):
        ph, pl, oo = state
        done = r64.mod_small64(ph, pl, dev.ratio) == _U0
        _, lf_hi, lf_lo = r64.letter_and_lf_at64(dev, ph, pl)
        return (
            jnp.where(done, ph, lf_hi),
            jnp.where(done, pl, lf_lo),
            jnp.where(done, oo, oo + _U1),
        )

    return jax.lax.while_loop(cond, body, (p_hi, p_lo, off))


def backtrace_all64(dev, p_hi, p_lo):
    """Backtrace a device batch to sampled positions -> (p_hi, p_lo, off).

    SYNC-FREE nested compaction, the hi/lo counterpart of
    search.backtrace_all:
    one first masked pass, statistically-sized compacted levels walked
    deeper, a masked while_loop for the straggler tail, scatters back
    innermost-first, and a final full-batch while_loop net that makes
    EVERY schedule exact. Shares the AWFM_BT_* schedule knobs
    (search._bt_schedule).
    """
    b = p_lo.shape[0]
    first_seg, level_seg, slack, min_level, compact_mode = _bt_schedule(
        dev.ratio
    )
    gather64 = (
        _gather_undone64
        if compact_mode == "nonzero"
        else _gather_undone_cumsum64
    )
    off = jnp.zeros_like(p_lo)
    p_hi, p_lo, off = _backtrace_steps_fused64(
        dev, p_hi, p_lo, off, seg=first_seg
    )
    surv_first = (1.0 - 1.0 / dev.ratio) ** first_seg
    surv_level = (1.0 - 1.0 / dev.ratio) ** level_seg
    levels = []
    cur = (p_hi, p_lo, off)
    m = _round_up(int(b * surv_first * (100 + slack) / 100), 256)
    while m >= min_level and m < cur[1].shape[0]:
        idx, s_hi, s_lo, s_off = gather64(dev, *cur, m=m)
        s_hi, s_lo, s_off = _backtrace_steps_fused64(
            dev, s_hi, s_lo, s_off, seg=level_seg
        )
        levels.append((idx, cur))
        cur = (s_hi, s_lo, s_off)
        m = _round_up(int(m * surv_level * (100 + slack) / 100), 256)
    cur = _backtrace_to_sampled_carry64(dev, *cur)
    for idx, parent in reversed(levels):
        cur = _scatter_back64(*parent, idx, *cur)
    if levels:
        # exactness net for statistical truncation; ~free when unneeded
        cur = _backtrace_to_sampled_carry64(dev, *cur)
    return cur


@jax.jit
def _resolve_samples64(dev, p_hi, p_lo, off):
    """hit = (SA[p / ratio] + offset) % bwtLength (AwFmSuffixArray.c:189-190).

    The mod is a conditional subtract: sa < bwtLength and off < bwtLength
    guarantee sa + off < 2 * bwtLength.
    """
    sample_idx = r64.div_small64(p_hi, p_lo, dev.ratio).astype(jnp.int32)
    sa = dev.sampled_sa[sample_idx]  # (B, 2) [lo, hi]
    h_hi, h_lo = r64.add64_small(sa[:, 1], sa[:, 0], off)
    return r64.mod_bwt64(h_hi, h_lo, dev.bwt_length)


@jax.jit
def _backtrace_resolve64(dev, p_hi, p_lo):
    """Single-program wide backtrace + resolve (for shard_map bodies).

    The hi/lo counterpart of search._backtrace_resolve: a done-masked
    ``while_loop`` LF-backtraces every position to a sampled one, then
    resolves through the (lo, hi) sampled SA. Returns (hit_hi, hit_lo).
    """

    def cond(state):
        _, _, _, done = state
        return ~jnp.all(done)

    def body(state):
        ph, pl, off, done = state
        _, lf_hi, lf_lo = r64.letter_and_lf_at64(dev, ph, pl)
        ph2 = jnp.where(done, ph, lf_hi)
        pl2 = jnp.where(done, pl, lf_lo)
        off2 = jnp.where(done, off, off + _U1)
        done2 = r64.mod_small64(ph2, pl2, dev.ratio) == _U0
        return ph2, pl2, off2, done2

    done0 = r64.mod_small64(p_hi, p_lo, dev.ratio) == _U0
    ph, pl, off, _ = jax.lax.while_loop(
        cond, body, (p_hi, p_lo, jnp.zeros_like(p_lo), done0)
    )
    return _resolve_samples64(dev, ph, pl, off)


def resolve_positions64(engine, bwt_positions: np.ndarray) -> np.ndarray:
    """Backtrace+resolve a flat uint64 array of BWT positions to hits."""
    dev = engine.dev
    n = len(bwt_positions)
    if n == 0:
        return np.empty(0, dtype=np.uint64)
    out = np.empty(n, dtype=np.uint64)
    chunk = 1 << 16
    sa_on_disk = dev.sampled_sa is None
    if sa_on_disk:
        if engine.host_index is None or engine.host_index.file_path is None:
            raise ValueError(
                "suffix array not in memory and no backing file to read from"
            )
    for lo in range(0, n, chunk):
        part = bwt_positions[lo : lo + chunk].astype(np.uint64)
        pad_n = _round_up_pow2(len(part))
        hi_np = np.zeros(pad_n, dtype=np.uint32)
        lo_np = np.zeros(pad_n, dtype=np.uint32)
        hi_np[: len(part)], lo_np[: len(part)] = (
            (part >> np.uint64(32)).astype(np.uint32),
            (part & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        )
        p_hi, p_lo, off = backtrace_all64(
            dev, jnp.asarray(hi_np), jnp.asarray(lo_np)
        )
        if sa_on_disk:
            samp = (
                np.asarray(p_hi[: len(part)]).astype(np.uint64) << np.uint64(32)
            ) | np.asarray(p_lo[: len(part)]).astype(np.uint64)
            hits = engine._resolve_from_file(
                samp, np.asarray(off[: len(part)])
            )
            out[lo : lo + len(part)] = hits
        else:
            h_hi, h_lo = _resolve_samples64(dev, p_hi, p_lo, off)
            out[lo : lo + len(part)] = (
                np.asarray(h_hi[: len(part)]).astype(np.uint64) << np.uint64(32)
            ) | np.asarray(h_lo[: len(part)]).astype(np.uint64)
    return out


# ---------------------------------------------------------------------------
# Seed-table construction (64-bit BFS; AwFmCreate.c:407-450 equivalent)
# ---------------------------------------------------------------------------

@jax.jit
def _extend_all_letters64(dev, s_hi, s_lo, e_hi, e_lo):
    card = dev.cardinality
    n = s_lo.shape[0]
    letts = jnp.repeat(jnp.arange(card, dtype=jnp.int32), n)
    return r64.backward_step64(
        dev,
        jnp.tile(s_hi, card),
        jnp.tile(s_lo, card),
        jnp.tile(e_hi, card),
        jnp.tile(e_lo, card),
        letts,
        active=None,
        check_valid=False,
    )


def _extend_level_chunked(dev, s_hi, s_lo, e_hi, e_lo, card, chunk):
    """One BFS level, sliced so each program's gathered rows stay small.

    _extend_all_letters64 at a deep level gathers 2 * card * n rows in
    one program (~8.6 GB of row temporaries at k=12 with 256 B wide
    rows — HBM OOM); slicing the input batch bounds live temporaries.
    Output ordering matches the unchunked call: index = letter * n + i.
    """
    n = s_lo.shape[0]
    if n * card <= chunk:
        return _extend_all_letters64(dev, s_hi, s_lo, e_hi, e_lo)
    step = max(1, chunk // card)
    outs = []
    for lo in range(0, n, step):
        sl = slice(lo, min(lo + step, n))
        outs.append(
            _extend_all_letters64(dev, s_hi[sl], s_lo[sl], e_hi[sl], e_lo[sl])
        )
    res = []
    for j in range(4):
        parts = [o[j].reshape(card, -1) for o in outs]
        res.append(jnp.concatenate(parts, axis=1).reshape(-1))
    return tuple(res)


def build_seed_table_device64(dev, cardinality: int, k: int, prefix_sums_host,
                              chunk: int = 1 << 21):
    """(|A|^k, 4) uint32 seed table [s_lo, s_hi, e_lo, e_hi], on device."""
    ps = np.asarray(prefix_sums_host, dtype=np.uint64)
    s = ps[:cardinality]
    e = ps[1 : cardinality + 1] - 1
    s_hi, s_lo = r64.split_u64_host(s)
    e_hi, e_lo = r64.split_u64_host(e)
    s_hi, s_lo = jnp.asarray(s_hi), jnp.asarray(s_lo)
    e_hi, e_lo = jnp.asarray(e_hi), jnp.asarray(e_lo)
    for _depth in range(1, k):
        s_hi, s_lo, e_hi, e_lo = _extend_level_chunked(
            dev, s_hi, s_lo, e_hi, e_lo, cardinality, chunk
        )
    return jnp.stack([s_lo, s_hi, e_lo, e_hi], axis=1)
