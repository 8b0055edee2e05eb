"""Batched FM-index search: count and locate on an accelerator.

This is the batched replacement for the reference's whole search stack
(AwFmSearch.c, AwFmKmerTable.c, AwFmParallelSearch.c). Where the C code
hides memory latency with 8 interleaved queries per thread + prefetch
(AwFmParallelSearch.c:273-313), this formulation batches up to a
million queries per step, each step one fused-row gather +
masked-popcount over the whole batch (ops/rank.py). Two equivalent
formulations of the extension loop exist: a ``lax.scan`` single program
(the CPU backend) and a host-driven step loop of small cached programs
(every accelerator backend; see _use_step_loop). Both are
bit-identical; the n-gram engines additionally step 2-3 letters per
gather (ops/ngram.py).

Pipeline (mirrors §3.2 of SURVEY.md):
  seed   — k-length suffix memo-table gather for eligible kmers
           (AwFmKmerTable.c:21-51), or a from-scratch masked scan for
           ineligible ones (AwFmSearch.c:485-520);
  extend — scan over remaining letters (AwFmParallelSearch.c:273-313);
  locate — LF backtrace to the nearest sampled BWT position
           (AwFmParallelSearch.c:315-365) then a sampled-SA gather and
           the sentinel-wrapping mod (AwFmSearch.c:237-241).
"""

from __future__ import annotations

import functools
import os
from typing import List, Sequence, Union

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from .models import alphabet as alpha
from .models.config import AlphabetType
from .models.index import DeviceIndex, FmIndex
from .ops import rank as rank_ops
from .ops import bt_digram as bt_ops

_BACKTRACE_CHUNK = 1 << 16


def _round_up_pow2(n: int, floor: int = 16) -> int:
    n = max(n, floor)
    return 1 << (n - 1).bit_length()


def _round_up(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Jitted device kernels
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("n_ext",))
def _seeded_ranges(dev, kmers, lengths, *, n_ext):
    """Seed-table gather + extension scan for seed-eligible kmers.

    kmers: (B, L) uint8 letter indices (padded); lengths: (B,) int32.
    Seed lookup: radix-accumulate the LAST seed_k letters, leftmost most
    significant (AwFmKmerTable.c:21-51). Extension: one backward step per
    remaining letter, lock-step across the batch
    (AwFmParallelSearch.c:273-313).
    """
    card = dev.cardinality
    seed_k = dev.kmer_length_in_seed_table
    powers = jnp.asarray(
        [card ** (seed_k - 1 - j) for j in range(seed_k)], dtype=jnp.uint32
    )
    idxs = lengths[:, None] - seed_k + jnp.arange(seed_k, dtype=jnp.int32)[None, :]
    last_k = jnp.take_along_axis(kmers, idxs, axis=1).astype(jnp.uint32)
    table_idx = jnp.sum(last_k * powers[None, :], axis=1).astype(jnp.int32)
    seeded = dev.seed_table[table_idx]
    start, end = seeded[:, 0], seeded[:, 1]

    def step(carry, t):
        s, e = carry
        pos_in_kmer = lengths - seed_k - 1 - t
        active = pos_in_kmer >= 0
        lett = jnp.take_along_axis(
            kmers, jnp.maximum(pos_in_kmer, 0)[:, None], axis=1
        )[:, 0].astype(jnp.int32)
        s, e = rank_ops.backward_step(dev, s, e, lett, active)
        return (s, e), None

    if n_ext > 0:
        (start, end), _ = jax.lax.scan(
            step, (start, end), jnp.arange(n_ext, dtype=jnp.int32)
        )
    return start, end


@functools.partial(jax.jit, static_argnames=("n_steps",))
def _unseeded_ranges(dev, kmers, lengths, *, n_steps):
    """Full backward search from scratch (no seed table).

    Used for kmers ineligible for the seed table (too short, or ambiguity
    in the last k letters — AwFmKmerTable.c:4-19) and for the single-query
    awFmFindSearchRangeForString parity path (which never seeds,
    AwFmSearch.c:317-358).
    """
    last = jnp.take_along_axis(kmers, (lengths - 1)[:, None], axis=1)[:, 0].astype(
        jnp.int32
    )
    start = dev.prefix_sums[last]
    end = dev.prefix_sums[last + 1] - jnp.uint32(1)

    def step(carry, t):
        s, e = carry
        pos_in_kmer = lengths - 2 - t
        active = pos_in_kmer >= 0
        lett = jnp.take_along_axis(
            kmers, jnp.maximum(pos_in_kmer, 0)[:, None], axis=1
        )[:, 0].astype(jnp.int32)
        s, e = rank_ops.backward_step(dev, s, e, lett, active)
        return (s, e), None

    if n_steps > 0:
        (start, end), _ = jax.lax.scan(
            step, (start, end), jnp.arange(n_steps, dtype=jnp.int32)
        )
    return start, end


# -- step-loop formulation ---------------------------------------------------
#
# The scan kernels above put the whole extension loop in ONE XLA
# program; the step-loop formulation below dispatches one small compiled
# program per letter (or fused group of letters) instead, and the
# dispatches pipeline asynchronously. Accelerator backends take the
# step loop and CPU keeps the scan path (_use_step_loop). Which one is
# faster on the H100 is not measured yet.

@jax.jit
def _seed_lookup(dev, last_k_letters):
    """Seed-table gather from the last-k letter matrix (B, k)."""
    card = dev.cardinality
    seed_k = dev.kmer_length_in_seed_table
    powers = np.array(
        [card ** (seed_k - 1 - j) for j in range(seed_k)], dtype=np.uint32
    )
    table_idx = jnp.sum(
        last_k_letters.astype(jnp.uint32) * powers[None, :], axis=1
    ).astype(jnp.int32)
    seeded = dev.seed_table[table_idx]
    return seeded[:, 0], seeded[:, 1]


@jax.jit
def _initial_range(dev, last_letters):
    lett = last_letters.astype(jnp.int32)
    return dev.prefix_sums[lett], dev.prefix_sums[lett + 1] - jnp.uint32(1)


@jax.jit
def _step_masked(dev, start, end, letters, active):
    return rank_ops.backward_step(
        dev, start, end, letters.astype(jnp.int32), active
    )


@jax.jit
def _step_all(dev, start, end, letters):
    return rank_ops.backward_step(dev, start, end, letters.astype(jnp.int32))


# -- pair-row (one-gather) steps --------------------------------------------

@jax.jit
def _step_masked_pair(dev, start, end, bad, letters, active):
    return rank_ops.backward_step_pair(
        dev, start, end, letters.astype(jnp.int32), bad, active
    )


@functools.partial(jax.jit, static_argnames=("seg",))
def _steps_fused_pair(dev, start, end, bad, *letter_cols, seg):
    for s in range(seg):
        start, end, bad = rank_ops.backward_step_pair(
            dev, start, end, letter_cols[s].astype(jnp.int32), bad
        )
    return start, end, bad


@jax.jit
def _flag_count(bad):
    return jnp.sum(bad, dtype=jnp.int32)


@functools.partial(jax.jit, static_argnames=("m",))
def _flag_indices(bad, *, m):
    return jnp.nonzero(bad, size=m, fill_value=0)[0].astype(jnp.int32)


@jax.jit
def _scatter_ranges(start, end, idx, sub_s, sub_e):
    return start.at[idx].set(sub_s), end.at[idx].set(sub_e)


def _use_pair_rows(dev) -> bool:
    import os

    return dev.packed_pair is not None and os.environ.get(
        "AWFM_PAIR_ROWS", "1"
    ) != "0"


def _ranges_steploop(dev, mat: np.ndarray, lengths: np.ndarray, seeded: bool,
                     put=None, defer=None, pad_multiple: int = 1):
    """Host-driven extension loop; bit-identical to the scan kernels.

    ``put`` maps host arrays onto the device(s); pass a sharding
    device_put for data-parallel meshes (the per-step programs are
    GSPMD-partitionable: batch-elementwise plus replicated-table
    gathers, no collectives).

    Seeded batches route through the ONE-GATHER pair-row step when the
    pair table is resident; queries whose range outgrew the pair window
    (flagged on device) are re-run through this classic two-gather loop,
    so results are exact in all cases. Unseeded batches start with
    whole-letter ranges that always span many blocks, so they keep the
    classic step.
    """
    if seeded and _use_pair_rows(dev):
        return _ranges_steploop_pair(dev, mat, lengths, put, defer,
                                     pad_multiple)
    return _ranges_steploop_classic(dev, mat, lengths, seeded, put)


def _steploop_letters(dev, mat, lengths, seeded: bool, put):
    """Seed/initial state + per-step letter columns for a step loop.

    Returns (start, end, cols, active) where ``cols`` is a list of
    device (B,) letter columns (leftmost-last extension order) and
    ``active`` a list of device (B,) bool columns or None when every
    step is fully active.

    Host->device traffic is ONE bulk ``put`` per batch (the letters
    matrix, or nothing when ``mat`` is already device-resident), not
    one transfer per column. Uniform-length
    batches slice columns straight off the device matrix; their active
    masks are per-step constants, so all-inactive steps are simply
    dropped and the rest run unmasked.
    """
    import jax as _jax

    k = dev.kmer_length_in_seed_table
    b, l = mat.shape
    lengths = np.asarray(lengths)
    uniform = bool((lengths == lengths[0]).all())
    is_dev = isinstance(mat, _jax.Array)
    if is_dev and not uniform:
        # rare (mixed-length device batch): host math needs the bytes
        mat = np.asarray(mat)
        is_dev = False
    if is_dev:
        mat = put(mat)  # apply caller sharding; no-op for jnp.asarray
        l0 = int(lengths[0])
        if seeded:
            start, end = _seed_lookup(dev, mat[:, l0 - k : l0])
            cols = [mat[:, t] for t in range(l0 - k - 1, -1, -1)]
        else:
            start, end = _initial_range(dev, mat[:, l0 - 1])
            cols = [mat[:, t] for t in range(l0 - 2, -1, -1)]
        return start, end, cols, None
    if seeded:
        idxs = np.clip(lengths[:, None] - k + np.arange(k)[None, :], 0, l - 1)
        start, end = _seed_lookup(
            dev, put(np.take_along_axis(mat, idxs, axis=1))
        )
        n_steps = max(0, l - k)
        pos = lengths[:, None] - k - 1 - np.arange(n_steps)[None, :]
    else:
        start, end = _initial_range(
            dev,
            put(np.take_along_axis(mat, (lengths - 1)[:, None], axis=1)[:, 0]),
        )
        n_steps = l - 1
        pos = lengths[:, None] - 2 - np.arange(n_steps)[None, :]
    letters = np.take_along_axis(mat, np.clip(pos, 0, l - 1), axis=1)
    active = pos >= 0
    # drop trailing all-inactive steps (uniform batches padded on the
    # length axis); a run of live steps needs no masks at all
    live = [t for t in range(n_steps) if active[:, t].any()]
    if not live:
        return start, end, [], None
    n_steps = max(live) + 1
    letters_dev = put(letters[:, :n_steps])
    cols = [letters_dev[:, t] for t in range(n_steps)]
    if bool(active[:, :n_steps].all()):
        return start, end, cols, None
    active_dev = put(active[:, :n_steps])
    return start, end, cols, [active_dev[:, t] for t in range(n_steps)]


def _ranges_steploop_classic(dev, mat: np.ndarray, lengths: np.ndarray,
                             seeded: bool, put=None):
    if put is None:
        put = jnp.asarray
    start, end, cols, active = _steploop_letters(dev, mat, lengths, seeded, put)
    if active is None:
        fuse = _fuse_steps(dev.alphabet)
        for lo in range(0, len(cols), fuse):
            seg = cols[lo : lo + fuse]
            start, end = _steps_fused(dev, start, end, *seg, seg=len(seg))
    else:
        for col, act in zip(cols, active):
            start, end = _step_masked(dev, start, end, col, act)
    return start, end


def _ranges_steploop_pair(dev, mat: np.ndarray, lengths: np.ndarray, put=None,
                          defer=None, pad_multiple: int = 1):
    """Seeded extension with one-gather pair steps + flagged re-runs."""
    if put is None:
        put = jnp.asarray
    start, end, cols, active = _steploop_letters(dev, mat, lengths, True, put)
    bad = put(np.zeros(mat.shape[0], dtype=bool))
    if active is None:
        fuse = _fuse_steps(dev.alphabet)
        for lo in range(0, len(cols), fuse):
            seg = cols[lo : lo + fuse]
            start, end, bad = _steps_fused_pair(
                dev, start, end, bad, *seg, seg=len(seg)
            )
    else:
        for col, act in zip(cols, active):
            start, end, bad = _step_masked_pair(dev, start, end, bad, col, act)
    return _fixup_flagged(
        dev, mat, lengths, start, end, bad,
        lambda sub_mat, sub_len: _ranges_steploop_classic(
            dev, sub_mat, sub_len, True, put
        ),
        defer,
        pad_multiple,
    )


def _fixup_flagged(dev, mat, lengths, start, end, bad, classic_fn,
                   defer=None, pad_multiple: int = 1):
    """Re-run flagged queries through an exact classic path.

    ONE scalar readback when nothing flagged (the common case); else the
    flagged indices are compacted on device and only those few int32s
    cross to the host (bulk device->host is the expensive direction).

    ``defer``: optional list. When given, the readback is NOT performed
    here; ``(flag_count_device_scalar, redo_fn)`` is appended and the
    SPECULATIVE ranges are returned so the caller can keep enqueueing
    dependent device work and fold the flag check into its own final
    readback: every host sync stalls the device queue. On the rare flagged
    batch the caller must call ``redo_fn()`` (returns exact ranges) and
    recompute dependents.
    """
    from .utils import metrics

    if defer is not None:
        defer.append((
            _flag_count(bad),
            lambda: _fixup_flagged(
                dev, mat, lengths, start, end, bad, classic_fn,
                pad_multiple=pad_multiple,
            ),
        ))
        return start, end
    cnt = int(np.asarray(_flag_count(bad)))
    if cnt:
        metrics.counter("search.pair_fixup.flagged").add(cnt)
    if cnt == 0:
        return start, end
    b = mat.shape[0]
    if cnt > b // 4:
        return classic_fn(mat, lengths)
    # the sub-batch must satisfy the caller's sharding divisibility
    # (DistributedSearchEngine shards over n_dev devices)
    m = _round_up(_round_up_pow2(cnt, floor=64), pad_multiple)
    idx_dev = _flag_indices(bad, m=m)
    idx = np.asarray(idx_dev)
    sub_s, sub_e = classic_fn(mat[idx], lengths[idx])
    return _scatter_ranges(start, end, idx_dev, sub_s, sub_e)


def _use_step_loop() -> bool:
    """Step loop on every accelerator backend, one scan program on CPU.

    The split is kept as it stands until the H100 measures both
    formulations (ROADMAP C4); it is not a measured choice there."""
    return jax.default_backend() != "cpu"


@jax.jit
def _backtrace_to_sampled(dev, positions):
    """LF-backtrace each BWT position to a sampled one, single program.

    while !sampled(p): p = LF(p); offset++   (AwFmParallelSearch.c:343-354)

    The chain length is unbounded (expected ~ratio), so this is a batched
    ``while_loop`` with done-masking. Used where the host-driven
    compaction driver below cannot run (inside shard_map bodies).
    Returns (sampled_positions, offsets).
    """
    ratio_u = jnp.uint32(dev.ratio)

    def cond(state):
        _, _, done = state
        return ~jnp.all(done)

    def body(state):
        p, off, done = state
        _, lf = rank_ops.letter_and_lf_at(dev, p)
        p2 = jnp.where(done, p, lf)
        off2 = jnp.where(done, off, off + jnp.uint32(1))
        done2 = (p2 % ratio_u) == 0
        return p2, off2, done2

    done0 = (positions % ratio_u) == 0
    p, off, _ = jax.lax.while_loop(
        cond, body, (positions, jnp.zeros_like(positions), done0)
    )
    return p, off


@functools.partial(jax.jit, static_argnames=("n_steps",))
def _backtrace_steps(dev, positions, offsets, *, n_steps):
    """n_steps masked LF steps (fixed-trip scan)."""
    ratio_u = jnp.uint32(dev.ratio)

    def step(carry, _):
        p, off = carry
        done = (p % ratio_u) == 0
        _, lf = rank_ops.letter_and_lf_at(dev, p)
        p2 = jnp.where(done, p, lf)
        off2 = jnp.where(done, off, off + jnp.uint32(1))
        return (p2, off2), None

    (p, off), _ = jax.lax.scan(step, (positions, offsets), None, length=n_steps)
    return p, off


@functools.partial(jax.jit, static_argnames=("seg",))
def _backtrace_steps_fused(dev, p, off, *, seg):
    """`seg` masked LF steps in one program (step-loop variant)."""
    ratio_u = jnp.uint32(dev.ratio)
    for _ in range(seg):
        done = (p % ratio_u) == 0
        _, lf = rank_ops.letter_and_lf_at(dev, p)
        p = jnp.where(done, p, lf)
        off = jnp.where(done, off, off + jnp.uint32(1))
    return p, off


@functools.partial(jax.jit, static_argnames=("off_bits",))
def _bt_routed_pack(p, off, *, off_bits):
    """(p, packed) for the routed backtrace: packed = orig<<off_bits | off.

    Walk offsets are NOT bounded by dev.ratio - 1 (sampling is by BWT
    position; see _backtrace_steps_any) — the real invariant is
    off <= prior_steps + n_steps, the schedule's static total step
    count, from which the caller derives ``off_bits``. Offsets live in
    the low ``off_bits``; the origin index rides the high bits and a
    single final key-sort on ``packed`` restores the caller's order AND
    yields off with no extra payload. Guarded by the caller:
    bits(batch-1) + off_bits <= 32."""
    orig = jnp.arange(p.shape[0], dtype=jnp.uint32)
    return p, (orig << jnp.uint32(off_bits)) | off


@functools.partial(jax.jit, static_argnames=("off_bits",))
def _bt_routed_restore(p, packed, *, off_bits):
    packed, p = lax.sort((packed, p), num_keys=1, is_stable=False)
    return p, packed & jnp.uint32((1 << off_bits) - 1)


@functools.partial(jax.jit, static_argnames=("seg", "plan"))
def _backtrace_steps_fused_routed(dev, p, packed, *, seg, plan):
    """`seg` masked LF steps with slab-routed row gathers (ops/route.py).

    Positions change every LF step, so each step re-sorts — but ONLY a
    two-operand key sort (p, packed): the state stays permuted across
    steps and segments, and `_bt_routed_restore` unpermutes once at the
    very end (per-step restore sorts measured away the routed win;
    ngram.ngram_backward_step_pair_routed docstring). Rows whose slab
    run overflowed the plan's cap simply do not advance this step
    (covered=False); backtrace_all's exactness net finishes any such
    stragglers, so results equal _backtrace_steps_fused after restore
    + net.

    DONE rows sort LAST under a sentinel key (their gather lands on the
    clamped last row and is discarded by the step mask, exactly like an
    uncovered row). Sorting them by their frozen position instead once
    made genome-scale locate several times slower: enumerate pads
    freeze ~65K rows at position 0 — more than slab 0's entire cap
    window — so every REAL slab-0 row came back covered=False in every
    segment and the full-batch while_loop net re-walked them one LF
    step at a time. The sentinel costs one more sort operand.
    """
    from .ops import route as route_ops

    ratio_u = jnp.uint32(dev.ratio)
    for _ in range(seg):
        key = jnp.where(
            (p % ratio_u) == 0, jnp.uint32(0xFFFFFFFF), p
        )
        key, p, packed = lax.sort(
            (key, p, packed), num_keys=1, is_stable=False
        )
        blk = (key // jnp.uint32(rank_ops.POSITIONS_PER_BLOCK)).astype(
            jnp.int32
        )
        rows, covered = route_ops.routed_gather(dev.packed, blk, plan)
        local = (p % jnp.uint32(rank_ops.POSITIONS_PER_BLOCK)).astype(
            jnp.int32
        )
        _, lf = rank_ops.letter_and_lf_from_rows(dev, rows, local)
        step = covered & ((p % ratio_u) != 0)
        p = jnp.where(step, lf, p)
        packed = jnp.where(step, packed + jnp.uint32(1), packed)
    return p, packed


@functools.partial(jax.jit, static_argnames=("seg",))
def _backtrace_steps_fused_packed(dev, p, packed, *, seg):
    """`seg` masked LF steps carrying the (orig<<off_bits | off) payload.

    The mono-gather counterpart of _backtrace_steps_fused_routed for
    permuted-space levels BELOW the routing break-even: no sort, plain
    gather, the walk count rides the packed low bits."""
    ratio_u = jnp.uint32(dev.ratio)
    for _ in range(seg):
        done = (p % ratio_u) == 0
        _, lf = rank_ops.letter_and_lf_at(dev, p)
        p = jnp.where(done, p, lf)
        packed = jnp.where(done, packed, packed + jnp.uint32(1))
    return p, packed


@jax.jit
def _bt_boundary_sort(dev, p, packed):
    """Sentinel-key sort: undone rows first (by position), done last.

    Valid because every live position is < bwtLength < 2^32 on the
    narrow path, so 0xFFFFFFFF strictly exceeds any undone key — after
    this sort the undone set is EXACTLY the array prefix."""
    key = jnp.where(
        (p % jnp.uint32(dev.ratio)) == 0, jnp.uint32(0xFFFFFFFF), p
    )
    _, p, packed = lax.sort((key, p, packed), num_keys=1, is_stable=False)
    return p, packed


@functools.partial(jax.jit, static_argnames=("max_it",))
def _backtrace_carry_packed_bounded(dev, p, packed, *, max_it):
    """Masked while_loop finisher in packed space, iteration-capped.

    The cap keeps the off field from overflowing into the origin bits
    (off <= scheduled_steps + max_it < 2^off_bits by construction); a
    row still unsampled at the cap — probability ~(1-1/r)^max_it, i.e.
    ~1e-29 per row at r=8, off_bits=9 — is finished exactly by the
    caller's unpacked final net."""
    ratio_u = jnp.uint32(dev.ratio)

    def cond(state):
        pp, _, it = state
        return (~jnp.all((pp % ratio_u) == 0)) & (it < jnp.uint32(max_it))

    def body(state):
        pp, pk, it = state
        done = (pp % ratio_u) == 0
        _, lf = rank_ops.letter_and_lf_at(dev, pp)
        return (
            jnp.where(done, pp, lf),
            jnp.where(done, pk, pk + jnp.uint32(1)),
            it + jnp.uint32(1),
        )

    p, packed, _ = jax.lax.while_loop(
        cond, body, (p, packed, jnp.uint32(0))
    )
    return p, packed


def _try_backtrace_all_permuted(dev, positions):
    """Permuted sliced-compaction backtrace for the routed regime.

    The routed step already sentinel-sorts every step (done rows last),
    so compaction in permuted space is ONE more sentinel sort at the
    level boundary plus a PREFIX SLICE — replacing the unpermuted
    driver's cumsum + scatter + payload gathers per level — and
    reassembly is a contiguous dynamic_update_slice instead of scatters. State stays
    (p, orig<<off_bits | off) end to end; ONE restore sort at the end.

    Exactness contract is unchanged: statistically truncated rows stay
    in the parent prefix region unstepped, cap-overflow (covered=False)
    rows never advance, the packed straggler loop is iteration-capped
    against off-field overflow — and the final UNPACKED while_loop net
    finishes all of them exactly (same net as the unpermuted driver).

    Returns None (caller falls back) when routing is off/ineligible,
    the batch leaves no room for the off field (off_bits < 8), or the
    schedule creates no compaction level. Opt out: AWFM_BT_PERMUTED=0.
    """
    from .ops import route as route_ops

    b = positions.shape[0]
    nb, rb = dev.packed.shape[0], dev.packed.shape[1]
    if route_ops.plan_for(nb, rb, b) is None:
        return None
    off_bits = 32 - max(0, b - 1).bit_length()
    first_seg, level_seg, slack, min_level, _ = _bt_schedule(dev.ratio)
    if not os.environ.get("AWFM_BT_LEVEL_SEG"):
        # sliced compaction costs ~one sort, so shorter levels cut the
        # masked overwalk where the unpermuted driver's cumsum+scatter
        # compaction made them uneconomical (level_seg = ratio; not
        # measured on the H100).
        # The unpermuted/wide drivers keep the 2*ratio default.
        level_seg = dev.ratio
    surv_first = (1.0 - 1.0 / dev.ratio) ** first_seg
    surv_level = (1.0 - 1.0 / dev.ratio) ** level_seg
    sizes = []
    cur = b
    m = _round_up(int(b * surv_first * (100 + slack) / 100), 256)
    while m >= min_level and m < cur:
        sizes.append(m)
        cur = m
        m = _round_up(int(m * surv_level * (100 + slack) / 100), 256)
    total_steps = first_seg + level_seg * len(sizes)
    if not sizes or off_bits < 8 or total_steps >= (1 << off_bits) - 1:
        return None
    fuse = _fuse_backtrace()

    def run_seg(p, packed, n_steps, batch):
        plan = route_ops.plan_for(nb, rb, batch)
        done = 0
        while done < n_steps:
            seg = min(fuse, n_steps - done)
            if plan is not None:
                p, packed = _backtrace_steps_fused_routed(
                    dev, p, packed, seg=seg, plan=plan
                )
            else:
                p, packed = _backtrace_steps_fused_packed(
                    dev, p, packed, seg=seg
                )
            done += seg
        return p, packed

    p, packed = _bt_routed_pack(
        positions, jnp.zeros_like(positions), off_bits=off_bits
    )
    p, packed = run_seg(p, packed, first_seg, b)
    parents = []
    for m in sizes:
        p, packed = _bt_boundary_sort(dev, p, packed)
        parents.append((p, packed))
        p, packed = run_seg(p[:m], packed[:m], level_seg, m)
    max_it = (1 << off_bits) - 1 - total_steps
    p, packed = _backtrace_carry_packed_bounded(
        dev, p, packed, max_it=max_it
    )
    for par_p, par_packed in reversed(parents):
        p = lax.dynamic_update_slice(par_p, p, (jnp.int32(0),))
        packed = lax.dynamic_update_slice(
            par_packed, packed, (jnp.int32(0),)
        )
    p, off = _bt_routed_restore(p, packed, off_bits=off_bits)
    return _backtrace_to_sampled_carry(dev, p, off)


def _fuse_backtrace() -> int:
    """LF steps fused per dispatched program in the backtrace loop.

    Fused LF chains are simple single-gather programs and amortize
    dispatch overhead; default 8 (not measured on the H100).
    """
    import os

    return max(1, int(os.environ.get("AWFM_FUSE_BACKTRACE", "8")))


# -- pair-LF backtrace (two LF steps per gather; ops/bt_digram.py) ----------

def _pair_step_body(bt, p, off, ratio_u):
    """One masked pair step: advance to LF(p) if sampled there, else
    LF2(p) — the exact two-iteration unroll of the reference walk
    (stop checks in chain order: p, LF(p), then continue from LF2(p))."""
    done = (p % ratio_u) == 0
    lf1, lf2 = bt_ops.pair_lf_at(bt, p)
    take1 = (lf1 % ratio_u) == 0
    p2 = jnp.where(take1, lf1, lf2)
    o2 = jnp.where(take1, off + jnp.uint32(1), off + jnp.uint32(2))
    return jnp.where(done, p, p2), jnp.where(done, off, o2)


@functools.partial(jax.jit, static_argnames=("ratio", "n_steps"))
def _backtrace_pair_steps(bt, p, off, *, ratio, n_steps):
    """n_steps masked pair steps (fixed-trip scan; CPU path)."""
    ratio_u = jnp.uint32(ratio)

    def step(carry, _):
        return _pair_step_body(bt, *carry, ratio_u), None

    (p, off), _ = jax.lax.scan(step, (p, off), None, length=n_steps)
    return p, off


@functools.partial(jax.jit, static_argnames=("ratio", "seg"))
def _backtrace_pair_steps_fused(bt, p, off, *, ratio, seg):
    """`seg` masked pair steps in one program (step-loop variant)."""
    ratio_u = jnp.uint32(ratio)
    for _ in range(seg):
        p, off = _pair_step_body(bt, p, off, ratio_u)
    return p, off


def _fuse_backtrace_pair() -> int:
    """Pair steps fused per dispatched program (2 LF steps each)."""
    import os

    return max(1, int(os.environ.get("AWFM_FUSE_BACKTRACE_PAIR", "4")))


def _backtrace_steps_any(dev, p, off, n_steps, bt=None, prior_steps=None):
    """n_steps masked LF steps, in fused per-dispatch groups.

    With a BacktraceDigramIndex (``bt``), executes ceil(n/2) pair steps —
    covering at least n_steps LF steps; overshooting is harmless because
    done rows never move.

    ``prior_steps``: static upper bound on the incoming offsets (the
    schedule's cumulative step count so far). Walk lengths are NOT
    bounded by ratio — sampling is by BWT position, so a walk ends only
    when it lands on a multiple of ratio — but off can never exceed the
    total steps executed, which the sync-free schedule knows statically.
    The slab-routed formulation packs off into the low bits of its sort
    payload and therefore requires it; None (unknown caller) disables
    routing rather than risk the pack overflowing into the origin bits."""
    if bt is not None:
        pair_steps = (n_steps + 1) // 2
        if _use_step_loop():
            fuse = _fuse_backtrace_pair()
            done_steps = 0
            while done_steps < pair_steps:
                seg = min(fuse, pair_steps - done_steps)
                p, off = _backtrace_pair_steps_fused(
                    bt, p, off, ratio=dev.ratio, seg=seg
                )
                done_steps += seg
            return p, off
        return _backtrace_pair_steps(
            bt, p, off, ratio=dev.ratio, n_steps=pair_steps
        )
    # slab-routed LF gathers past the big-table wall (ops/route.py);
    # trace-time decision from the table and (static) batch shapes
    from .ops import route as route_ops

    plan = route_ops.plan_for(
        dev.packed.shape[0], dev.packed.shape[1], p.shape[0]
    )
    off_bits = (
        max(1, int(prior_steps + n_steps).bit_length())
        if prior_steps is not None
        else 33  # unknown incoming offsets: never pack
    )
    if (
        plan is not None
        and off_bits <= 31
        and max(0, p.shape[0] - 1).bit_length() + off_bits > 32
    ):
        # batch too big for the (orig|off) u32 pack (multihit locate
        # walks tens of millions of hits): route each max-size slice
        # independently — same exactness story per slice, one extra
        # compile shape for the remainder
        max_b = 1 << (32 - off_bits)
        if route_ops.plan_for(
            dev.packed.shape[0], dev.packed.shape[1], max_b
        ) is not None:
            ps, offs = [], []
            for lo in range(0, p.shape[0], max_b):
                sp, so = _backtrace_steps_any(
                    dev, p[lo : lo + max_b], off[lo : lo + max_b],
                    n_steps, bt, prior_steps,
                )
                ps.append(sp)
                offs.append(so)
            return jnp.concatenate(ps), jnp.concatenate(offs)
    if plan is not None and (
        max(0, p.shape[0] - 1).bit_length() + off_bits <= 32
    ):
        fuse = _fuse_backtrace()
        p, packed = _bt_routed_pack(p, off, off_bits=off_bits)
        done_steps = 0
        while done_steps < n_steps:
            seg = min(fuse, n_steps - done_steps)
            p, packed = _backtrace_steps_fused_routed(
                dev, p, packed, seg=seg, plan=plan
            )
            done_steps += seg
        return _bt_routed_restore(p, packed, off_bits=off_bits)
    if _use_step_loop():
        fuse = _fuse_backtrace()
        done_steps = 0
        while done_steps < n_steps:
            seg = min(fuse, n_steps - done_steps)
            p, off = _backtrace_steps_fused(dev, p, off, seg=seg)
            done_steps += seg
        return p, off
    return _backtrace_steps(dev, p, off, n_steps=n_steps)


@jax.jit
def _undone_count(dev, p):
    """Diagnostic helper for schedule experiments; the production
    backtrace_all is sync-free and never consults it."""
    return jnp.sum((p % jnp.uint32(dev.ratio)) != 0, dtype=jnp.int32)


def _mask_pad_slots(p, off, idx, b):
    """Pad slots (idx == b, one past the parent batch) become DONE
    sentinels: position 0 (sampled — walks nothing) with idx out of
    bounds so `_scatter_back` drops them. They used to duplicate row 0
    instead; when row 0 was undone, tens of thousands of copies of ONE
    position walked every level in lockstep — harmless for the mono
    gather, but a deterministic cap-overflow bomb for the slab-routed
    one (any shared slab run blows the static cap and crowds REAL rows
    into the exactness net)."""
    pad = idx >= jnp.int32(b)
    safe = jnp.where(pad, jnp.int32(0), idx)
    return (
        idx,
        jnp.where(pad, jnp.uint32(0), p[safe]),
        jnp.where(pad, jnp.uint32(0), off[safe]),
    )


@functools.partial(jax.jit, static_argnames=("m",))
def _gather_undone(dev, p, off, *, m):
    b = p.shape[0]
    idx = jnp.nonzero(
        (p % jnp.uint32(dev.ratio)) != 0, size=m, fill_value=b
    )[0].astype(jnp.int32)
    return _mask_pad_slots(p, off, idx, b)


@functools.partial(jax.jit, static_argnames=("m",))
def _gather_undone_cumsum(dev, p, off, *, m):
    """Same contract as _gather_undone via cumsum + drop-mode scatter
    (padded slots are dropped done-sentinels; _mask_pad_slots). This is
    the production DEFAULT compaction (not measured against XLA's sized
    nonzero on the H100); AWFM_BT_COMPACT=nonzero opts back."""
    b = p.shape[0]
    mask = (p % jnp.uint32(dev.ratio)) != 0
    pos = jnp.cumsum(mask.astype(jnp.int32)) - 1
    src = jnp.where(mask, pos, m)  # done rows scatter out of bounds
    idx = (
        jnp.full((m,), b, dtype=jnp.int32)
        .at[src]
        .set(jnp.arange(b, dtype=jnp.int32), mode="drop")
    )
    return _mask_pad_slots(p, off, idx, b)


def _bt_schedule(ratio: int):
    """Backtrace compaction schedule (read per call; all settings keep
    the result EXACT — the final while_loop net catches statistical
    truncation of any level). The defaults won an earlier on-accelerator
    sweep; they are not measured on the H100:

      AWFM_BT_FIRST_SEG  LF steps before the first compaction
                         (default: ratio)
      AWFM_BT_LEVEL_SEG  LF steps walked per compacted level
                         (default: 2*ratio — half the compaction
                         passes; the walked arrays are already small)
      AWFM_BT_SLACK      percent headroom over the expected binomial
                         survival when sizing a level (default 8;
                         3-sigma-safe down to 4096-row levels, and
                         truncation costs exactness-net iterations,
                         not correctness)
      AWFM_BT_COMPACT    'cumsum' (default: cumsum + drop-mode scatter)
                         or 'nonzero' (XLA sized nonzero)
      AWFM_BT_MIN_LEVEL  smallest compaction level; below this the
                         stragglers finish in a masked while_loop
                         (default 4096)

    Returns (first_seg, level_seg, slack, min_level, compact_mode);
    compact_mode is the string name so the narrow AND wide drivers map
    it to their own gather implementations without re-parsing the env.
    """
    first_seg = int(os.environ.get("AWFM_BT_FIRST_SEG", "0")) or ratio
    level_seg = int(os.environ.get("AWFM_BT_LEVEL_SEG", "0")) or 2 * ratio
    slack = int(os.environ.get("AWFM_BT_SLACK", "8"))
    min_level = int(os.environ.get("AWFM_BT_MIN_LEVEL", "4096"))
    compact_mode = (
        "nonzero" if os.environ.get("AWFM_BT_COMPACT") == "nonzero"
        else "cumsum"
    )
    return first_seg, level_seg, slack, min_level, compact_mode


@jax.jit
def _scatter_back(p, off, idx, sub_p, sub_off):
    # pad slots carry idx == parent batch size: dropped explicitly
    return (
        p.at[idx].set(sub_p, mode="drop"),
        off.at[idx].set(sub_off, mode="drop"),
    )


@jax.jit
def _backtrace_to_sampled_carry(dev, p, off):
    """Masked while_loop finisher carrying existing offsets.

    On-device and sync-free; exits after ONE cond eval (no gathers)
    when every row is already sampled."""
    ratio_u = jnp.uint32(dev.ratio)

    def cond(state):
        pp, _ = state
        return ~jnp.all((pp % ratio_u) == 0)

    def body(state):
        pp, oo = state
        done = (pp % ratio_u) == 0
        _, lf = rank_ops.letter_and_lf_at(dev, pp)
        return (
            jnp.where(done, pp, lf),
            jnp.where(done, oo, oo + jnp.uint32(1)),
        )

    return jax.lax.while_loop(cond, body, (p, off))


def backtrace_all(dev, positions, bt=None):
    """Backtrace a device batch to sampled positions: (p, off).

    Expected chain length is ~ratio but the max over a large batch is
    ~ratio*ln(B); a plain masked while_loop therefore pays ~10x the
    useful work re-scanning finished rows, while fixed full-batch passes
    overshoot for the ~34% of rows that survive the first ratio steps.

    This driver is fully SYNC-FREE (a host readback stalls the device
    queue, so the schedule never consults undone counts on the host):

      1. one ratio-step masked pass over the full batch
         (survival ~(1-1/r)^r ~ 34%);
      2. NESTED compaction: gather the statistically-sized undone set
         (expected binomial survival + slack — binomial 3-sigma at
         these sizes is <1%), walk more steps, and keep compacting the
         COMPACTED array — unlike scatter-every-round scheduling, the
         O(B) compaction cost shrinks with each level; schedule
         parameters (segment lengths, slack, compaction formulation,
         straggler threshold) are env-tunable, defaults from the
         sweep (_bt_schedule);
      3. the straggler tail finishes in an on-device masked while_loop;
      4. scatter each level back into its parent, innermost first;
      5. a final full-batch while_loop guarantees exactness against
         statistical truncation at any level — when nothing was
         truncated (the overwhelming case) it exits after one
         gather-free cond eval.

    Degenerate-case bound: truncation needs >45% of a level's rows to
    survive `seg` more steps, i.e. heavily DUPLICATED positions walking
    in lock-step (survival is binomial for distinct positions, and
    locate's range enumeration produces distinct positions by
    construction). If a caller does pass such a batch, the net finishes
    it exactly at O(B) gathers per remaining LF step
    (tests/test_locate.py::test_backtrace_truncation_net).

    ``bt``: optional pair-LF rows (ops/bt_digram.py) halving the gathers
    per level — opt-in, and not measured on the H100 (the pair kernel
    does more arithmetic per gather).
    """
    if dev.ratio == 1:
        # every BWT position is sampled: nothing to walk
        return positions, jnp.zeros_like(positions)
    if bt is None and os.environ.get("AWFM_BT_PERMUTED", "1") != "0":
        # routed regime: permuted sliced compaction (sort+slice levels,
        # contiguous reassembly, one restore sort) — see
        # _try_backtrace_all_permuted; None -> this unpermuted driver
        out = _try_backtrace_all_permuted(dev, positions)
        if out is not None:
            return out
    b = positions.shape[0]
    first_seg, level_seg, slack, min_level, compact_mode = _bt_schedule(
        dev.ratio
    )
    gather_undone = (
        _gather_undone if compact_mode == "nonzero" else _gather_undone_cumsum
    )
    zeros = jnp.zeros_like(positions)
    p, off = _backtrace_steps_any(
        dev, positions, zeros, first_seg, bt, prior_steps=0
    )
    # nested compaction levels, each sized at the expected binomial
    # survival of its parent (+slack%); survival after k masked steps
    # is (1 - 1/ratio)^k
    surv_first = (1.0 - 1.0 / dev.ratio) ** first_seg
    surv_level = (1.0 - 1.0 / dev.ratio) ** level_seg
    levels = []
    cur_p, cur_off = p, off
    m = _round_up(int(b * surv_first * (100 + slack) / 100), 256)
    steps_so_far = first_seg
    while m >= min_level and m < cur_p.shape[0]:
        idx, sub_p, sub_off = gather_undone(dev, cur_p, cur_off, m=m)
        sub_p, sub_off = _backtrace_steps_any(
            dev, sub_p, sub_off, level_seg, bt, prior_steps=steps_so_far
        )
        steps_so_far += level_seg
        levels.append((idx, cur_p, cur_off))
        cur_p, cur_off = sub_p, sub_off
        m = _round_up(int(m * surv_level * (100 + slack) / 100), 256)
    cur_p, cur_off = _backtrace_to_sampled_carry(dev, cur_p, cur_off)
    for idx, par_p, par_off in reversed(levels):
        cur_p, cur_off = _scatter_back(par_p, par_off, idx, cur_p, cur_off)
    if levels:
        # exactness net for statistical truncation; ~free when unneeded
        cur_p, cur_off = _backtrace_to_sampled_carry(dev, cur_p, cur_off)
    return cur_p, cur_off

@jax.jit
def _resolve_samples(dev, p, off):
    """hit = (SA[p / ratio] + offset) % bwtLength (AwFmSuffixArray.c:189-190).

    sa < bwtLength and off < bwtLength, so sa + off < 2 * bwtLength —
    but that sum can exceed 2^32 when bwtLength > 2^31, where a plain
    uint32 `%` computes the mod of the WRAPPED sum (the reference does
    this in u64). One conditional subtract with wrap detection is exact:
    if the u32 add wrapped, the true value is h + 2^32 and h - n (mod
    2^32) is the correct residue; otherwise subtract n iff h >= n.
    """
    sa_vals = dev.sampled_sa[(p // jnp.uint32(dev.ratio)).astype(jnp.int32)]
    n = jnp.uint32(dev.bwt_length)
    h = sa_vals + off
    over = (h < sa_vals) | (h >= n)
    return jnp.where(over, h - n, h)


@jax.jit
def _backtrace_resolve(dev, positions):
    """Single-program backtrace + resolve (for shard_map bodies)."""
    p, off = _backtrace_to_sampled(dev, positions)
    return _resolve_samples(dev, p, off)


@jax.jit
def _total_hits(start, end):
    """Exact sum of range lengths -> (2,) uint32 [wrap_count, low].

    total = wrap_count * 2^32 + low. A plain uint32 sum silently wraps
    past 2^32 total hits (e.g. a million high-frequency kmers over a
    genome), undersizing locate capacity; the wrap count is recovered
    from the uint32 cumsum (an overflow at element i shows as
    cs[i] < cs[i-1]), keeping the whole computation in 32-bit lanes.
    Combine with ``total_hits_host``.
    """
    valid = start <= end
    counts = jnp.where(valid, end - start + jnp.uint32(1), jnp.uint32(0))
    cs = jnp.cumsum(counts.astype(jnp.uint32))
    wraps = jnp.sum((cs[1:] < cs[:-1]).astype(jnp.uint32))
    return jnp.stack([wraps, cs[-1]])


def total_hits_host(start, end) -> int:
    """Exact total hit count of a device range batch as a python int."""
    hi_lo = np.asarray(_total_hits(start, end))
    return (int(hi_lo[0]) << 32) + int(hi_lo[1])


def enumerate_range_positions(start, end, *, capacity):
    """Flatten BWT ranges into per-hit positions, ON DEVICE.

    The reference enumerates ``range.startPtr + i`` per hit on the host
    (AwFmParallelSearch.c:315-341); pulling (start, end) off the device
    to do that would add a host round trip, so this builds the flat
    position list with a static-size ``jnp.repeat`` instead.

    ``capacity`` must be >= the total hit count (get it from
    ``total_hits_host``; the call recompiles per distinct capacity, so
    round it up coarsely). Returns (positions, query_ids, valid_mask), each
    (capacity,); positions/query_ids beyond the total are 0-filled with
    valid_mask False. Hits appear grouped by query in range order —
    identical content and order to the reference's per-query
    positionList, keyed by query_ids.
    """
    mode = os.environ.get("AWFM_ENUM", "")
    if mode == "scatter" or os.environ.get("AWFM_ENUM_SCATTER", "0") == "1":
        return _enumerate_impl(start, end, capacity=capacity, scatter=True)
    if mode == "repeat":
        return _enumerate_impl(start, end, capacity=capacity, scatter=False)
    # default: delta formulation — ONE (capacity,) gather instead of
    # three. jnp.repeat lowers to scatter-marks + 2 cumsums + a take
    # (jax lax_numpy._repeat), and the repeat form then gathers
    # start[qid] and seg_off[qid] on top; folding start - seg_off into
    # a per-query delta BEFORE expansion leaves qid (the cumsum of the
    # scattered marks, no take) plus a single delta[qid] gather.
    # Bit-identical by construction in u32 (delta wraps mod 2^32 when
    # seg_off > start, the +iota unwraps).
    return _enumerate_delta(start, end, capacity=capacity)


@functools.partial(jax.jit, static_argnames=("capacity",))
def _enumerate_delta(start, end, *, capacity):
    assert capacity < 2**31, "capacity must fit int32 repeat lengths"
    b = start.shape[0]
    if b == 0:
        # delta[qid] below would gather from an empty operand
        z = jnp.zeros(capacity, dtype=jnp.uint32)
        return z, z.astype(jnp.int32), jnp.zeros(capacity, dtype=bool)
    valid = start <= end
    counts = jnp.minimum(
        jnp.where(valid, end - start + jnp.uint32(1), jnp.uint32(0)),
        jnp.uint32(capacity),
    ).astype(jnp.int32)
    seg_off = jnp.cumsum(counts) - counts  # exclusive prefix sum
    delta = start - seg_off.astype(jnp.uint32)  # wraps; +iota unwraps
    marks = (
        jnp.zeros(capacity, dtype=jnp.int32)
        .at[seg_off]
        .add(1, mode="drop")
    )
    # zero-count queries stack their mark on the NEXT query's start, so
    # the cumsum skips their ids in one step (same trick as the scatter
    # form below); subtracting the count-0 stack keeps qid exact
    qid = jnp.cumsum(marks) - 1
    iota = jnp.arange(capacity, dtype=jnp.uint32)
    mask = iota < jnp.sum(counts, dtype=jnp.int32).astype(jnp.uint32)
    pos = jnp.where(mask, iota + delta[qid], jnp.uint32(0))
    return pos, jnp.where(mask, qid, jnp.int32(0)), mask


@functools.partial(jax.jit, static_argnames=("capacity", "scatter"))
def _enumerate_impl(start, end, *, capacity, scatter):
    assert capacity < 2**31, "capacity must fit int32 repeat lengths"
    b = start.shape[0]
    valid = start <= end
    # clamp per-range counts at capacity BEFORE the int32 cast: a count
    # >= 2^31 (possible on a >2 Gbase near-mono corpus) would wrap
    # negative and corrupt the repeat/cumsum assembly; a violated
    # capacity precondition now degrades to masked truncation instead
    counts = jnp.minimum(
        jnp.where(valid, end - start + jnp.uint32(1), jnp.uint32(0)),
        jnp.uint32(capacity),
    ).astype(jnp.int32)
    seg_off = jnp.cumsum(counts) - counts  # exclusive prefix sum
    if scatter:
        # scatter-marks + cumsum: add one mark per query at its segment
        # start (zero-count queries stack on the next start — the
        # cumsum then skips their ids in one step), so qid needs no
        # repeat/searchsorted machinery. Bit-identical to the repeat
        # form (tests/test_locate.py::test_enumerate_formulations).
        marks = (
            jnp.zeros(capacity, dtype=jnp.int32)
            .at[seg_off]
            .add(1, mode="drop")
        )
        qid = jnp.cumsum(marks) - 1
    else:
        # ONE repeat materializes the query ids; the per-hit range
        # start and segment offset are then (capacity,) gathers through
        # qid — cheaper than three independent repeats
        qid = jnp.repeat(
            jnp.arange(b, dtype=jnp.int32), counts,
            total_repeat_length=capacity,
        )
    iota = jnp.arange(capacity, dtype=jnp.uint32)
    mask = iota < jnp.sum(counts, dtype=jnp.int32).astype(jnp.uint32)
    pos = jnp.where(
        mask,
        start[qid] + (iota - seg_off.astype(jnp.uint32)[qid]),
        jnp.uint32(0),
    )
    return pos, jnp.where(mask, qid, jnp.int32(0)), mask


def locate_flat_device(dev, start, end, *, capacity, bt=None):
    """Full-hit-list locate staying on device end to end.

    enumerate -> compacting backtrace -> sampled-SA resolve; the
    device-batched equivalent of AwFmParallelSearch.c:315-365 over every
    position of every range. Returns (hits, query_ids, valid_mask), each
    (capacity,) on device; masked-off entries resolve position 0 and
    must be ignored. ``bt``: optional pair-LF rows (ops/bt_digram.py)
    halving the backtrace gathers.
    """
    pos, qid, mask = enumerate_range_positions(start, end, capacity=capacity)
    p, off = backtrace_all(dev, pos, bt)
    return _resolve_samples(dev, p, off), qid, mask


# ---------------------------------------------------------------------------
# Host-side engine
# ---------------------------------------------------------------------------

class SearchEngine:
    """Batched count/locate over a device-resident FM index."""

    def __init__(self, index: Union[FmIndex, DeviceIndex]):
        if isinstance(index, FmIndex):
            self.host_index = index
            self.dev = index.to_device()
        else:
            self.host_index = None
            self.dev = index
        # 64-bit-capacity device view (ops/rank64.DeviceIndex64)?
        self.wide = not isinstance(self.dev, DeviceIndex)
        self._ascii_lut = (
            alpha.AA_ASCII_TO_INDEX
            if self.dev.alphabet == AlphabetType.AMINO
            else alpha.NT_ASCII_TO_INDEX
        )
        self._bt_cache = None

    def _bt_digram(self):
        """Lazily built pair-LF backtrace rows (ops/bt_digram.py).

        OPT-IN via AWFM_BT_DIGRAM=1 (nucleotide + uint32 capacity only;
        needs the host BWT to build). Halves the LF-walk gathers at the
        cost of more arithmetic per gather; it exists for gather-bound
        genome-scale locate workloads and is not measured on the H100.
        Results are bit-identical either way."""
        import os

        if (
            self.wide
            or self.host_index is None
            or self.dev.alphabet == AlphabetType.AMINO
            or os.environ.get("AWFM_BT_DIGRAM", "0") != "1"
        ):
            return None
        if self._bt_cache is None:
            self._bt_cache = bt_ops.build_backtrace_digram_device(
                self.host_index
            )
        return self._bt_cache

    # -- encoding -----------------------------------------------------------

    def encode_kmers(self, kmers: Sequence[Union[str, bytes]]):
        """ASCII kmers -> (padded letter-index matrix, lengths).

        Pads the batch to a power-of-two size and the length axis to a
        multiple of 4 to bound jit recompiles.

        Uniform-length bytes batches (the overwhelmingly common case)
        take a vectorized path — one LUT gather over the joined buffer —
        instead of a per-kmer Python loop (~40x faster at 1M kmers).
        """
        n = len(kmers)
        if n == 0:
            raise ValueError("kmers must be non-empty")
        if all(type(k) is bytes for k in kmers):
            lengths = np.fromiter(map(len, kmers), dtype=np.int32, count=n)
            if lengths.min() < 1:
                raise ValueError("kmers must be non-empty")
            if (lengths == lengths[0]).all():
                length = int(lengths[0])
                flat = np.frombuffer(b"".join(kmers), dtype=np.uint8)
                rows = self._ascii_lut[flat].reshape(n, length)
                b_pad = _round_up_pow2(n)
                l_pad = _round_up(length, 4)
                mat = np.zeros((b_pad, l_pad), dtype=np.uint8)
                mat[:n, :length] = rows
                # pad rows are 'A'*length (letter 0), sharing the real
                # kmers' length/eligibility like the general path below
                lengths_padded = np.full(b_pad, length, dtype=np.int32)
                return mat, lengths_padded, n
        encoded = [
            self._ascii_lut[np.frombuffer(
                k.encode() if isinstance(k, str) else k, dtype=np.uint8
            )]
            for k in kmers
        ]
        lengths = np.array([len(e) for e in encoded], dtype=np.int32)
        if lengths.min() < 1:
            raise ValueError("kmers must be non-empty")
        b_pad = _round_up_pow2(len(encoded))
        l_pad = _round_up(int(lengths.max()), 4)
        mat = np.zeros((b_pad, l_pad), dtype=np.uint8)
        for i, e in enumerate(encoded):
            mat[i, : len(e)] = e
        # pad rows mimic the first real kmer's length ('A'*L content) so
        # they share its seed eligibility and batch uniformity — a pad
        # length of 1 would force a pointless mixed seeded/unseeded
        # partition on every non-power-of-two batch
        lengths_padded = np.full(b_pad, lengths[0], dtype=np.int32)
        lengths_padded[: len(lengths)] = lengths
        return mat, lengths_padded, len(kmers)

    def _seed_eligibility(self, mat: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """awFmQueryCanUseKmerTable (AwFmKmerTable.c:4-19).

        Eligible iff length >= k and no ambiguity letter in the LAST k
        letters. Operates on letter indices: ambiguity == cardinality.
        """
        k = self.dev.kmer_length_in_seed_table
        card = self.dev.cardinality
        b, l = mat.shape
        ok_len = lengths >= k
        idxs = np.clip(lengths[:, None] - k + np.arange(k)[None, :], 0, l - 1)
        last_k = np.take_along_axis(mat, idxs, axis=1)
        no_ambig = (last_k < card).all(axis=1)
        return ok_len & no_ambig

    # -- range search -------------------------------------------------------

    def find_ranges_encoded(self, mat: np.ndarray, lengths: np.ndarray) -> np.ndarray:
        """Final BWT ranges for an encoded batch -> (B, 2) uint64 host array."""
        dev = self.dev
        k = dev.kmer_length_in_seed_table
        eligible = self._seed_eligibility(mat, lengths)
        start = np.empty(mat.shape[0], dtype=np.uint64)
        end = np.empty(mat.shape[0], dtype=np.uint64)

        def run(sub_mat, sub_len, seeded: bool):
            b_pad = _round_up_pow2(sub_mat.shape[0])
            if b_pad != sub_mat.shape[0]:
                pad = b_pad - sub_mat.shape[0]
                sub_mat = np.pad(sub_mat, ((0, pad), (0, 0)))
                # pad with the max real length: keeps uniform batches
                # uniform (the step-loop's unmasked fast path); padded
                # rows are zeros ('A'*L) and their results are dropped
                sub_len = np.pad(
                    sub_len, (0, pad),
                    constant_values=max(int(sub_len.max()), max(1, k)),
                )
            if self.wide:
                from . import search64

                r = search64.ranges64(dev, sub_mat, sub_len, seeded)
                return r[:, 0], r[:, 1]
            if _use_step_loop():
                # fold the pair-window flag check into the ONE result
                # readback (defer protocol): the common clean batch pays
                # a single host sync for flags + start + end together
                pend = []
                s, e = _ranges_steploop(
                    dev, sub_mat, sub_len, seeded, defer=pend
                )
                flat = np.asarray(
                    jnp.concatenate(
                        [c[None].astype(jnp.uint32) for c, _ in pend]
                        + [s, e]
                    )
                )
                nf = len(pend)
                if nf and flat[:nf].any():
                    s, e = pend[0][1]()  # rare: exact re-run of flagged
                    return (
                        np.asarray(s, dtype=np.uint64),
                        np.asarray(e, dtype=np.uint64),
                    )
                b = s.shape[0]
                return (
                    flat[nf : nf + b].astype(np.uint64),
                    flat[nf + b :].astype(np.uint64),
                )
            elif seeded:
                s, e = _seeded_ranges(
                    dev, jnp.asarray(sub_mat), jnp.asarray(sub_len),
                    n_ext=max(0, sub_mat.shape[1] - k),
                )
            else:
                s, e = _unseeded_ranges(
                    dev, jnp.asarray(sub_mat), jnp.asarray(sub_len),
                    n_steps=sub_mat.shape[1] - 1,
                )
            return np.asarray(s, dtype=np.uint64), np.asarray(e, dtype=np.uint64)

        if eligible.all():
            start, end = run(mat, lengths, True)
        elif not eligible.any():
            start, end = run(mat, lengths, False)
        else:
            idx_e = np.where(eligible)[0]
            idx_u = np.where(~eligible)[0]
            s, e = run(mat[idx_e], lengths[idx_e], True)
            start[idx_e], end[idx_e] = s[: len(idx_e)], e[: len(idx_e)]
            s, e = run(mat[idx_u], lengths[idx_u], False)
            start[idx_u], end[idx_u] = s[: len(idx_u)], e[: len(idx_u)]
        return np.stack([start[: mat.shape[0]], end[: mat.shape[0]]], axis=1)

    def find_ranges(self, kmers: Sequence[Union[str, bytes]]) -> np.ndarray:
        mat, lengths, n = self.encode_kmers(kmers)
        return self.find_ranges_encoded(mat, lengths)[:n]

    # -- public count / locate ---------------------------------------------

    def count(self, kmers: Sequence[Union[str, bytes]]) -> np.ndarray:
        """Occurrences of each kmer (awFmParallelSearchCount parity)."""
        from .utils import metrics

        metrics.counter("search.count.queries").add(len(kmers))
        with metrics.timer("search.count.seconds"):
            ranges = self.find_ranges(kmers)
        s, e = ranges[:, 0], ranges[:, 1]
        return np.where(s <= e, e - s + 1, 0).astype(np.uint64)

    def locate(self, kmers: Sequence[Union[str, bytes]]) -> List[np.ndarray]:
        """Database hit positions per kmer (awFmParallelSearchLocate parity).

        Returns, for each kmer, the positions in range order — identical
        content and order to the reference's positionList.
        """
        from .utils import metrics

        metrics.counter("search.locate.queries").add(len(kmers))
        with metrics.timer("search.locate.seconds"):
            ranges = self.find_ranges(kmers)
            s, e = ranges[:, 0], ranges[:, 1]
            counts = np.where(s <= e, e - s + 1, 0).astype(np.int64)
            flat = self._flat_positions(s, counts)
            hits = self.resolve_positions(flat)
        metrics.counter("search.locate.hits").add(int(counts.sum()))
        splits = np.cumsum(counts)[:-1]
        return [h for h in np.split(hits, splits)]

    @staticmethod
    def _flat_positions(starts: np.ndarray, counts: np.ndarray) -> np.ndarray:
        total = int(counts.sum())
        if total == 0:
            return np.empty(0, dtype=np.uint64)
        base = np.repeat(starts.astype(np.uint64), counts)
        within = np.arange(total, dtype=np.uint64) - np.repeat(
            np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.uint64), counts
        )
        return base + within

    def resolve_positions(self, bwt_positions: np.ndarray) -> np.ndarray:
        """Backtrace+resolve a flat array of BWT positions to hits."""
        dev = self.dev
        n = len(bwt_positions)
        if n == 0:
            return np.empty(0, dtype=np.uint64)
        if self.wide:
            from . import search64

            return search64.resolve_positions64(self, bwt_positions)
        out = np.empty(n, dtype=np.uint64)
        chunk = _BACKTRACE_CHUNK
        sa_on_disk = dev.sampled_sa is None
        if sa_on_disk:
            if self.host_index is None or self.host_index.file_path is None:
                raise ValueError(
                    "suffix array not in memory and no backing file to read "
                    "from (build or load the index with a file_src)"
                )
        bt = self._bt_digram()
        for lo in range(0, n, chunk):
            part = bwt_positions[lo : lo + chunk]
            pad_n = _round_up_pow2(len(part))
            padded = np.zeros(pad_n, dtype=np.uint32)
            padded[: len(part)] = part.astype(np.uint32)
            p, off = backtrace_all(dev, jnp.asarray(padded), bt)
            if sa_on_disk:
                hits = self._resolve_from_file(
                    np.asarray(p[: len(part)]), np.asarray(off[: len(part)])
                )
                out[lo : lo + len(part)] = hits
            else:
                hits = _resolve_samples(dev, p, off)
                out[lo : lo + len(part)] = np.asarray(
                    hits[: len(part)], dtype=np.uint64
                )
        return out

    def _resolve_from_file(self, sampled_positions, offsets) -> np.ndarray:
        """Resolve sampled-SA values from the index file — the on-disk
        suffix-array mode (awFmGetSuffixArrayValueFromFile,
        AwFmFile.c:484-522; applied at AwFmSuffixArray.c:192-202).

        Semantics are the reference's per-hit <=9-byte read, but executed
        as ONE vectorized gather over a read-only memmap of the packed-SA
        region: the OS page cache keeps only touched pages resident (the
        point of disk residency stands), while Python-loop overhead —
        ~10^3x the C pread it replaces — disappears. Falls back to the
        per-hit reader if the file cannot be memory-mapped."""
        from . import suffix_array as sa_mod
        from .io import awfmi

        index = self.host_index
        width = sa_mod.value_min_bit_width(index.bwt_length)
        file_offset = index.suffix_array_file_offset or awfmi.suffix_array_file_offset(
            index
        )
        bwt_length = index.bwt_length
        ratio = self.dev.ratio
        sample_idx = np.asarray(sampled_positions, dtype=np.uint64) // np.uint64(
            ratio
        )
        offsets = np.asarray(offsets, dtype=np.uint64)
        try:
            region_len = sa_mod.compressed_sa_size_in_bytes(bwt_length, ratio)
            mm = np.memmap(
                index.file_path, mode="r", offset=file_offset,
                shape=(region_len,), dtype=np.uint8,
            )
        except (OSError, ValueError):
            out = np.empty(len(sampled_positions), dtype=np.uint64)
            with open(index.file_path, "rb") as fh:
                for i, (si, off) in enumerate(zip(sample_idx, offsets)):
                    val = sa_mod.read_packed_value_from_file(
                        fh, file_offset, width, int(si)
                    )
                    out[i] = (val + int(off)) % bwt_length
            return out
        bit = sample_idx * np.uint64(width)
        byte_off = (bit >> np.uint64(3)).astype(np.int64)
        bit_off = (bit & np.uint64(7)).astype(np.uint64)
        # gather 9 bytes per hit (max span of width<=57+7 bits; wider
        # values reassemble from two u64 reads like AwFmFile.c:506-517)
        spans = byte_off[:, None] + np.arange(9, dtype=np.int64)[None, :]
        raw = np.asarray(mm[np.minimum(spans, region_len - 1)])
        del mm
        lo = raw[:, :8].copy().view("<u8")[:, 0] >> bit_off
        keep_lo = np.minimum(np.uint64(64) - bit_off, np.uint64(63))
        hi = raw[:, 8].astype(np.uint64) << keep_lo
        hi = np.where(bit_off == 0, np.uint64(0), hi)  # the 9th byte only
        # matters when bit_off > 0 (shift-by-64 would be undefined)
        vals = (lo | hi) & ((np.uint64(1) << np.uint64(width)) - np.uint64(1))
        return (vals + offsets) % np.uint64(bwt_length)


# ---------------------------------------------------------------------------
# n-step engine (ops/ngram.py)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("seg",))
def _ngram_steps_fused(ng, start, end, *letter_cols, seg):
    """`seg` consecutive n-gram steps in one program (letter columns
    flat, leftmost-first within each group, groups right-to-left)."""
    from .ops import ngram as ngram_ops

    n = ng.n
    for s in range(seg):
        letters = [
            letter_cols[s * n + j].astype(jnp.int32) for j in range(n)
        ]
        start, end = ngram_ops.ngram_backward_step(ng, start, end, letters)
    return start, end


@functools.partial(jax.jit, static_argnames=("seg",))
def _ngram_steps_fused_pair(ng, start, end, bad, *letter_cols, seg):
    """`seg` consecutive one-gather n-gram steps in one program."""
    from .ops import ngram as ngram_ops

    n = ng.n
    for s in range(seg):
        letters = [
            letter_cols[s * n + j].astype(jnp.int32) for j in range(n)
        ]
        start, end, bad = ngram_ops.ngram_backward_step_pair(
            ng, start, end, letters, bad
        )
    return start, end, bad


@functools.partial(jax.jit, static_argnames=("lo", "seg", "plan"))
def _ngram_steps_fused_pair_routed(ng, start, end, bad, orig, words_pk, *,
                                   lo, seg, plan):
    """`seg` one-gather n-gram steps with slab-routed row gathers on
    PERMUTED state (ngram_backward_step_pair_routed): ``orig`` tracks
    each row's original query id across segments and the caller
    restores once after the loop; ``words_pk`` carries every step's
    word value as a sort payload (step lo+s reads its own vbits)."""
    from .ops import ngram as ngram_ops

    for s in range(seg):
        start, end, bad, orig, words_pk = (
            ngram_ops.ngram_backward_step_pair_routed(
                ng, start, end, bad, orig, words_pk, lo + s, plan
            )
        )
    return start, end, bad, orig, words_pk


@functools.partial(jax.jit, static_argnames=("cols", "vbits"))
def _ngram_words_packed(mat, *, cols, vbits):
    """(B,) u32: every digram group's word value, packed vbits apiece
    (step t at bits [vbits*t, vbits*(t+1)); ``cols``: tuple of
    letter-column tuples, leftmost first; base-4 packing matches
    ngram_ops._word_value). Guarded by the caller: vbits*len(cols)
    <= 32."""
    n = len(cols[0])
    out = jnp.zeros(mat.shape[0], jnp.uint32)
    for t, group in enumerate(cols):
        v = None
        for j, c in enumerate(group):
            term = mat[:, c].astype(jnp.uint32) * jnp.uint32(
                4 ** (n - 1 - j)
            )
            v = term if v is None else v + term
        out = out | (v << jnp.uint32(vbits * t))
    return out


@jax.jit
def _ngram_restore_by_orig(orig, start, end, bad):
    _, start, end, bad8 = lax.sort(
        (orig, start, end, bad.astype(jnp.uint8)),
        num_keys=1, is_stable=False,
    )
    return start, end, bad8 != 0


@functools.partial(jax.jit, static_argnames=("seg",))
def _steps_fused(dev, start, end, *letter_cols, seg):
    """`seg` consecutive unmasked single steps in one program."""
    for s in range(seg):
        start, end = rank_ops.backward_step(
            dev, start, end, letter_cols[s].astype(jnp.int32)
        )
    return start, end


def _fuse_steps(alphabet=None) -> int:
    """Single-letter steps fused per dispatched program (step-loop path).

    Each extra fused step multiplies (one-time, cached) compile cost but
    divides the per-dispatch overhead. Defaults: 4 on DNA, and ONE
    program for amino's 15-step post-seed chains (small amino tables
    leave dispatch, not gather, as the binding constraint). Neither is
    measured on the H100.
    """
    import os

    env = os.environ.get("AWFM_FUSE_STEPS")
    if env:
        return max(1, int(env))
    return 15 if alphabet == AlphabetType.AMINO else 4


def _fuse_ngram() -> int:
    """n-gram steps fused per dispatched program.

    Default 1: fusing consecutive digram steps made XLA's code slower on
    the earlier accelerator; not measured on the H100.
    """
    import os

    return max(1, int(os.environ.get("AWFM_FUSE_NGRAM", "1")))


def _ngram_ranges_steploop(dev, ng, mat, *, kmer_len, seed_k, defer=None):
    """Host-driven n-step loop over a uniform-length clean batch.

    floor(m/n) n-gram steps right-to-left (static columns), then the
    m mod n leftmost letters as single steps; consecutive steps are
    grouped into fused programs of AWFM_FUSE_STEPS. Steps are one-gather
    pair steps when the pair tables are on; flagged queries re-run the
    exact two-gather loop.
    """
    n = ng.n
    m = kmer_len - seed_k
    fuse = _fuse_ngram()
    pair = _use_pair_rows(dev)
    # ONE bulk upload; per-step columns are then device slices
    mat = jnp.asarray(mat)
    start, end = _seed_lookup(dev, mat[:, kmer_len - seed_k : kmer_len])
    bad = jnp.zeros(mat.shape[0], dtype=bool)
    groups = [
        [m - n * (t + 1) + j for j in range(n)] for t in range(m // n)
    ]
    # slab-routed pair-row gathers past the big-table wall (ops/route.py):
    # state stays permuted across ALL digram segments (orig payload) and
    # is restored once before the tail/fixup
    from .ops import ngram as ngram_ops
    from .ops import route as route_ops

    plan = route_ops.plan_for(
        ng.packed.shape[0], ng.packed.shape[1], mat.shape[0]
    )
    vbits = ngram_ops.ngram_vbits(n)
    use_routed = (
        pair
        and plan is not None
        and bool(groups)
        and vbits * len(groups) <= 32  # every step's word packs one u32
        and max(0, mat.shape[0] - 1).bit_length() + 1 <= 32  # orig|bad
    )
    orig = None
    if use_routed:
        words_pk = _ngram_words_packed(
            mat, cols=tuple(tuple(g) for g in groups), vbits=vbits
        )
        orig = jnp.arange(mat.shape[0], dtype=jnp.uint32)
    for lo in range(0, len(groups), fuse):
        seg = groups[lo : lo + fuse]
        if use_routed:
            start, end, bad, orig, words_pk = _ngram_steps_fused_pair_routed(
                ng, start, end, bad, orig, words_pk,
                lo=lo, seg=len(seg), plan=plan,
            )
            continue
        cols = [c for g in seg for c in g]
        put_cols = [mat[:, c] for c in cols]
        if pair:
            start, end, bad = _ngram_steps_fused_pair(
                ng, start, end, bad, *put_cols, seg=len(seg)
            )
        else:
            start, end = _ngram_steps_fused(
                ng, start, end, *put_cols, seg=len(seg)
            )
    if use_routed:
        start, end, bad = _ngram_restore_by_orig(orig, start, end, bad)
    tail = list(range(m % n - 1, -1, -1))
    for lo in range(0, len(tail), fuse):
        seg = tail[lo : lo + fuse]
        put_cols = [mat[:, c] for c in seg]
        if pair:
            start, end, bad = _steps_fused_pair(
                dev, start, end, bad, *put_cols, seg=len(seg)
            )
        else:
            start, end = _steps_fused(dev, start, end, *put_cols, seg=len(seg))
    if not pair:
        return start, end
    lengths = np.full(mat.shape[0], kmer_len, dtype=np.int32)
    return _fixup_flagged(
        dev, mat, lengths, start, end, bad,
        lambda sub_mat, sub_len: _ngram_ranges_classic(
            dev, ng, sub_mat, kmer_len=kmer_len, seed_k=seed_k
        ),
        defer,
    )


def _ngram_ranges_classic(dev, ng, mat, *, kmer_len, seed_k):
    """Two-gather n-step loop (exact for any range width; fixup path)."""
    n = ng.n
    m = kmer_len - seed_k
    fuse = _fuse_ngram()
    mat = jnp.asarray(mat)  # one bulk upload; columns sliced on device
    start, end = _seed_lookup(dev, mat[:, kmer_len - seed_k : kmer_len])
    groups = [
        [m - n * (t + 1) + j for j in range(n)] for t in range(m // n)
    ]
    for lo in range(0, len(groups), fuse):
        seg = groups[lo : lo + fuse]
        cols = [c for g in seg for c in g]
        start, end = _ngram_steps_fused(
            ng, start, end, *[mat[:, c] for c in cols], seg=len(seg)
        )
    tail = list(range(m % n - 1, -1, -1))
    for lo in range(0, len(tail), fuse):
        seg = tail[lo : lo + fuse]
        start, end = _steps_fused(
            dev, start, end, *[mat[:, c] for c in seg], seg=len(seg)
        )
    return start, end


@functools.partial(jax.jit, static_argnames=("kmer_len", "seed_k"))
def _ngram_seeded_uniform(dev, ng, kmers, *, kmer_len, seed_k):
    """Single-program (scan-free, unrolled) variant for CPU backends."""
    from .ops import ngram as ngram_ops

    card = dev.cardinality
    powers = np.array(
        [card ** (seed_k - 1 - j) for j in range(seed_k)], dtype=np.uint32
    )
    last_k = kmers[:, kmer_len - seed_k : kmer_len].astype(jnp.uint32)
    table_idx = jnp.sum(last_k * powers[None, :], axis=1).astype(jnp.int32)
    seeded = dev.seed_table[table_idx]
    start, end = seeded[:, 0], seeded[:, 1]

    n = ng.n
    m = kmer_len - seed_k
    for t in range(m // n):
        cols = [m - n * (t + 1) + j for j in range(n)]
        letters = [kmers[:, c].astype(jnp.int32) for c in cols]
        start, end = ngram_ops.ngram_backward_step(ng, start, end, letters)
    for c in range(m % n - 1, -1, -1):
        start, end = rank_ops.backward_step(
            dev, start, end, kmers[:, c].astype(jnp.int32)
        )
    return start, end


class NgramSearchEngine(SearchEngine):
    """SearchEngine with n-letter-per-gather extension for the fast path.

    Uniform-length, ambiguity-free nucleotide batches extend n letters
    per fused-row gather over the n-gram BWT (fewer gathers per query;
    the gain is not measured on the H100); everything else falls back
    to the single-step engine, with identical results either way.
    """

    def __init__(self, index: FmIndex, n: int = 2):
        super().__init__(index)
        from .ops import ngram as ngram_ops

        if self.dev.alphabet == AlphabetType.AMINO:
            raise NotImplementedError("n-gram stepping is nucleotide-only")
        if not isinstance(index, FmIndex):
            raise TypeError("NgramSearchEngine requires a host FmIndex")
        if self.wide:
            raise NotImplementedError(
                "n-gram stepping is a 32-bit-path optimization; indexes "
                ">= 2^32 positions use the single-step 64-bit engine"
            )
        self.ng = ngram_ops.build_ngram_device(index, n)

    def find_ranges(self, kmers: Sequence[Union[str, bytes]]) -> np.ndarray:
        mat, lengths, n_real = self.encode_kmers(kmers)
        real_len = lengths[:n_real]
        k = self.dev.kmer_length_in_seed_table
        uniform = n_real > 0 and (real_len == real_len[0]).all()
        if uniform:
            kmer_len = int(real_len[0])
            clean = (mat[:n_real, :kmer_len] < self.dev.cardinality).all()
            if clean and kmer_len > k:
                if _use_step_loop():
                    # fold the pair-window flag check into the ONE
                    # result readback (defer protocol) — same folded
                    # pattern as SearchEngine.find_ranges_encoded and
                    # bench.py; an undeferred fixup pays a second host
                    # sync per batch
                    pend = []
                    s, e = _ngram_ranges_steploop(
                        self.dev, self.ng, mat, kmer_len=kmer_len,
                        seed_k=k, defer=pend,
                    )
                    flat = np.asarray(
                        jnp.concatenate(
                            [c[None].astype(jnp.uint32) for c, _ in pend]
                            + [s, e]
                        )
                    )
                    nf = len(pend)
                    if nf and flat[:nf].any():
                        s, e = pend[0][1]()  # rare: exact re-run
                        s_h = np.asarray(s, dtype=np.uint64)
                        e_h = np.asarray(e, dtype=np.uint64)
                    else:
                        b = s.shape[0]
                        s_h = flat[nf : nf + b].astype(np.uint64)
                        e_h = flat[nf + b :].astype(np.uint64)
                else:
                    s, e = _ngram_seeded_uniform(
                        self.dev, self.ng, jnp.asarray(mat),
                        kmer_len=kmer_len, seed_k=k,
                    )
                    s_h = np.asarray(s, dtype=np.uint64)
                    e_h = np.asarray(e, dtype=np.uint64)
                return np.stack([s_h[:n_real], e_h[:n_real]], axis=1)
        return super().find_ranges(kmers)


class DigramSearchEngine(NgramSearchEngine):
    """Back-compat alias: the n=2 (double-step) engine."""

    def __init__(self, index: FmIndex):
        super().__init__(index, n=2)


# ---------------------------------------------------------------------------
# Single-query parity API (AwFmSearch.c)
# ---------------------------------------------------------------------------

def iterative_step_backward_search(index: FmIndex, start_ptr: int, end_ptr: int, letter_index: int):
    """awFmNucleotide/AminoIterativeStepBackwardSearch (AwFmSearch.c:42-159).

    One unconditional backward step on an explicit [start, end] range —
    the letter-by-letter building block for custom (e.g. inexact)
    search loops. Returns the new (start_ptr, end_ptr).
    """
    import jax.numpy as jnp

    dev = index.to_device()
    if not isinstance(dev, DeviceIndex):  # wide (bwtLength >= 2^32)
        from .ops import rank64 as r64

        sh, sl = r64.split_u64_host(np.array([start_ptr], dtype=np.uint64))
        eh, el = r64.split_u64_host(np.array([end_ptr], dtype=np.uint64))
        nsh, nsl, neh, nel = r64.backward_step64(
            dev,
            jnp.asarray(sh), jnp.asarray(sl),
            jnp.asarray(eh), jnp.asarray(el),
            jnp.asarray(np.array([letter_index], dtype=np.int32)),
            active=None,
            check_valid=False,
        )
        join = lambda h, l: (int(np.asarray(h)[0]) << 32) | int(
            np.asarray(l)[0]
        )
        return join(nsh, nsl), join(neh, nel)
    s, e = rank_ops.backward_step(
        dev,
        jnp.asarray(np.array([start_ptr], dtype=np.uint32)),
        jnp.asarray(np.array([end_ptr], dtype=np.uint32)),
        jnp.asarray(np.array([letter_index], dtype=np.int32)),
        active=None,
        check_valid=False,
    )
    return int(np.asarray(s)[0]), int(np.asarray(e)[0])


def search_range_is_valid(start_ptr: int, end_ptr: int) -> bool:
    """awFmSearchRangeIsValid (AwFmIndexStruct.c:99-102)."""
    return start_ptr <= end_ptr


def query_can_use_kmer_table(index: FmIndex, kmer: Union[str, bytes]) -> bool:
    """awFmQueryCanUseKmerTable (AwFmKmerTable.c:4-19): eligible iff the
    kmer is at least seed-table length and its last k letters are free of
    ambiguity characters."""
    data = kmer.encode() if isinstance(kmer, str) else kmer
    k = index.config.kmer_length_in_seed_table
    if len(data) < k:
        return False
    lett = alpha.ascii_to_index(
        np.frombuffer(data[-k:], np.uint8), index.alphabet
    )
    return bool((lett < alpha.cardinality(index.alphabet)).all())


def find_database_hit_positions(index: FmIndex, start_ptr: int, end_ptr: int):
    """awFmFindDatabaseHitPositions (AwFmSearch.c:161-246).

    Backtraces every BWT position in [start_ptr, end_ptr] and resolves it
    to a database sequence position. Returns a uint64 array (empty for an
    invalid range).
    """
    if start_ptr > end_ptr:
        return np.empty(0, dtype=np.uint64)
    eng = SearchEngine(index)
    positions = np.arange(start_ptr, end_ptr + 1, dtype=np.uint64)
    return eng.resolve_positions(positions)


def find_database_hit_position_single(index: FmIndex, bwt_position: int) -> int:
    """awFmFindDatabaseHitPositionSingle (AwFmSearch.c:248-282)."""
    eng = SearchEngine(index)
    return int(
        eng.resolve_positions(np.array([bwt_position], dtype=np.uint64))[0]
    )


def backtrace_return_previous_letter_index(index: FmIndex, bwt_position: int):
    """awFm*BacktraceReturnPreviousLetterIndex (AwFmSearch.c:429-483).

    Returns (letter_index, new_bwt_position): the BWT letter at the given
    position and its LF mapping. A sentinel returns letter 0 and leaves
    the position UNCHANGED, matching the reference's early-out (which
    returns before writing *bwtPosition, AwFmSearch.c:443-445).
    """
    import jax.numpy as jnp

    dev = index.to_device()
    if not isinstance(dev, DeviceIndex):  # wide (bwtLength >= 2^32)
        from .ops import rank64 as r64

        hi, lo = r64.split_u64_host(np.array([bwt_position], dtype=np.uint64))
        lett, lf_hi, lf_lo = r64.letter_and_lf_at64(
            dev, jnp.asarray(hi), jnp.asarray(lo)
        )
        lett_v = int(np.asarray(lett)[0])
        if lett_v == dev.sentinel:
            return 0, bwt_position
        return lett_v, (int(np.asarray(lf_hi)[0]) << 32) | int(
            np.asarray(lf_lo)[0]
        )
    lett, lf = rank_ops.letter_and_lf_at(
        dev, jnp.asarray(np.array([bwt_position], dtype=np.uint32))
    )
    lett_v = int(np.asarray(lett)[0])
    if lett_v == dev.sentinel:
        return 0, bwt_position
    return lett_v, int(np.asarray(lf)[0])


def find_search_range_for_string(index: FmIndex, kmer: Union[str, bytes]):
    """awFmFindSearchRangeForString (AwFmSearch.c:317-358).

    Note: like the reference, this path never uses the kmer seed table.
    Returns (start_ptr, end_ptr) as Python ints.
    """
    eng = SearchEngine(index)
    mat, lengths, _ = eng.encode_kmers([kmer])
    if eng.wide:
        from . import search64

        r = search64.ranges64(eng.dev, mat, lengths, seeded=False)
        return int(r[0, 0]), int(r[0, 1])
    s, e = _unseeded_ranges(
        eng.dev, jnp.asarray(mat), jnp.asarray(lengths), n_steps=mat.shape[1] - 1
    )
    return int(np.asarray(s)[0]), int(np.asarray(e)[0])


def single_kmer_exists(index: FmIndex, kmer: Union[str, bytes]) -> bool:
    """awFmSingleKmerExists (AwFmSearch.c:360-367)."""
    s, e = find_search_range_for_string(index, kmer)
    return s <= e


def create_initial_query_range(index: FmIndex, query: Union[str, bytes]):
    """awFmCreateInitialQueryRange (AwFmSearch.c:6-25)."""
    data = query.encode() if isinstance(query, str) else query
    lett = int(alpha.ascii_to_index(np.frombuffer(data, np.uint8), index.alphabet)[-1])
    return (
        int(index.prefix_sums[lett]),
        int(index.prefix_sums[lett + 1]) - 1,
    )
