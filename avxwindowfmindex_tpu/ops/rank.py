"""Occurrence (rank) primitives — the roofline-critical inner op.

The reference computes rank with AVX2 bit-plane AND/ANDNOT + masked
popcount (AwFmOccurrence.c:8-135, AwFmSimdConfig.c:89-114):

    rank(l, pos) = milestones[pos/256, l]
                 + popcount_inclusive(match_bits(block, l), pos%256)

This formulation keeps identical math over the fused uint8 block
layout (models/index.py): ONE 128-byte row gather per position, then
elementwise work on uint8 lanes:

    match_bytes = ~((p0 ^ c0) | (p1 ^ c1) | ...)       # code equality
    count       = sum(population_count(match & incl_mask))

where c_i is an all-ones/all-zeros byte per code bit — equality against
the letter's compressed code is equivalent to the reference's per-letter
AND/ANDNOT recipes (codes are unique; AwFmLetter.c:44-47, 81-87). The
mask is INCLUSIVE of the query position, matching AwFmSimdConfig.c:91.

Every per-query scalar (code mask, milestone, inverse letter map) is
computed with arithmetic one-hot selects rather than gathers or
take_along_axis: small-table gathers were slow per-row dynamic slices
on the accelerator this was first tuned on. Whether the selects still
win on the H100 is not measured (ROADMAP A4).

All functions take the DeviceIndex pytree and are shape-polymorphic over
the batch dimension; they are traced inside the jitted loops in
search.py.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp
from jax import lax

from ..models import alphabet as alpha

POSITIONS_PER_BLOCK = 256
_BYTE_IOTA = np.arange(32, dtype=np.int32)  # bytes per 256-bit plane
_LANE_IOTA8 = np.arange(8, dtype=np.int32)  # u32 lanes per 256-bit plane
_LANE_IOTA16 = np.arange(16, dtype=np.int32)  # u32 lanes per 512-bit plane


def _use_u32_lanes() -> bool:
    """u32-lane kernels (opt-in) — see ops/_knobs.py."""
    from . import _knobs

    return _knobs.use_u32_lanes("AWFM_RANK_U32")


def _rows32_view(rows, n_lanes):
    """Bitcast the first 4*n_lanes bytes of gathered rows to u32 lanes."""
    return lax.bitcast_convert_type(
        rows[:, : n_lanes * 4].reshape(-1, n_lanes, 4), jnp.uint32
    )


def _code_mask_words(dev, letter_indices):
    """Per-plane (B,) u32 0x00000000/0xFFFFFFFF code masks (one-hot)."""
    lut = np.asarray(alpha.index_to_vector_lut(dev.alphabet))
    out = []
    for i in range(dev.n_planes):
        m = jnp.zeros(letter_indices.shape, dtype=jnp.uint32)
        for j in range(dev.cardinality + 1):
            if (lut[j] >> i) & 1:
                m = m | (
                    jnp.uint32(0)
                    - (letter_indices == j).astype(jnp.uint32)
                )
        out.append(m)
    return out


def _match_words(dev, rows32, letter_indices, lanes_per_plane):
    """(B, lanes_per_plane) u32 match bits (u32-lane _match_bytes)."""
    cms = _code_mask_words(dev, letter_indices)
    diff = None
    for i in range(dev.n_planes):
        x = (
            rows32[:, i * lanes_per_plane : (i + 1) * lanes_per_plane]
            ^ cms[i][:, None]
        )
        diff = x if diff is None else (diff | x)
    return ~diff


def _inclusive_mask_words(local, lane_iota):
    """u32-lane inclusive mask keeping bits 0..local; for bits == 31 the
    `2 << 31` wraps to 0 in u32 and -1 yields the full lane."""
    lane_idx = (local >> 5)[:, None]
    bits = (local & 31)[:, None].astype(jnp.uint32)
    low = (jnp.uint32(2) << bits) - jnp.uint32(1)
    lanes = lane_iota[None, :]
    return jnp.where(
        lanes < lane_idx,
        jnp.uint32(0xFFFFFFFF),
        jnp.where(lanes == lane_idx, low, jnp.uint32(0)),
    )


def _milestone_words(dev, rows32, letter_indices, ms_lane):
    """Milestone one-hot select over the u32 row view (no 2nd bitcast)."""
    out = jnp.zeros(letter_indices.shape, dtype=jnp.uint32)
    for j in range(dev.cardinality + 1):
        out = out + jnp.where(
            letter_indices == j, rows32[:, ms_lane + j], jnp.uint32(0)
        )
    return out


def _gather_rows(dev, positions):
    """Fetch the fused block rows for a batch of positions.

    Returns (rows, local): rows (B, row_bytes) uint8, local (B,) int32.
    This row gather is the memory-bound op; everything else is cheap
    elementwise work.
    """
    blk = (positions // POSITIONS_PER_BLOCK).astype(jnp.int32)
    local = (positions % POSITIONS_PER_BLOCK).astype(jnp.int32)
    return dev.packed[blk], local


def _inclusive_mask(local):
    """(B, 32) uint8 mask keeping bits 0..local inclusive across the 32
    plane bytes (AwFmSimdConfig.c:89-114 semantics)."""
    byte_idx = (local >> 3)[:, None]
    bit_idx = (local & 7)[:, None].astype(jnp.uint8)
    # (2 << bit) - 1 keeps bits 0..bit inclusive; 2<<7 wraps to 0 in
    # uint8, making the boundary mask all-ones, exactly as needed.
    low = (jnp.uint8(2) << bit_idx) - jnp.uint8(1)
    b = _BYTE_IOTA[None, :]
    return jnp.where(
        b < byte_idx, jnp.uint8(0xFF), jnp.where(b == byte_idx, low, jnp.uint8(0))
    )


def _code_mask_bytes(dev, letter_indices):
    """(B, n_planes) uint8 0xFF/0 masks via arithmetic one-hot select."""
    lut = np.asarray(alpha.index_to_vector_lut(dev.alphabet))
    n_planes = dev.n_planes
    out = []
    for i in range(n_planes):
        m = jnp.zeros(letter_indices.shape, dtype=jnp.uint8)
        for j in range(dev.cardinality + 1):
            if (lut[j] >> i) & 1:
                m = m | jnp.where(
                    letter_indices == j, jnp.uint8(0xFF), jnp.uint8(0)
                )
        out.append(m)
    return out


def _match_bytes(dev, rows, letter_indices):
    """(B, 32) uint8 whose set bits mark positions equal to the letter."""
    cms = _code_mask_bytes(dev, letter_indices)
    diff = None
    for i in range(dev.n_planes):
        x = rows[:, i * 32 : (i + 1) * 32] ^ cms[i][:, None]
        diff = x if diff is None else (diff | x)
    return ~diff


def _milestones_u32(dev, rows):
    """(B, A+1) uint32 milestone counts bitcast out of the fused row."""
    card = dev.cardinality
    off = dev.milestone_offset
    raw = rows[:, off : off + (card + 1) * 4].reshape(-1, card + 1, 4)
    return lax.bitcast_convert_type(raw, jnp.uint32)


def _use_ms_wsum() -> bool:
    """Weighted-byte-sum milestone select, default ON — see
    ops/_knobs.py."""
    from . import _knobs

    return _knobs.use_ms_wsum()


def _milestone_wsum(section, letter_indices, n_words):
    """Masked weighted-byte-sum milestone over the raw u8 section —
    no bitcast layout change, no per-word column selects; u32 accumulation
    wraps mod 2^32, exact for a stored u32."""
    from . import ngram as _ngram_ops

    return _ngram_ops._milestone_wsum(section, letter_indices, n_words)


def _milestone(dev, rows, letter_indices):
    """Milestone for each row's letter via arithmetic one-hot select."""
    if _use_ms_wsum():
        card = dev.cardinality
        off = dev.milestone_offset
        return _milestone_wsum(
            rows[:, off : off + (card + 1) * 4], letter_indices, card + 1
        )
    ms = _milestones_u32(dev, rows)
    out = jnp.zeros(letter_indices.shape, dtype=jnp.uint32)
    for j in range(dev.cardinality + 1):
        out = out + jnp.where(letter_indices == j, ms[:, j], jnp.uint32(0))
    return out


def _prefix_sum_select(dev, letter_indices):
    """C[letter] via arithmetic one-hot select over the A+2 entries —
    keeps the hot loops free of per-query table gathers (the module
    invariant; measured slower than the row gather itself)."""
    out = jnp.zeros(letter_indices.shape, dtype=jnp.uint32)
    for j in range(dev.cardinality + 2):
        out = out + jnp.where(letter_indices == j, dev.prefix_sums[j], jnp.uint32(0))
    return out


def _use_occ_dot() -> bool:
    """Matmul occurrence reduce (opt-in) — see ops/_knobs.py."""
    from . import _knobs

    return _knobs.use_occ_dot()


_OCC_ONES_VEC: dict = {}


def _occ_ones_vec(width: int):
    if width not in _OCC_ONES_VEC:
        _OCC_ONES_VEC[width] = np.ones((width,), dtype=np.int8)
    return _OCC_ONES_VEC[width]


def _occ_dot_single(masked):
    """(B,) int32 popcount sum via an int8 matvec (popcounts <= 8)."""
    pc = lax.population_count(masked)
    return lax.dot_general(
        pc.astype(jnp.int8),
        jnp.asarray(_occ_ones_vec(masked.shape[1])),
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )


def _count_rows(dev, rows, local, letter_indices):
    if _use_occ_dot():
        match = _match_bytes(dev, rows, letter_indices)
        cnt = _occ_dot_single(match & _inclusive_mask(local))
        return _milestone(dev, rows, letter_indices) + cnt.astype(jnp.uint32)
    if _use_u32_lanes():
        ms_lane = dev.milestone_offset // 4
        rows32 = _rows32_view(rows, ms_lane + dev.cardinality + 1)
        match = _match_words(dev, rows32, letter_indices, 8)
        masked = match & _inclusive_mask_words(local, _LANE_IOTA8)
        cnt = jnp.sum(lax.population_count(masked), axis=1, dtype=jnp.int32)
        return _milestone_words(
            dev, rows32, letter_indices, ms_lane
        ) + cnt.astype(jnp.uint32)
    match = _match_bytes(dev, rows, letter_indices)
    masked = match & _inclusive_mask(local)
    cnt = jnp.sum(lax.population_count(masked), axis=1, dtype=jnp.int32)
    return _milestone(dev, rows, letter_indices) + cnt.astype(jnp.uint32)


def occurrence(dev, positions, letter_indices):
    """Batched occ(l, pos), inclusive of pos. letter_indices in [0, A]."""
    rows, local = _gather_rows(dev, positions)
    return _count_rows(dev, rows, local, letter_indices)


def backward_step(dev, start, end, letter_indices, active=None, check_valid=True):
    """One batched backward-search step (AwFmSearch.c:42-159).

    newStart = C[l] + occ(l, startPtr-1)
    newEnd   = C[l] + occ(l, endPtr) - 1

    With ``check_valid`` (the search path), only rows where
    ``active & (start <= end)`` are updated — this reproduces the
    reference's "stop stepping once the range is invalid" rule
    (AwFmSearch.c:342-356) as a total, maskable operation. The seed-table
    builder steps unconditionally (check_valid=False), matching the DFS
    in AwFmCreate.c:434-442 which extends even already-empty ranges.
    """
    b = start.shape[0]
    c = _prefix_sum_select(dev, letter_indices)
    pos = jnp.concatenate([start - jnp.uint32(1), end])
    ll = jnp.concatenate([letter_indices, letter_indices])
    occ = occurrence(dev, pos, ll)
    new_start = c + occ[:b]
    new_end = c + occ[b:] - jnp.uint32(1)
    keep = None
    if check_valid:
        keep = start <= end
    if active is not None:
        keep = active if keep is None else (active & keep)
    if keep is None:
        return new_start, new_end
    return jnp.where(keep, new_start, start), jnp.where(keep, new_end, end)


# ---------------------------------------------------------------------------
# Pair-row (one-gather) backward step
# ---------------------------------------------------------------------------
#
# Pair row b fuses blocks b and b+1 (512 positions; models/index.py
# pack_pair_rows_from_blocks). After seeding, ranges are nearly always
# narrower than a block, so start-1 and end share one pair row and the
# step costs ONE row gather instead of the reference's two block fetches
# (AwFmSearch.c:57-58); the gain is not measured on the H100. Queries whose
# range still spans past the pair window (rare: wide ranges right after
# seeding in repeat-rich corpora) are FLAGGED, and the caller re-runs
# just those through the classic two-gather step — results are exact
# either way.

_PAIR_IOTA = np.arange(64, dtype=np.int32)  # bytes per 512-position plane


def _inclusive_mask_pair(local):
    """(B, 64) uint8 mask keeping bits 0..local inclusive, local in
    [0, 512) relative to the pair row's first block."""
    byte_idx = (local >> 3)[:, None]
    bit_idx = (local & 7)[:, None].astype(jnp.uint8)
    low = (jnp.uint8(2) << bit_idx) - jnp.uint8(1)
    b = _PAIR_IOTA[None, :]
    return jnp.where(
        b < byte_idx, jnp.uint8(0xFF), jnp.where(b == byte_idx, low, jnp.uint8(0))
    )


def _match_bytes_pair(dev, rows, letter_indices):
    """(B, 64) uint8 match bits over a pair row's 512 positions."""
    cms = _code_mask_bytes(dev, letter_indices)
    diff = None
    for i in range(dev.n_planes):
        x = rows[:, i * 64 : (i + 1) * 64] ^ cms[i][:, None]
        diff = x if diff is None else (diff | x)
    return ~diff


def _milestone_pair(dev, rows, letter_indices):
    """Block-b milestone from a pair row (one-hot select)."""
    card = dev.cardinality
    off = dev.n_planes * 64
    if _use_ms_wsum():
        return _milestone_wsum(
            rows[:, off : off + (card + 1) * 4], letter_indices, card + 1
        )
    raw = rows[:, off : off + (card + 1) * 4].reshape(-1, card + 1, 4)
    ms = lax.bitcast_convert_type(raw, jnp.uint32)
    out = jnp.zeros(letter_indices.shape, dtype=jnp.uint32)
    for j in range(card + 1):
        out = out + jnp.where(letter_indices == j, ms[:, j], jnp.uint32(0))
    return out


def backward_step_pair(dev, start, end, letter_indices, bad, active=None):
    """One-gather backward step; flags ranges wider than the pair window.

    Returns (new_start, new_end, bad). Rows already flagged keep
    stepping (their results are discarded by the caller's re-run), and
    rows whose end falls outside the pair window get a clamped (wrong)
    end — hence the flag.
    """
    c = _prefix_sum_select(dev, letter_indices)
    pos_s = start - jnp.uint32(1)
    base = (pos_s >> jnp.uint32(8)).astype(jnp.int32)
    local_s = (pos_s & jnp.uint32(0xFF)).astype(jnp.int32)
    # the window offset can be up to bwtLength (~2^32): compare in
    # uint32 BEFORE any int32 cast, or widths >= 2^31 wrap negative and
    # silently escape the overflow flag (rank64.backward_step64_pair
    # establishes the same contract in u64)
    delta_e = end - (pos_s & ~jnp.uint32(0xFF))
    overflow = delta_e >= jnp.uint32(512)
    local_e = jnp.minimum(delta_e, jnp.uint32(511)).astype(jnp.int32)

    rows = dev.packed_pair[base]
    # knob precedence (consistent with _count_rows): AWFM_OCC_DOT
    # first, then AWFM_RANK_U32, else the byte-lane default — so a
    # both-knobs-set sweep is unambiguous
    if _use_occ_dot():
        from .ngram import occ_pair_dot

        match = _match_bytes_pair(dev, rows, letter_indices)
        occ_s, occ_e = occ_pair_dot(
            match & _inclusive_mask_pair(local_s),
            match & _inclusive_mask_pair(local_e),
        )
        ms = _milestone_pair(dev, rows, letter_indices)
    elif _use_u32_lanes():
        ms_lane = dev.n_planes * 16
        rows32 = _rows32_view(rows, ms_lane + dev.cardinality + 1)
        match = _match_words(dev, rows32, letter_indices, 16)
        occ_s = jnp.sum(
            lax.population_count(
                match & _inclusive_mask_words(local_s, _LANE_IOTA16)
            ),
            axis=1, dtype=jnp.int32,
        )
        occ_e = jnp.sum(
            lax.population_count(
                match & _inclusive_mask_words(local_e, _LANE_IOTA16)
            ),
            axis=1, dtype=jnp.int32,
        )
        ms = _milestone_words(dev, rows32, letter_indices, ms_lane)
    else:
        match = _match_bytes_pair(dev, rows, letter_indices)
        occ_s = jnp.sum(
            lax.population_count(match & _inclusive_mask_pair(local_s)),
            axis=1,
            dtype=jnp.int32,
        )
        occ_e = jnp.sum(
            lax.population_count(match & _inclusive_mask_pair(local_e)),
            axis=1,
            dtype=jnp.int32,
        )
        ms = _milestone_pair(dev, rows, letter_indices)
    new_start = c + ms + occ_s.astype(jnp.uint32)
    new_end = c + ms + occ_e.astype(jnp.uint32) - jnp.uint32(1)

    keep = start <= end
    if active is not None:
        keep = keep & active
    bad = bad | (overflow & keep)
    return (
        jnp.where(keep, new_start, start),
        jnp.where(keep, new_end, end),
        bad,
    )


def pair_occurrence_single(dev, positions, letter_indices):
    """occ(l, pos) via the pair table (first-block half of pair rows).

    Bit-identical to occurrence(); used where only the pair table is
    resident. One 2x-width row gather instead of a 1x gather.
    """
    blk = (positions // POSITIONS_PER_BLOCK).astype(jnp.int32)
    local = (positions % POSITIONS_PER_BLOCK).astype(jnp.int32)
    rows = dev.packed_pair[blk]
    if _use_u32_lanes():
        ms_lane = dev.n_planes * 16
        rows32 = _rows32_view(rows, ms_lane + dev.cardinality + 1)
        match = _match_words(dev, rows32, letter_indices, 16)
        cnt = jnp.sum(
            lax.population_count(
                match & _inclusive_mask_words(local, _LANE_IOTA16)
            ),
            axis=1, dtype=jnp.int32,
        )
        return _milestone_words(
            dev, rows32, letter_indices, ms_lane
        ) + cnt.astype(jnp.uint32)
    match = _match_bytes_pair(dev, rows, letter_indices)
    cnt = jnp.sum(
        lax.population_count(match & _inclusive_mask_pair(local)),
        axis=1,
        dtype=jnp.int32,
    )
    return _milestone_pair(dev, rows, letter_indices) + cnt.astype(jnp.uint32)


def letter_at_rows(dev, rows, local):
    """Letter index at each gathered block row's local position.

    One bit per plane via a one-hot byte mask + popcount (no per-row
    dynamic slices), then the compressed code inverse-mapped with an
    arithmetic select (AwFmOccurrence.c:170-217 equivalent). Shared by
    the single-device LF (letter_and_lf_at) and the range-sharded
    backtrace segment (parallel/range_sharded.py), which masks and
    psum-combines the result across shards.
    """
    byte_idx = (local >> 3)[:, None]
    bit_idx = (local & 7)[:, None].astype(jnp.uint8)
    onehot = jnp.where(
        _BYTE_IOTA[None, :] == byte_idx, jnp.uint8(1) << bit_idx, jnp.uint8(0)
    )
    code = jnp.zeros(local.shape, dtype=jnp.int32)
    for i in range(dev.n_planes):
        hit = jnp.sum(
            lax.population_count(rows[:, i * 32 : (i + 1) * 32] & onehot),
            axis=1,
            dtype=jnp.int32,
        )
        code = code | (hit << i)
    v2i = np.asarray(alpha.vector_to_index_lut(dev.alphabet))
    lett = jnp.zeros(local.shape, dtype=jnp.int32)
    for v in range(1 << dev.n_planes):
        if v2i[v]:
            lett = lett + jnp.where(code == v, jnp.int32(v2i[v]), jnp.int32(0))
    return lett


def letter_and_lf_at(dev, positions):
    """Read the BWT letter at each position and compute its LF mapping.

    Mirrors awFmNucleotideBacktraceBwtPosition / amino variant
    (AwFmSearch.c:369-427): LF(p) = C[l] + occ(l, p) - 1 with l the
    letter at p; a sentinel letter maps to position 0. The letter is
    reconstructed by extracting one bit per plane (via a one-hot byte
    mask + popcount, avoiding per-row dynamic slices) and inverse-mapping
    the compressed code (AwFmOccurrence.c:170-217 equivalent).

    Returns (letter_indices, lf_positions) — both (B,).
    """
    rows, local = _gather_rows(dev, positions)
    return letter_and_lf_from_rows(dev, rows, local)


def letter_and_lf_from_rows(dev, rows, local):
    """letter_and_lf_at's compute stage on already-gathered rows — the
    slab-routed backtrace (ops/route.py) runs it on the rows its
    per-slab scan gathered."""
    lett = letter_at_rows(dev, rows, local)
    is_sentinel = lett == dev.sentinel
    # clamp the sentinel for the selects below; its result is overridden.
    lclip = jnp.minimum(lett, dev.cardinality)
    occ = _count_rows(dev, rows, local, lclip)
    lf = _prefix_sum_select(dev, lclip) + occ - jnp.uint32(1)
    lf = jnp.where(is_sentinel, jnp.uint32(0), lf)
    return lett, lf
