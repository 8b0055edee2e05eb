"""n-step (n-gram) backward search — n letters per rank step.

Generalizes ops/digram.py to n in {2, 3}: a windowed BWT over the
n-gram of characters preceding each suffix lets one fused-row gather
extend the pattern by n letters (the classical k-step FM-index):

    BWTn[i] = T[SA[i]-n .. SA[i]-1]
    range(wP) = [ Cn[w] + occn_incl(w, start-1),
                  Cn[w] + occn_incl(w, end) - 1 ]        |w| = n

Row layouts (nucleotide only; clean symbols are the 4^n words over
ACGT, everything touching sentinel/ambiguity is DIRTY):

    n=2: 17 symbols, 5 planes x 32 B + 16 u32 milestones = 224 -> 256 B
    n=3: 65 symbols, 7 planes x 32 B + 64 u32 milestones = 480 -> 512 B

A random row gather costs far more than the bytes it moves, so each
extra letter per step is nearly free bandwidth-wise; rows-per-query is
the throughput lever (the row-width cost is not measured on the H100).

The n-gram BWT derives from the single-letter index alone via n-1
applications of the vectorized LF mapping — no suffix array needed.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..models.config import AlphabetType
from ..models.index import FmIndex, POSITIONS_PER_BLOCK, num_blocks_from_bwt_length

_BYTE_IOTA = np.arange(32, dtype=np.int32)


def _geometry(n: int):
    if n not in (2, 3):
        raise ValueError("n-gram stepping supports n in {2, 3}")
    n_words = 4**n
    dirty = n_words
    n_planes = (2 * n + 1)
    ms_offset = n_planes * 32
    row_bytes = ms_offset + n_words * 4
    row_bytes = ((row_bytes + 127) // 128) * 128
    return n_words, dirty, n_planes, ms_offset, row_bytes


def _geometry_pair(n: int):
    """Pair-row layout: plane i covers 512 positions (blocks b, b+1) at
    bytes [i*64, (i+1)*64); block b's milestones follow. n=2: 512 B."""
    n_words, dirty, n_planes, _, _ = _geometry(n)
    ms_offset = n_planes * 64
    row_bytes = ms_offset + n_words * 4
    row_bytes = ((row_bytes + 127) // 128) * 128
    return n_words, dirty, n_planes, ms_offset, row_bytes


@dataclasses.dataclass
class NgramIndex:
    """Device arrays for the n-step path (registered pytree).

    ``packed`` holds PAIR rows (blocks b and b+1 fused): the backward
    step is one row gather when the range fits the 512-position window
    (the overwhelmingly common post-seed case), and single-position
    ranks read the first-block half of the same rows — so only one
    table is resident.
    """

    packed: object  # (num_blocks, pair_row_bytes) uint8
    cn: object  # (4**n,) uint32: range start of each n-mer
    n: int  # static: letters per step
    # When True the stored milestones are PRE-BIASED: milestone[b][w]
    # holds Cn[w] + occ_before_block(w, b) (exact in u32, bwtLength <
    # 2^32 on this path), so the backward step is ms + popcount with no
    # per-query Cn one-hot select. AWFM_MS_PREBIAS=1 at build time.
    biased: bool = False


jax.tree_util.register_dataclass(
    NgramIndex, data_fields=["packed", "cn"], meta_fields=["n", "biased"]
)


# ---------------------------------------------------------------------------
# Host-side construction
# ---------------------------------------------------------------------------

_HOST_CHUNK = 1 << 26  # 64M positions per pass bounds host temporaries


def _lf_array(index: FmIndex) -> np.ndarray:
    """Vectorized LF over all BWT positions (sentinel -> 0).

    Memory-lean for genome-scale inputs: uint32 output when it fits
    (device search requires bwtLength < 2^32 anyway), per-letter
    flatnonzero groups instead of a full stable argsort, and no int64
    copy of the BWT. An int64 whole-array formulation transiently needs
    >5x bwtLength * 8 bytes (~125 GB at hg38 scale — OOM).
    """
    bwt = index.bwt_letters  # uint8, not copied
    ps = index.prefix_sums
    sentinel = index.sentinel_index
    dtype = np.uint32 if index.bwt_length < (1 << 32) else np.int64
    lf = np.zeros(index.bwt_length, dtype=dtype)
    # flatnonzero is ascending, so each letter's occurrences keep their
    # BWT order — the defining property of LF
    for lett in range(sentinel + 1):
        grp = np.flatnonzero(bwt == lett)
        if lett != sentinel:
            vals = np.arange(len(grp), dtype=dtype)
            vals += dtype(int(ps[lett]))
            lf[grp] = vals
            del vals
        del grp
    return lf


def _letter_counts_before(bwt: np.ndarray, bounds: np.ndarray,
                          n_letters: int = 4) -> np.ndarray:
    """occ matrix: out[x, i] = #{p < bounds[i] : bwt[p] == x},
    x in [0, n_letters).

    One chunked pass over the BWT; replaces per-letter position lists
    (which together hold the whole index as int64 — ~25 GB at hg38
    scale) for the handful of thresholds the Cn fold needs. Also used
    by ops/bt_digram.py with the full letter set.
    """
    bounds = np.asarray(bounds, dtype=np.int64)
    order = np.argsort(bounds, kind="stable")
    out = np.zeros((n_letters, len(bounds)), dtype=np.int64)
    running = np.zeros(n_letters, dtype=np.int64)
    bi = 0
    n = len(bwt)
    for lo in range(0, n, _HOST_CHUNK):
        hi = min(lo + _HOST_CHUNK, n)
        while bi < len(order) and bounds[order[bi]] <= hi:
            b = int(bounds[order[bi]])
            out[:, order[bi]] = running + np.bincount(
                bwt[lo:b], minlength=8
            )[:n_letters]
            bi += 1
        if bi == len(order):
            break
        running += np.bincount(bwt[lo:hi], minlength=8)[:n_letters]
    return out


def build_ngram_host(index: FmIndex, n: int):
    """(codes, cn): the n-gram BWT codes and the n-mer range starts.

    All whole-index work is chunked and uint8/uint32 so an hg38-scale
    build peaks ~6 bytes/position beyond the index itself.
    """
    if index.alphabet == AlphabetType.AMINO:
        raise NotImplementedError("n-gram stepping is nucleotide-only")
    n_words, dirty, _, _, _ = _geometry(n)
    bwt = index.bwt_letters  # uint8
    ps = index.prefix_sums.astype(np.int64)
    length = index.bwt_length

    lf = _lf_array(index)
    # letters[j] = T[SA[i] - 1 - j] via j LF steps;
    # code = sum letters[j] * 4^j (nearest preceding char least
    # significant), i.e. word value of T[SA[i]-n..SA[i]-1] base-4 with
    # the LEFTMOST character most significant. Max value 5+4*5+16*5=105
    # fits uint8 for n <= 3.
    codes = np.empty(length, dtype=np.uint8)
    for lo in range(0, length, _HOST_CHUNK):
        c0 = bwt[lo : lo + _HOST_CHUNK]
        code = c0.copy()
        clean = c0 < 4
        idx = lf[lo : lo + _HOST_CHUNK]
        for j in range(1, n):
            lj = bwt[idx]
            clean &= lj < 4
            code += lj * np.uint8(4**j)
            if j + 1 < n:
                idx = lf[idx]
        codes[lo : lo + _HOST_CHUNK] = np.where(clean, code, np.uint8(dirty))
    del lf

    # Cn[w] = range start of the n-mer w: fold backward steps from the
    # (n-1)-mer starts. C1 = prefix sums; occ thresholds counted in one
    # chunked pass per depth.
    c_prev = ps[:4].astype(np.uint64)  # C1[y] = ps[y]
    for depth in range(1, n):
        occ = _letter_counts_before(bwt, c_prev)
        c_new = np.empty(4 * len(c_prev), dtype=np.uint64)
        for x in range(4):
            # new word = x * 4^depth + suffix-word (x most significant)
            c_new[x * len(c_prev) : (x + 1) * len(c_prev)] = ps[x] + occ[x]
        c_prev = c_new
    return codes, c_prev


def pack_ngram_blocks(codes: np.ndarray, n: int) -> np.ndarray:
    """n-gram codes -> (num_blocks, row_bytes) uint8 fused rows."""
    n_words, dirty, n_planes, ms_offset, row_bytes = _geometry(n)
    length = len(codes)
    nb = num_blocks_from_bwt_length(length)
    padded = np.full(nb * POSITIONS_PER_BLOCK, dirty, dtype=np.uint8)
    padded[:length] = codes

    out = np.zeros((nb, row_bytes), dtype=np.uint8)
    for b in range(n_planes):
        bits = ((padded >> b) & 1).reshape(nb, POSITIONS_PER_BLOCK)
        out[:, b * 32 : (b + 1) * 32] = np.packbits(
            bits, axis=1, bitorder="little"
        )
    # per-symbol per-block sums over the (nb, 256) uint8 view: avoids
    # the O(length) int64 key temporaries of a flat bincount (tens of
    # GB transient at genome scale)
    codes_mat = padded.reshape(nb, POSITIONS_PER_BLOCK)
    counts = np.empty((nb, n_words), dtype=np.int64)
    for w in range(n_words):
        counts[:, w] = (codes_mat == w).sum(axis=1)
    cum = np.cumsum(counts, axis=0)
    milestones = np.zeros_like(cum)
    milestones[1:] = cum[:-1]
    out[:, ms_offset : ms_offset + n_words * 4] = (
        milestones.astype("<u4").view(np.uint8).reshape(nb, n_words * 4)
    )
    return out


def pair_rows_from_ngram_blocks(packed: np.ndarray, n: int) -> np.ndarray:
    """Per-block fused rows -> pair rows (blocks b,b+1 per row).

    The final row's missing partner keeps zero plane bytes: word code 0
    (AA/AAA) would match there, but those pair-local positions >= 256 of
    the last block lie beyond every valid query position, and the
    inclusive mask zeroes them for all in-range ranks.
    """
    n_words, dirty, n_planes, ms_offset, row_bytes = _geometry(n)
    _, _, _, pair_ms_offset, pair_row_bytes = _geometry_pair(n)
    nb = packed.shape[0]
    out = np.zeros((nb, pair_row_bytes), dtype=np.uint8)
    for i in range(n_planes):
        plane = packed[:, i * 32 : (i + 1) * 32]
        out[:, i * 64 : i * 64 + 32] = plane
        out[:-1, i * 64 + 32 : (i + 1) * 64] = plane[1:]
    ms_len = n_words * 4
    out[:, pair_ms_offset : pair_ms_offset + ms_len] = packed[
        :, ms_offset : ms_offset + ms_len
    ]
    return out


def build_ngram_device(index: FmIndex, n: int, bias_cn=None,
                       cache_path=None) -> NgramIndex:
    # Rows stay uint8 lanes: a u32-word variant of this table won in
    # isolation but lost end to end on the earlier accelerator; not
    # measured on the H100.
    import os

    # Cn pre-bias is DEFAULT ON (one add fewer per step; not measured on
    # the H100); AWFM_MS_PREBIAS=0 opts out (e.g. for tables whose
    # milestones must stay raw counts).
    if bias_cn is None:
        bias_cn = os.environ.get("AWFM_MS_PREBIAS", "1") == "1"
    # cache_path: optional .npz of the FINISHED host rows — the host
    # n-gram build is an O(n_bases) LF pass (tens of minutes at hg38); callers
    # that rebuild the same index repeatedly (bench.py AWFM_BENCH_CACHE)
    # key the path on every input that shapes the rows (corpus, n,
    # prebias)
    if cache_path and os.path.exists(cache_path):
        with np.load(cache_path) as z:
            # validate EVERY row-shaping input, not just the bias flag:
            # a mis-keyed path (e.g. an n=2 file offered to an n=3
            # build, or a different corpus) would otherwise return
            # wrong-geometry rows with no diagnostic. Files written
            # before the n/bwt_length stamps existed fail the check and
            # rebuild — the safe direction.
            if (
                bool(z["biased"]) == bool(bias_cn)
                and "n" in z
                and int(z["n"]) == int(n)
                and int(z["bwt_length"]) == int(index.bwt_length)
            ):
                return NgramIndex(
                    packed=jnp.asarray(z["pair"]),
                    cn=jnp.asarray(z["cn"]),
                    n=n,
                    biased=bool(bias_cn),
                )
    codes, cn = build_ngram_host(index, n)
    blocks = pack_ngram_blocks(codes, n)
    del codes
    pair = pair_rows_from_ngram_blocks(blocks, n)
    del blocks
    if bias_cn:
        n_words, _, _, ms_offset, _ = _geometry_pair(n)
        ms = pair[:, ms_offset : ms_offset + n_words * 4].copy()
        ms32 = ms.view("<u4").reshape(-1, n_words)
        ms32 += cn.astype(np.uint32)[None, :]
        pair[:, ms_offset : ms_offset + n_words * 4] = ms.reshape(
            pair.shape[0], n_words * 4
        )
    if cache_path:
        tmp = cache_path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez(fh, pair=pair, cn=cn.astype(np.uint32),
                     biased=np.int64(int(bias_cn)), n=np.int64(n),
                     bwt_length=np.int64(index.bwt_length))
        os.replace(tmp, cache_path)
    return NgramIndex(
        packed=jnp.asarray(pair),
        cn=jnp.asarray(cn.astype(np.uint32)),
        n=n,
        biased=bool(bias_cn),
    )


# ---------------------------------------------------------------------------
# Device kernel
# ---------------------------------------------------------------------------

def _word_value(letter_list):
    """Word value from per-position letters; letter_list[0] is the
    LEFTMOST (most significant) character of the n-gram."""
    n = len(letter_list)
    v = None
    for j, lett in enumerate(letter_list):
        term = lett.astype(jnp.int32) * (4 ** (n - 1 - j))
        v = term if v is None else v + term
    return v


_PAIR_IOTA = np.arange(64, dtype=np.int32)
_PAIR_IOTA32 = np.arange(16, dtype=np.int32)


def _use_u32_lanes() -> bool:
    """u32-lane kernels (opt-in) — see ops/_knobs.py."""
    from . import _knobs

    return _knobs.use_u32_lanes("AWFM_NGRAM_U32")


def _pair_rows32(ng: NgramIndex, rows):
    """Bitcast a WHOLE gathered pair row to u32 lanes (one layout change):
    plane i occupies lanes [16i, 16i+16); the n_words milestones start
    at lane ms_offset/4 — so the milestone select reads the same u32
    view instead of paying a second u8->u32 bitcast."""
    n_words, _, n_planes, ms_offset, row_bytes = _geometry_pair(ng.n)
    lanes = (ms_offset + n_words * 4) // 4
    return lax.bitcast_convert_type(
        rows[:, : lanes * 4].reshape(-1, lanes, 4), jnp.uint32
    )


def _pair_milestone_u32(ng: NgramIndex, rows32, v):
    """Milestone one-hot select over the u32 row view (no bitcast)."""
    n_words, _, n_planes, ms_offset, _ = _geometry_pair(ng.n)
    base = ms_offset // 4
    ms = jnp.zeros(v.shape, dtype=jnp.uint32)
    for j in range(n_words):
        ms = ms + jnp.where(v == j, rows32[:, base + j], jnp.uint32(0))
    return ms


def _pair_match_u32(ng: NgramIndex, rows32, v):
    """(B, 16) u32 match bits for word value v over a pair row.

    Top plane = dirty marker, plain OR (see _pair_match)."""
    _, _, n_planes, _, _ = _geometry_pair(ng.n)
    diff = None
    for i in range(n_planes - 1):
        # 0x00000000 / 0xFFFFFFFF from bit i of v (two's-complement neg)
        m = jnp.uint32(0) - ((v >> i) & 1).astype(jnp.uint32)
        x = rows32[:, i * 16 : (i + 1) * 16] ^ m[:, None]
        diff = x if diff is None else (diff | x)
    diff = diff | rows32[:, (n_planes - 1) * 16 : n_planes * 16]
    return ~diff


def _pair_mask_u32(local):
    """(B, 16) u32 inclusive mask, local in [0, 512).

    Keep bits 0..local across the 16 little-endian u32 lanes; for
    bits == 31 the `2 << 31` wraps to 0 in u32 and -1 yields the full
    lane, exactly as required.
    """
    lane_idx = (local >> 5)[:, None]
    bits = (local & 31)[:, None].astype(jnp.uint32)
    low = (jnp.uint32(2) << bits) - jnp.uint32(1)
    lanes = _PAIR_IOTA32[None, :]
    return jnp.where(
        lanes < lane_idx,
        jnp.uint32(0xFFFFFFFF),
        jnp.where(lanes == lane_idx, low, jnp.uint32(0)),
    )


def _use_occ_dot() -> bool:
    """Matmul occurrence reduce (opt-in) — see ops/_knobs.py."""
    from . import _knobs

    return _knobs.use_occ_dot()


_OCC_DOT_ONES: dict = {}


def _occ_dot_ones(width: int):
    """(2*width, 2) int8 block-ones matrix: column 0 sums the first
    `width` lanes, column 1 the second `width`."""
    if width not in _OCC_DOT_ONES:
        m = np.zeros((2 * width, 2), dtype=np.int8)
        m[:width, 0] = 1
        m[width:, 1] = 1
        _OCC_DOT_ONES[width] = m
    return _OCC_DOT_ONES[width]


def occ_pair_dot(masked_s, masked_e):
    """(occ_s, occ_e) int32 via one int8 matmul over the concatenated
    masked match bytes (each (B, W) uint8)."""
    w = masked_s.shape[1]
    pc = lax.population_count(jnp.concatenate([masked_s, masked_e], axis=1))
    occ = lax.dot_general(
        pc.astype(jnp.int8),
        jnp.asarray(_occ_dot_ones(w)),
        (((1,), (0,)), ((), ())),
        preferred_element_type=jnp.int32,
    )
    return occ[:, 0], occ[:, 1]


def _pair_match(ng: NgramIndex, rows, v):
    """(B, 64) uint8 match bits for word value v over a pair row.

    The top plane (index 2n) is the dirty marker: clean query words
    (letters in [0,4), the kernel contract) never set that bit, so its
    contribution is a plain OR of the plane bytes — no per-query
    broadcast XOR."""
    _, _, n_planes, _, _ = _geometry_pair(ng.n)
    full = jnp.uint8(0xFF)
    diff = None
    for i in range(n_planes - 1):
        m = ((v >> i) & 1).astype(jnp.uint8) * full
        x = rows[:, i * 64 : (i + 1) * 64] ^ m[:, None]
        diff = x if diff is None else (diff | x)
    diff = diff | rows[:, (n_planes - 1) * 64 : n_planes * 64]
    return ~diff


def _pair_mask(local):
    """(B, 64) uint8 inclusive mask, local in [0, 512)."""
    byte_idx = (local >> 3)[:, None]
    bit_idx = (local & 7)[:, None].astype(jnp.uint8)
    low = (jnp.uint8(2) << bit_idx) - jnp.uint8(1)
    b = _PAIR_IOTA[None, :]
    return jnp.where(
        b < byte_idx,
        jnp.uint8(0xFF),
        jnp.where(b == byte_idx, low, jnp.uint8(0)),
    )


def _use_ms_wsum() -> bool:
    """Weighted-byte-sum milestone select, default ON — see
    ops/_knobs.py for rationale and measurements."""
    from . import _knobs

    return _knobs.use_ms_wsum()


_WSUM_CONSTS: dict = {}


def _wsum_consts(n_words: int):
    """(word_id, byte_weight) rows for an n_words*4-byte milestone
    section: word_id[i] = i//4 (int32), weight[i] = 2^(8*(i%4)) (u32)."""
    if n_words not in _WSUM_CONSTS:
        nb = n_words * 4
        wid = (np.arange(nb, dtype=np.int32) // 4).astype(np.int32)
        wgt = (1 << (8 * (np.arange(nb) % 4))).astype(np.uint32)
        _WSUM_CONSTS[n_words] = (wid, wgt)
    return _WSUM_CONSTS[n_words]


def _milestone_wsum(section, v, n_words):
    """Masked weighted-byte-sum milestone: section (B, n_words*4) u8,
    v (B,) int32 word values -> (B,) u32 milestones."""
    wid, wgt = _wsum_consts(n_words)
    sel = jnp.asarray(wid)[None, :] == v[:, None]
    terms = section.astype(jnp.uint32) * jnp.asarray(wgt)[None, :]
    return jnp.sum(
        jnp.where(sel, terms, jnp.uint32(0)), axis=1, dtype=jnp.uint32
    )


def _pair_milestone(ng: NgramIndex, rows, v):
    n_words, _, _, ms_offset, _ = _geometry_pair(ng.n)
    if _use_ms_wsum():
        return _milestone_wsum(
            rows[:, ms_offset : ms_offset + n_words * 4], v, n_words
        )
    ms_all = lax.bitcast_convert_type(
        rows[:, ms_offset : ms_offset + n_words * 4].reshape(-1, n_words, 4),
        jnp.uint32,
    )
    ms = jnp.zeros(v.shape, dtype=jnp.uint32)
    for j in range(n_words):
        ms = ms + jnp.where(v == j, ms_all[:, j], jnp.uint32(0))
    return ms


def _cn_select(ng: NgramIndex, v):
    cn = jnp.zeros(v.shape, dtype=jnp.uint32)
    for j in range(4**ng.n):
        cn = cn + jnp.where(v == j, ng.cn[j], jnp.uint32(0))
    return cn


def ngram_occurrence(ng: NgramIndex, positions, letter_list):
    """Batched occn(w, pos), inclusive. letter_list: n arrays in [0,4).

    Single-position rank via the first-block half of a pair row.
    When ``ng.biased`` the returned value is Cn[w] + occn(w, pos) —
    i.e. directly the backward-step range bound.
    """
    blk = (positions // POSITIONS_PER_BLOCK).astype(jnp.int32)
    local = (positions % POSITIONS_PER_BLOCK).astype(jnp.int32)
    rows = ng.packed[blk]
    v = _word_value(letter_list)
    if _use_u32_lanes():
        rows32 = _pair_rows32(ng, rows)
        match = _pair_match_u32(ng, rows32, v)
        cnt = jnp.sum(
            lax.population_count(match & _pair_mask_u32(local)),
            axis=1, dtype=jnp.int32,
        )
        return _pair_milestone_u32(ng, rows32, v) + cnt.astype(jnp.uint32)
    match = _pair_match(ng, rows, v)
    cnt = jnp.sum(
        lax.population_count(match & _pair_mask(local)),
        axis=1, dtype=jnp.int32,
    )
    return _pair_milestone(ng, rows, v) + cnt.astype(jnp.uint32)


def ngram_backward_step(ng: NgramIndex, start, end, letter_list):
    """One n-step: prepend the n-gram (letter_list, leftmost first).

    newStart = Cn[w] + occn(w, start-1); newEnd = Cn[w] + occn(w, end) - 1.
    Rows with an invalid range keep it (the reference's stop rule).
    Two-gather formulation — exact for any range width; the fixup path
    behind ngram_backward_step_pair.
    """
    b = start.shape[0]
    pos = jnp.concatenate([start - jnp.uint32(1), end])
    doubled = [jnp.concatenate([l, l]) for l in letter_list]
    occ = ngram_occurrence(ng, pos, doubled)
    if ng.biased:
        cn = jnp.uint32(0)  # Cn[w] lives in the stored milestones
    else:
        cn = _cn_select(ng, _word_value(letter_list))
    new_start = cn + occ[:b]
    new_end = cn + occ[b:] - jnp.uint32(1)
    keep = start <= end
    return jnp.where(keep, new_start, start), jnp.where(keep, new_end, end)


def _pair_occ_from_rows(ng: NgramIndex, rows, v, local_s, local_e):
    """(occ_s, occ_e, ms) from gathered pair rows — the compute stage of
    the pair step, shared by the mono gather and the slab-routed path
    (which materializes rows via route.routed_gather and runs this once
    on the full batch). Knob precedence is consistent with rank.py:
    AWFM_OCC_DOT first, then AWFM_NGRAM_U32, else the byte-lane
    default."""
    if _use_occ_dot():
        match = _pair_match(ng, rows, v)
        occ_s, occ_e = occ_pair_dot(
            match & _pair_mask(local_s), match & _pair_mask(local_e)
        )
        return occ_s, occ_e, _pair_milestone(ng, rows, v)
    if _use_u32_lanes():
        rows32 = _pair_rows32(ng, rows)
        match = _pair_match_u32(ng, rows32, v)
        occ_s = jnp.sum(
            lax.population_count(match & _pair_mask_u32(local_s)),
            axis=1, dtype=jnp.int32,
        )
        occ_e = jnp.sum(
            lax.population_count(match & _pair_mask_u32(local_e)),
            axis=1, dtype=jnp.int32,
        )
        return occ_s, occ_e, _pair_milestone_u32(ng, rows32, v)
    match = _pair_match(ng, rows, v)
    occ_s = jnp.sum(
        lax.population_count(match & _pair_mask(local_s)),
        axis=1,
        dtype=jnp.int32,
    )
    occ_e = jnp.sum(
        lax.population_count(match & _pair_mask(local_e)),
        axis=1,
        dtype=jnp.int32,
    )
    return occ_s, occ_e, _pair_milestone(ng, rows, v)


def ngram_backward_step_pair(ng: NgramIndex, start, end, letter_list, bad):
    """One-gather n-step; flags ranges wider than the 512-position window.

    Returns (new_start, new_end, bad) — same contract as
    rank.backward_step_pair: flagged rows must be re-run through the
    two-gather step by the caller.
    """
    v = _word_value(letter_list)
    if ng.biased:
        cn = jnp.uint32(0)  # Cn[w] lives in the stored milestones
    else:
        cn = _cn_select(ng, v)
    pos_s = start - jnp.uint32(1)
    base = (pos_s >> jnp.uint32(8)).astype(jnp.int32)
    local_s = (pos_s & jnp.uint32(0xFF)).astype(jnp.int32)
    # uint32 compare BEFORE the int32 cast: widths >= 2^31 would wrap
    # negative and silently skip the flag (see rank.backward_step_pair)
    delta_e = end - (pos_s & ~jnp.uint32(0xFF))
    overflow = delta_e >= jnp.uint32(512)
    local_e = jnp.minimum(delta_e, jnp.uint32(511)).astype(jnp.int32)

    rows = ng.packed[base]
    occ_s, occ_e, ms = _pair_occ_from_rows(ng, rows, v, local_s, local_e)
    new_start = cn + ms + occ_s.astype(jnp.uint32)
    new_end = cn + ms + occ_e.astype(jnp.uint32) - jnp.uint32(1)
    keep = start <= end
    bad = bad | (overflow & keep)
    return (
        jnp.where(keep, new_start, start),
        jnp.where(keep, new_end, end),
        bad,
    )


def ngram_vbits(n: int) -> int:
    """Bits of a word value (_word_value is base-4): 4**n codes."""
    return (4**n - 1).bit_length()


def ngram_backward_step_pair_routed(ng: NgramIndex, start, end, bad,
                                    orig, words_pk, step_idx: int, plan):
    """ngram_backward_step_pair on PERMUTED state with a slab-routed
    row gather.

    Inputs arrive in an arbitrary permutation of the batch (``orig``
    maps each row to its original query id); the step sorts by gather
    position and RETURNS STATE IN THAT SORTED ORDER — the caller chains
    steps without unpermuting and restores original order once, after
    the whole extension loop. ``words_pk`` carries EVERY remaining
    step's word value packed vbits apiece (this step reads bits
    [vbits*step_idx, vbits*(step_idx+1))): the letters ride the routing
    sort instead of being gathered per step through ``orig``: a per-step
    payload gather cost most of a whole mono step, while one more sort
    operand cost little. Restoring order per step, with stable sorts
    of five payload arrays, ate the whole routed-gather win.

    Exactness: rows whose slab run overflowed the plan's cap come back
    covered=False with garbage content; they are OR'd into ``bad`` and
    re-run exactly by the caller's pair-window fixup, like any
    512-window overflow. Out-of-range positions (start=0 wraps pos_s)
    clamp to the last row in both formulations — XLA's gather clamp
    mono-side, the explicit local clip routed-side — and are masked by
    ``keep`` identically.
    """
    from . import route as route_ops

    vbits = ngram_vbits(ng.n)
    pos_s = start - jnp.uint32(1)
    orig_bad = (orig << jnp.uint32(1)) | bad.astype(jnp.uint32)
    pos_s_s, end_s, wpk_s, ob_s = lax.sort(
        (pos_s, end, words_pk, orig_bad), num_keys=1, is_stable=False
    )
    v_s = (
        (wpk_s >> jnp.uint32(vbits * step_idx))
        & jnp.uint32((1 << vbits) - 1)
    ).astype(jnp.int32)
    bad_s = (ob_s & jnp.uint32(1)) != 0
    orig_s = ob_s >> jnp.uint32(1)
    blk = (pos_s_s >> jnp.uint32(8)).astype(jnp.int32)

    rows, covered = route_ops.routed_gather(ng.packed, blk, plan)
    local_s = (pos_s_s & jnp.uint32(0xFF)).astype(jnp.int32)
    delta_e = end_s - (pos_s_s & ~jnp.uint32(0xFF))
    ovf = delta_e >= jnp.uint32(512)
    local_e = jnp.minimum(delta_e, jnp.uint32(511)).astype(jnp.int32)
    occ_s, occ_e, ms = _pair_occ_from_rows(ng, rows, v_s, local_s, local_e)
    if ng.biased:
        cn = jnp.uint32(0)  # Cn[w] lives in the stored milestones
    else:
        cn = _cn_select(ng, v_s)
    new_start = cn + ms + occ_s.astype(jnp.uint32)
    new_end = cn + ms + occ_e.astype(jnp.uint32) - jnp.uint32(1)
    start_s = pos_s_s + jnp.uint32(1)
    keep = start_s <= end_s
    new_bad = bad_s | ((ovf | ~covered) & keep)
    ns = jnp.where(keep, new_start, start_s)
    ne = jnp.where(keep, new_end, end_s)
    return ns, ne, new_bad, orig_s, wpk_s
