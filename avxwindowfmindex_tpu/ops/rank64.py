"""64-bit occurrence/rank primitives: the capacity-parity device path.

The reference is uint64 end-to-end (AwFmIndex.h:94-109: bwtLength,
prefixSums, seed-table pointers, block baseOccurrences are all u64), so
one index can exceed 2^32 positions. The device engine keeps 32-bit
lanes, so this module represents every 64-bit quantity as a (hi, lo)
pair of uint32 arrays and propagates carries explicitly — the device
analogue of the C library's native u64 arithmetic.

Row layout (pack_device_blocks64): strided bit-planes as in the 32-bit
rows, by default PAIR-FUSED (each row carries blocks b and b+1,
ngram.py style) with little-endian u64 milestones for block b:

    plane i: bytes [i*64, i*64+32) = block b, [i*64+32, i*64+64) = b+1
    nucleotide: [3 planes x 64 B | 5 x u64 milestones | pad] = 256 B
    amino:      [5 planes x 64 B | 21 x u64 milestones | pad] = 512 B

Fusing the partner block costs nothing for nucleotide (the planes land
in what was padding) and lets the post-seed backward step run as ONE
row gather whenever start-1 and end share the 512-position window
(backward_step64_pair; rank.backward_step_pair's contract), instead of
two, as in the 32-bit path (the gain is not measured on the H100).
Single-position ranks read the first-block half of the same rows.

Amino pair rows cost +128 B/block over the compact 384 B layout;
because the wide path exists for HBM-tight capacity cases,
AWFM_PAIR_ROWS=0 keeps the COMPACT single-block layout
(pair_fused=False: plane stride 32, milestones at n_planes*32, classic
two-gather steps). Nucleotide pair rows are free, so they fuse
regardless; the env var still disables pair-step ROUTING there.

Capacity: block indices ride int32 gathers, so the device cap is
2^31 blocks = 2^39 positions (~550 G bases); sampled-SA gathers require
bwtLength / ratio < 2^31. Both are checked at upload.

The 32-bit path (ops/rank.py) remains the throughput path for indexes
under 2^32 positions; to_device() picks automatically. Results are
bit-identical between the two paths (tests/test_index64.py).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..models import alphabet as alpha
from ..models.config import AlphabetType
from ..models.index import (
    POSITIONS_PER_BLOCK,
    num_blocks_from_bwt_length,
)

_BYTE_IOTA = np.arange(32, dtype=np.int32)

_U1 = jnp.uint32(1)
_U0 = jnp.uint32(0)


# ---------------------------------------------------------------------------
# (hi, lo) uint32-pair arithmetic
# ---------------------------------------------------------------------------

def add64(ah, al, bh, bl):
    lo = al + bl
    carry = (lo < al).astype(jnp.uint32)
    return ah + bh + carry, lo


def add64_small(ah, al, s):
    """(ah, al) + s for s a uint32 (no hi component)."""
    lo = al + s
    carry = (lo < al).astype(jnp.uint32)
    return ah + carry, lo


def sub64_small(ah, al, s):
    """(ah, al) - s for s a uint32."""
    lo = al - s
    borrow = (al < s).astype(jnp.uint32)
    return ah - borrow, lo


def sub64(ah, al, bh, bl):
    lo = al - bl
    borrow = (al < bl).astype(jnp.uint32)
    return ah - bh - borrow, lo


def le64(ah, al, bh, bl):
    return (ah < bh) | ((ah == bh) & (al <= bl))


def where64(cond, ah, al, bh, bl):
    return jnp.where(cond, ah, bh), jnp.where(cond, al, bl)


def mul_small64(i, r: int):
    """i * r as a (hi, lo) uint32 pair, for u32 i and static r < 2^16.

    16-bit-limb schoolbook product; used to enumerate dense-SA target
    positions (index * ratio) past 2^32 without u64 device dtypes.
    """
    if not (1 <= r < (1 << 16)):
        raise ValueError("mul_small64 requires a static 1 <= r < 2^16")
    r_u = jnp.uint32(r)
    lo16 = (i & jnp.uint32(0xFFFF)) * r_u
    hi16 = (i >> jnp.uint32(16)) * r_u
    shifted = hi16 << jnp.uint32(16)
    lo = shifted + lo16
    carry = (lo < shifted).astype(jnp.uint32)
    return (hi16 >> jnp.uint32(16)) + carry, lo


def mod_small64(hi, lo, r: int):
    """(hi*2^32 + lo) % r for a static small r (the SA sampling ratio)."""
    r_u = jnp.uint32(r)
    two32_mod = jnp.uint32((1 << 32) % r)
    return ((hi % r_u) * two32_mod + lo % r_u) % r_u


def div_small64(hi, lo, r: int):
    """(hi*2^32 + lo) // r as uint32, for quotients < 2^32.

    Long division in 16-bit limbs; requires hi < r (guaranteed when the
    quotient fits u32). Used for the sampled-SA index (pos // ratio).
    """
    r_u = jnp.uint32(r)
    lh = lo >> 16
    ll = lo & jnp.uint32(0xFFFF)
    t1 = (hi % r_u) * jnp.uint32(1 << 16) + lh
    q1 = t1 // r_u
    t2 = (t1 % r_u) * jnp.uint32(1 << 16) + ll
    q2 = t2 // r_u
    return q1 * jnp.uint32(1 << 16) + q2


def mod_bwt64(h_hi, h_lo, bwt_length: int):
    """h % bwtLength as ONE conditional subtract (hi/lo lanes).

    Callers guarantee h < 2 * bwtLength (the SA-resolve invariant:
    sa < bwtLength and offset < bwtLength, AwFmSuffixArray.c:189-190).
    The over predicate is h >= bwtLength, i.e. NOT(h <= n) OR h == n.
    """
    n_hi = jnp.uint32(bwt_length >> 32)
    n_lo = jnp.uint32(bwt_length & 0xFFFFFFFF)
    over = ~le64(h_hi, h_lo, n_hi, n_lo) | ((h_hi == n_hi) & (h_lo == n_lo))
    w_hi, w_lo = sub64(h_hi, h_lo, n_hi, n_lo)
    return where64(over, w_hi, w_lo, h_hi, h_lo)


def split_u64_host(values: np.ndarray):
    v = values.astype(np.uint64)
    return (v >> np.uint64(32)).astype(np.uint32), (
        v & np.uint64(0xFFFFFFFF)
    ).astype(np.uint32)


# ---------------------------------------------------------------------------
# Device view
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DeviceIndex64:
    """64-bit-capacity device view (hi/lo u32 pairs; u64 milestones)."""

    packed: object  # (num_blocks, row_bytes) uint8, u64 milestones fused
    prefix_hi: object  # (A+2,) uint32
    prefix_lo: object  # (A+2,) uint32
    seed_table: object  # (A**k, 4) uint32: [start_lo, start_hi, end_lo, end_hi]
    sampled_sa: object  # (num_samples, 2) uint32 [lo, hi], or None
    code_masks: object
    vec_to_index: object
    bwt_length: int  # static python int (may exceed 2^32)
    ratio: int
    kmer_length_in_seed_table: int
    alphabet: AlphabetType
    pair_fused: bool = True  # rows carry blocks b,b+1 (plane stride 64)

    @property
    def cardinality(self) -> int:
        return alpha.cardinality(self.alphabet)

    @property
    def sentinel(self) -> int:
        return alpha.sentinel_index(self.alphabet)

    @property
    def n_planes(self) -> int:
        return alpha.num_bit_planes(self.alphabet)

    @property
    def plane_stride(self) -> int:
        return 64 if self.pair_fused else 32

    @property
    def milestone_offset(self) -> int:
        return self.n_planes * self.plane_stride

    @property
    def row_bytes(self) -> int:
        return device_row_bytes64(self.alphabet, self.pair_fused)


jax.tree_util.register_dataclass(
    DeviceIndex64,
    data_fields=[
        "packed",
        "prefix_hi",
        "prefix_lo",
        "seed_table",
        "sampled_sa",
        "code_masks",
        "vec_to_index",
    ],
    meta_fields=[
        "bwt_length",
        "ratio",
        "kmer_length_in_seed_table",
        "alphabet",
        "pair_fused",
    ],
)


def device_row_bytes64(alphabet: AlphabetType, pair: bool = True) -> int:
    n_planes = alpha.num_bit_planes(alphabet)
    stride = 64 if pair else 32
    need = n_planes * stride + (alpha.cardinality(alphabet) + 1) * 8
    return ((need + 127) // 128) * 128


def pack_device_blocks64(
    bwt_letters: np.ndarray,
    milestones: np.ndarray,
    alphabet: AlphabetType,
    pair: bool = True,
) -> np.ndarray:
    """Bit-planes + u64 milestones -> (num_blocks, row_bytes) u8.

    With ``pair`` (default), row b holds plane bytes for blocks b AND
    b+1 (interleaved per plane, ngram.pair_rows_from_ngram_blocks
    style) plus block b's milestones. The final row's missing partner
    keeps zero plane bytes; those pair-local positions lie beyond every
    valid rank position and the inclusive mask zeroes them (same
    argument as ngram.py). ``pair=False`` packs the compact
    single-block layout (stride 32).
    """
    n_planes = alpha.num_bit_planes(alphabet)
    card = alpha.cardinality(alphabet)
    row_bytes = device_row_bytes64(alphabet, pair)
    stride = 64 if pair else 32
    bwt_length = len(bwt_letters)
    nb = num_blocks_from_bwt_length(bwt_length)

    codes = np.zeros(nb * POSITIONS_PER_BLOCK, dtype=np.uint8)
    codes[:bwt_length] = alpha.index_to_vector_lut(alphabet)[bwt_letters]

    out = np.zeros((nb, row_bytes), dtype=np.uint8)
    for b in range(n_planes):
        bits = ((codes >> b) & 1).reshape(nb, POSITIONS_PER_BLOCK)
        plane = np.packbits(bits, axis=1, bitorder="little")
        out[:, b * stride : b * stride + 32] = plane
        if pair:
            out[:-1, b * 64 + 32 : (b + 1) * 64] = plane[1:]
    ms = milestones[:, : card + 1].astype("<u8")
    off = n_planes * stride
    out[:, off : off + (card + 1) * 8] = ms.view(np.uint8).reshape(
        nb, (card + 1) * 8
    )
    return out


# ---------------------------------------------------------------------------
# Rank kernels (mirror ops/rank.py with u64 accumulators)
# ---------------------------------------------------------------------------

def _gather_rows64(dev: DeviceIndex64, pos_hi, pos_lo):
    blk = ((pos_hi << jnp.uint32(24)) | (pos_lo >> jnp.uint32(8))).astype(
        jnp.int32
    )
    local = (pos_lo & jnp.uint32(0xFF)).astype(jnp.int32)
    return dev.packed[blk], local


def _inclusive_mask(local):
    byte_idx = (local >> 3)[:, None]
    bit_idx = (local & 7)[:, None].astype(jnp.uint8)
    low = (jnp.uint8(2) << bit_idx) - jnp.uint8(1)
    b = _BYTE_IOTA[None, :]
    return jnp.where(
        b < byte_idx, jnp.uint8(0xFF), jnp.where(b == byte_idx, low, jnp.uint8(0))
    )


def _code_mask_bytes64(dev, letter_indices):
    lut = np.asarray(alpha.index_to_vector_lut(dev.alphabet))
    out = []
    for i in range(dev.n_planes):
        m = jnp.zeros(letter_indices.shape, dtype=jnp.uint8)
        for j in range(dev.cardinality + 1):
            if (lut[j] >> i) & 1:
                m = m | jnp.where(
                    letter_indices == j, jnp.uint8(0xFF), jnp.uint8(0)
                )
        out.append(m)
    return out


def _match_bytes(dev, rows, letter_indices):
    """Match bits over the FIRST block of each row (32 B per plane)."""
    cms = _code_mask_bytes64(dev, letter_indices)
    stride = dev.plane_stride
    diff = None
    for i in range(dev.n_planes):
        x = rows[:, i * stride : i * stride + 32] ^ cms[i][:, None]
        diff = x if diff is None else (diff | x)
    return ~diff


def _match_bytes_pair64(dev, rows, letter_indices):
    """(B, 64) match bits over a pair row's full 512 positions."""
    cms = _code_mask_bytes64(dev, letter_indices)
    diff = None
    for i in range(dev.n_planes):
        x = rows[:, i * 64 : (i + 1) * 64] ^ cms[i][:, None]
        diff = x if diff is None else (diff | x)
    return ~diff


_WSUM64_CONSTS: dict = {}


def _wsum64_consts(n_words: int):
    """(word_id, lo_weight, hi_weight) for an n_words*8-byte u64
    milestone section: byte k of each little-endian u64 weighs
    2^(8*(k%4)) into the low (k<4) or high (k>=4) u32 half."""
    if n_words not in _WSUM64_CONSTS:
        nb = n_words * 8
        i = np.arange(nb)
        k = i % 8
        wid = (i // 8).astype(np.int32)
        w = (1 << (8 * (k % 4))).astype(np.uint32)
        _WSUM64_CONSTS[n_words] = (
            wid,
            np.where(k < 4, w, 0).astype(np.uint32),
            np.where(k >= 4, w, 0).astype(np.uint32),
        )
    return _WSUM64_CONSTS[n_words]


def _use_ms_wsum() -> bool:
    """Weighted-byte-sum milestone select, default ON — see
    ops/_knobs.py; hi/lo split parity:
    tests/test_index64.py::test_wsum_milestone64_identical."""
    from . import _knobs

    return _knobs.use_ms_wsum()


def _milestone64(dev, rows, letter_indices):
    card = dev.cardinality
    off = dev.milestone_offset
    if _use_ms_wsum():
        wid, wlo, whi = _wsum64_consts(card + 1)
        sect = rows[:, off : off + (card + 1) * 8].astype(jnp.uint32)
        sel = jnp.asarray(wid)[None, :] == letter_indices[:, None]
        out_lo = jnp.sum(
            jnp.where(sel, sect * jnp.asarray(wlo)[None, :], _U0),
            axis=1, dtype=jnp.uint32,
        )
        out_hi = jnp.sum(
            jnp.where(sel, sect * jnp.asarray(whi)[None, :], _U0),
            axis=1, dtype=jnp.uint32,
        )
        return out_hi, out_lo
    raw = rows[:, off : off + (card + 1) * 8].reshape(-1, card + 1, 2, 4)
    words = lax.bitcast_convert_type(raw, jnp.uint32)  # (B, card+1, 2)
    out_lo = jnp.zeros(letter_indices.shape, dtype=jnp.uint32)
    out_hi = jnp.zeros(letter_indices.shape, dtype=jnp.uint32)
    for j in range(card + 1):
        sel = letter_indices == j
        out_lo = out_lo + jnp.where(sel, words[:, j, 0], _U0)
        out_hi = out_hi + jnp.where(sel, words[:, j, 1], _U0)
    return out_hi, out_lo


def _prefix_select64(dev, letter_indices):
    out_lo = jnp.zeros(letter_indices.shape, dtype=jnp.uint32)
    out_hi = jnp.zeros(letter_indices.shape, dtype=jnp.uint32)
    for j in range(dev.cardinality + 2):
        sel = letter_indices == j
        out_lo = out_lo + jnp.where(sel, dev.prefix_lo[j], _U0)
        out_hi = out_hi + jnp.where(sel, dev.prefix_hi[j], _U0)
    return out_hi, out_lo


def _count_rows64(dev, rows, local, letter_indices):
    match = _match_bytes(dev, rows, letter_indices)
    masked = match & _inclusive_mask(local)
    cnt = jnp.sum(lax.population_count(masked), axis=1, dtype=jnp.int32)
    ms_hi, ms_lo = _milestone64(dev, rows, letter_indices)
    return add64_small(ms_hi, ms_lo, cnt.astype(jnp.uint32))


def occurrence64(dev, pos_hi, pos_lo, letter_indices):
    """Batched occ(l, pos) -> (hi, lo), inclusive of pos."""
    rows, local = _gather_rows64(dev, pos_hi, pos_lo)
    return _count_rows64(dev, rows, local, letter_indices)


def backward_step64(
    dev, s_hi, s_lo, e_hi, e_lo, letter_indices, active=None, check_valid=True
):
    """One batched backward step with u64 pointers (AwFmSearch.c:42-159)."""
    b = s_lo.shape[0]
    c_hi, c_lo = _prefix_select64(dev, letter_indices)
    ps_hi, ps_lo = sub64_small(s_hi, s_lo, _U1)
    pos_hi = jnp.concatenate([ps_hi, e_hi])
    pos_lo = jnp.concatenate([ps_lo, e_lo])
    ll = jnp.concatenate([letter_indices, letter_indices])
    occ_hi, occ_lo = occurrence64(dev, pos_hi, pos_lo, ll)
    ns_hi, ns_lo = add64(c_hi, c_lo, occ_hi[:b], occ_lo[:b])
    ne_hi, ne_lo = add64(c_hi, c_lo, occ_hi[b:], occ_lo[b:])
    ne_hi, ne_lo = sub64_small(ne_hi, ne_lo, _U1)
    keep = None
    if check_valid:
        keep = le64(s_hi, s_lo, e_hi, e_lo)
    if active is not None:
        keep = active if keep is None else (active & keep)
    if keep is None:
        return ns_hi, ns_lo, ne_hi, ne_lo
    ns_hi, ns_lo = where64(keep, ns_hi, ns_lo, s_hi, s_lo)
    ne_hi, ne_lo = where64(keep, ne_hi, ne_lo, e_hi, e_lo)
    return ns_hi, ns_lo, ne_hi, ne_lo


# the (B, 64)-byte inclusive pair-window mask is layout-generic — share
# the 32-bit path's implementation
from .rank import _inclusive_mask_pair as _inclusive_mask_pair64


def backward_step64_pair(
    dev, s_hi, s_lo, e_hi, e_lo, letter_indices, bad, active=None
):
    """One-gather u64 backward step; flags ranges wider than the pair
    window (rank.backward_step_pair contract on hi/lo pairs).

    Both occ queries (start-1 and end) are served from the pair row of
    start-1's block. Rows whose end lies beyond the 512-position window
    get a clamped (wrong) end and are FLAGGED for the caller's exact
    re-run through backward_step64. Requires the pair-fused layout.
    """
    if not dev.pair_fused:
        raise ValueError(
            "backward_step64_pair requires the pair-fused row layout "
            "(pack with pair=True / unset AWFM_PAIR_ROWS=0)"
        )
    c_hi, c_lo = _prefix_select64(dev, letter_indices)
    ps_hi, ps_lo = sub64_small(s_hi, s_lo, _U1)
    base = ((ps_hi << jnp.uint32(24)) | (ps_lo >> jnp.uint32(8))).astype(
        jnp.int32
    )
    local_s = (ps_lo & jnp.uint32(0xFF)).astype(jnp.int32)
    # end relative to the pair window start (u64 subtract)
    ws_lo = ps_lo & ~jnp.uint32(0xFF)
    d_hi, d_lo = sub64(e_hi, e_lo, ps_hi, ws_lo)
    overflow = (d_hi != _U0) | (d_lo >= jnp.uint32(512))
    local_e = jnp.minimum(d_lo, jnp.uint32(511)).astype(jnp.int32)

    rows = dev.packed[base]
    match = _match_bytes_pair64(dev, rows, letter_indices)
    occ_s = jnp.sum(
        lax.population_count(match & _inclusive_mask_pair64(local_s)),
        axis=1,
        dtype=jnp.int32,
    )
    occ_e = jnp.sum(
        lax.population_count(match & _inclusive_mask_pair64(local_e)),
        axis=1,
        dtype=jnp.int32,
    )
    ms_hi, ms_lo = _milestone64(dev, rows, letter_indices)
    b_hi, b_lo = add64(c_hi, c_lo, ms_hi, ms_lo)
    ns_hi, ns_lo = add64_small(b_hi, b_lo, occ_s.astype(jnp.uint32))
    ne_hi, ne_lo = add64_small(b_hi, b_lo, occ_e.astype(jnp.uint32))
    ne_hi, ne_lo = sub64_small(ne_hi, ne_lo, _U1)

    keep = le64(s_hi, s_lo, e_hi, e_lo)
    if active is not None:
        keep = keep & active
    bad = bad | (overflow & keep)
    ns_hi, ns_lo = where64(keep, ns_hi, ns_lo, s_hi, s_lo)
    ne_hi, ne_lo = where64(keep, ne_hi, ne_lo, e_hi, e_lo)
    return ns_hi, ns_lo, ne_hi, ne_lo, bad


def letter_and_lf_at64(dev, pos_hi, pos_lo):
    """BWT letter + LF mapping at each position (AwFmSearch.c:369-427)."""
    rows, local = _gather_rows64(dev, pos_hi, pos_lo)
    byte_idx = (local >> 3)[:, None]
    bit_idx = (local & 7)[:, None].astype(jnp.uint8)
    onehot = jnp.where(
        _BYTE_IOTA[None, :] == byte_idx, jnp.uint8(1) << bit_idx, jnp.uint8(0)
    )
    code = jnp.zeros(pos_lo.shape, dtype=jnp.int32)
    stride = dev.plane_stride
    for i in range(dev.n_planes):
        hit = jnp.sum(
            lax.population_count(rows[:, i * stride : i * stride + 32] & onehot),
            axis=1,
            dtype=jnp.int32,
        )
        code = code | (hit << i)
    v2i = np.asarray(alpha.vector_to_index_lut(dev.alphabet))
    lett = jnp.zeros(pos_lo.shape, dtype=jnp.int32)
    for v in range(1 << dev.n_planes):
        if v2i[v]:
            lett = lett + jnp.where(code == v, jnp.int32(v2i[v]), jnp.int32(0))
    is_sentinel = lett == dev.sentinel
    lclip = jnp.minimum(lett, dev.cardinality)
    occ_hi, occ_lo = _count_rows64(dev, rows, local, lclip)
    c_hi, c_lo = _prefix_select64(dev, lclip)
    lf_hi, lf_lo = add64(c_hi, c_lo, occ_hi, occ_lo)
    lf_hi, lf_lo = sub64_small(lf_hi, lf_lo, _U1)
    lf_hi = jnp.where(is_sentinel, _U0, lf_hi)
    lf_lo = jnp.where(is_sentinel, _U0, lf_lo)
    return lett, lf_hi, lf_lo
