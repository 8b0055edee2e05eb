"""Two-LF-steps-per-gather backtrace rows (nucleotide locate fast path).

The locate backtrace walks LF until a sampled position
(AwFmParallelSearch.c:343-354); each masked LF step costs one block-row
gather, the memory-bound unit of work. This module halves the
gathers: a dedicated digram table whose code at BWT position p is

    code(p) = l1 | (l2 << 3),   l1 = BWT[p],  l2 = BWT[LF(p)]

(i.e. T[SA[p]-1] in the low 3 bits and T[SA[p]-2] in the high 3 — the
FULL letter product including ambiguity 'x' and the sentinel, unlike the
search digram in ops/ngram.py which collapses those to one dirty symbol
and so cannot reconstruct single-letter occurrences). From ONE gathered
row, a position's backtrace learns

    l1, l2   by extracting one bit per plane at the local position,
    LF(p)    = C[l1]  + occ1(l1, p) - 1   (3-plane match: low bits == l1),
    LF2(p)   = C2[w]  + occ2(w,  p) - 1   (6-plane match: code == w),

so each gather advances TWO LF steps, stopping at LF(p) when that
intermediate position is sampled. Both formulas are the standard
backward step; occ1 works because every position's low code bits are its
BWT letter (no dirty collapse), and its milestone is the sum of the six
(l2', l1) word milestones. Sentinels keep the reference rules: l1
sentinel => LF(p)=0 (AwFmSearch.c:384-386); l2 sentinel => LF2(p)=0
(LF of the BWT's sentinel position).

Row layout, 384 bytes per 256-position block, stored as 96 uint32 words:

    words [ 0, 48): 6 bit-planes x 8 words (256 positions each)
    words [48, 96): 48 uint32 word milestones (36 used: l2,l1 in 0..5)

Memory: 1.5 bytes/position (96 MB at 64M bases, ~4.7 GB at hg38) — an
opt-in locate accelerator; engines fall back to single-step LF rows when
it is absent. Nucleotide only (amino pairs would need 10 planes and
1 KB rows, past the measured row-gather cliff).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..models.config import AlphabetType
from ..models.index import FmIndex, POSITIONS_PER_BLOCK, num_blocks_from_bwt_length
from .ngram import _HOST_CHUNK, _lf_array, _letter_counts_before

N_PLANES = 6
N_CODES = 48  # stride-8 code space; 36 slots used
_PAD_CODE = 7  # l1 = 7 matches no real letter; pad tail positions
_WORD_IOTA = np.arange(8, dtype=np.int32)  # u32 words per plane
_CODE_IOTA = np.arange(48, dtype=np.int32)
PLANE_WORDS = 8
MS_WORD_OFFSET = N_PLANES * PLANE_WORDS  # 48
ROW_WORDS = MS_WORD_OFFSET + N_CODES  # 96 (384 bytes)


@dataclasses.dataclass
class BacktraceDigramIndex:
    """Device arrays for the pair-LF backtrace (registered pytree).

    ``packed`` rows carry BAKED milestones: stored word w's milestone is
    raw_milestone[w] + C2[w], so LF2 needs no separate C2 select. The
    single-letter milestone derived by summing a letter's six word
    columns then over-counts by K[l1] = sum_l2 C2[(l2<<3)|l1] — a
    constant per l1 — which ``c1k[l1] = C[l1] - K[l1]`` cancels (uint32
    arithmetic is modular, so the intermediate wrap is harmless).
    """

    packed: object  # (num_blocks, 96) uint32 rows (milestones + C2 baked)
    c1k: object  # (8,) uint32: C[l1] - sum_l2 C2[(l2<<3)|l1]


jax.tree_util.register_dataclass(
    BacktraceDigramIndex, data_fields=["packed", "c1k"], meta_fields=[]
)

def build_backtrace_digram_host(index: FmIndex):
    """(codes, c2): per-position pair codes and word range starts.

    c2[(l2<<3)|l1] = C[l2] + occ(l2, [0, S(l1))) with S(l1) the start of
    l1's suffix range (prefixSums[l1]; the sentinel's range starts at 0)
    — the backward-step fold of the full l1 range by letter l2.
    """
    if index.alphabet == AlphabetType.AMINO:
        raise NotImplementedError("pair-LF backtrace is nucleotide-only")
    bwt = index.bwt_letters  # uint8, letters 0..5
    length = index.bwt_length
    sentinel = index.sentinel_index  # 5

    lf = _lf_array(index)
    codes = np.empty(length, dtype=np.uint8)
    for lo in range(0, length, _HOST_CHUNK):
        hi = min(lo + _HOST_CHUNK, length)
        l2 = bwt[lf[lo:hi]]
        codes[lo:hi] = bwt[lo:hi] | (l2 << np.uint8(3))
    del lf

    ps = index.prefix_sums.astype(np.int64)
    thresholds = [int(ps[l1]) for l1 in range(sentinel)] + [0]  # S(l1)
    occ = _letter_counts_before(bwt, thresholds, n_letters=sentinel)
    c2 = np.zeros(N_CODES, dtype=np.uint64)
    for l2 in range(sentinel):  # sentinel-l2 words are forced to 0 on device
        for l1 in range(sentinel + 1):
            c2[(l2 << 3) | l1] = np.uint64(int(ps[l2]) + int(occ[l2, l1]))
    return codes, c2


def pack_backtrace_blocks(codes: np.ndarray) -> np.ndarray:
    """codes -> (num_blocks, 384) uint8 fused rows (planes + milestones)."""
    length = len(codes)
    nb = num_blocks_from_bwt_length(length)
    padded = np.full(nb * POSITIONS_PER_BLOCK, _PAD_CODE, dtype=np.uint8)
    padded[:length] = codes

    out = np.zeros((nb, ROW_WORDS * 4), dtype=np.uint8)
    for b in range(N_PLANES):
        bits = ((padded >> b) & 1).reshape(nb, POSITIONS_PER_BLOCK)
        out[:, b * 32 : (b + 1) * 32] = np.packbits(
            bits, axis=1, bitorder="little"
        )
    # one chunked bincount pass over (block, code) keys instead of 48
    # full-array equality scans; uint64 accumulators, ~1/48th the memory
    # traffic at the hg38-scale target
    counts = np.zeros(nb * 64, dtype=np.int64)
    for lo in range(0, nb * POSITIONS_PER_BLOCK, _HOST_CHUNK):
        # chunks are whole blocks (_HOST_CHUNK % 256 == 0), so each
        # bincount covers a contiguous (chunk_blocks, 64) slice — the
        # temporary stays ~the chunk size, not nb*64
        hi = min(lo + _HOST_CHUNK, nb * POSITIONS_PER_BLOCK)
        keys = (np.arange(hi - lo, dtype=np.int64) >> 8) << 6
        keys |= padded[lo:hi]
        span = ((hi - lo) // POSITIONS_PER_BLOCK) * 64
        counts[(lo >> 8) * 64 : (lo >> 8) * 64 + span] += np.bincount(
            keys, minlength=span
        )
        del keys
    counts = counts.reshape(nb, 64)[:, :N_CODES]
    cum = np.cumsum(counts, axis=0)
    milestones = np.zeros_like(cum)
    milestones[1:] = cum[:-1]
    ms_off = MS_WORD_OFFSET * 4
    out[:, ms_off:] = (
        milestones.astype("<u4").view(np.uint8).reshape(nb, N_CODES * 4)
    )
    return out


def build_backtrace_digram_device(index: FmIndex) -> BacktraceDigramIndex:
    codes, c2 = build_backtrace_digram_host(index)
    blocks = pack_backtrace_blocks(codes)
    del codes
    words = blocks.view("<u4").reshape(blocks.shape[0], -1)
    # bake C2 into the stored milestones (see class docstring)
    c2_u32 = c2.astype(np.uint32)
    words[:, MS_WORD_OFFSET:] += c2_u32[None, :]
    c1 = np.zeros(8, dtype=np.uint32)
    ps = index.prefix_sums
    c1[: len(ps)] = ps.astype(np.uint32)
    k = c2_u32.reshape(6, 8).sum(axis=0, dtype=np.uint32)  # K[l1]
    return BacktraceDigramIndex(
        packed=jnp.asarray(words),
        c1k=jnp.asarray(c1 - k),
    )


# ---------------------------------------------------------------------------
# Device kernel
# ---------------------------------------------------------------------------

def _inclusive_mask_u32(local):
    """(B, 8) uint32 mask keeping bits 0..local inclusive, local in [0,256)."""
    word_idx = (local >> 5)[:, None]
    bit = (local & 31)[:, None].astype(jnp.uint32)
    low = (jnp.uint32(2) << bit) - jnp.uint32(1)  # 2<<31 wraps to all-ones
    w = _WORD_IOTA[None, :]
    return jnp.where(
        w < word_idx,
        jnp.uint32(0xFFFFFFFF),
        jnp.where(w == word_idx, low, jnp.uint32(0)),
    )


def _plane(rows, i):
    return rows[:, i * PLANE_WORDS : (i + 1) * PLANE_WORDS]


def _diff(rows, value, planes):
    """(B, 8) uint32 accumulated XOR-diff over ``planes`` for the per-row
    ``value``; zero bits mark matching positions (invert for match)."""
    diff = None
    for i in planes:
        m = jnp.where(
            ((value >> i) & 1) == 1, jnp.uint32(0xFFFFFFFF), jnp.uint32(0)
        )
        x = _plane(rows, i) ^ m[:, None]
        diff = x if diff is None else (diff | x)
    return diff


def pair_lf_at(bt: BacktraceDigramIndex, positions, sentinel: int = 5):
    """One gather -> (lf1, lf2) = (LF(p), LF(LF(p))) for each position.

    lf1 matches rank.letter_and_lf_at exactly (sentinel -> 0); lf2 is
    exact whenever lf1 is not the walk's stopping point (callers check
    lf1's sampledness first, so a sentinel at lf1 — which IS position 0,
    always sampled — never exposes lf2).
    """
    blk = (positions // POSITIONS_PER_BLOCK).astype(jnp.int32)
    local = (positions % POSITIONS_PER_BLOCK).astype(jnp.int32)
    rows = bt.packed[blk]

    word_idx = (local >> 5)[:, None]
    bit = (local & 31)[:, None].astype(jnp.uint32)
    onehot = jnp.where(
        _WORD_IOTA[None, :] == word_idx, jnp.uint32(1) << bit, jnp.uint32(0)
    )
    code = jnp.zeros(positions.shape, dtype=jnp.int32)
    for i in range(N_PLANES):
        hit = jnp.sum(
            lax.population_count(_plane(rows, i) & onehot),
            axis=1,
            dtype=jnp.int32,
        )
        code = code | (hit << i)
    l1 = code & 7
    l2 = code >> 3

    mask = _inclusive_mask_u32(local)
    # the low-3-plane diff serves BOTH matches (code's low bits are l1),
    # so planes 0..2 are XOR/OR'd once, not twice — this kernel does
    # more arithmetic per gather than the single-step one
    diff3 = _diff(rows, l1, range(3))
    diff6 = diff3 | _diff(rows, code, range(3, N_PLANES))
    pc2 = jnp.sum(
        lax.population_count(~diff6 & mask), axis=1, dtype=jnp.int32
    ).astype(jnp.uint32)
    pc1 = jnp.sum(
        lax.population_count(~diff3 & mask), axis=1, dtype=jnp.int32
    ).astype(jnp.uint32)

    # milestone selection as two masked (B, 48) reductions, not
    # per-column slicing loops
    ms = rows[:, MS_WORD_OFFSET:]  # baked: raw milestone + C2
    sel2 = code[:, None] == _CODE_IOTA[None, :]
    ms2c2 = jnp.sum(jnp.where(sel2, ms, jnp.uint32(0)), axis=1)
    sel1 = l1[:, None] == (_CODE_IOTA & 7)[None, :]
    ms1k = jnp.sum(jnp.where(sel1, ms, jnp.uint32(0)), axis=1)
    c1kv = jnp.zeros(positions.shape, dtype=jnp.uint32)
    for l1v in range(sentinel + 1):
        c1kv = c1kv + jnp.where(l1 == l1v, bt.c1k[l1v], jnp.uint32(0))

    lf1 = jnp.where(
        l1 == sentinel, jnp.uint32(0), c1kv + ms1k + pc1 - jnp.uint32(1)
    )
    lf2 = jnp.where(
        l2 == sentinel, jnp.uint32(0), ms2c2 + pc2 - jnp.uint32(1)
    )
    return lf1, lf2
