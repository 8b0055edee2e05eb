"""The FM-index data model.

The reference stores the BWT as 256-position blocks of strided bit-plane
SIMD vectors with per-block occurrence milestones (AwFmIndex.h:55-65).
That layout is a *latency* optimization for cache-line pointer chasing.

The device layout keeps the same information in device-friendly
shapes (SURVEY.md §7 design stance):

  - ``letters``      (num_blocks, 256) int8   — BWT letter index per
    position. Rank = gather block row + masked compare + sum.
  - ``milestones``   (num_blocks, A+1) uint32 — per-letter occurrence
    count at each block start (the reference's baseOccurrences).
  - ``prefix_sums``  (A+2,) uint32            — cumulative letter counts
    with the sentinel counted into prefix_sums[0]=1 (AwFmCreate.c:338-344).
  - ``seed_table``   (A**k, 2) uint32         — memoized BWT range of
    every k-length suffix (AwFmCreate.c:407-450).
  - ``sampled_sa``   (ceil(bwtLen/ratio),) uint32 — suffix-array samples
    at BWT positions ≡ 0 (mod ratio) (AwFmSuffixArray.c:76-77).

Positions are uint32 on device (covers hg38 + sentinel); the host model
keeps int64/uint64 NumPy arrays and is the serde source of truth.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from . import alphabet as alpha
from .config import (
    CURRENT_VERSION_NUMBER,
    FEATURE_FLAG_BIT_FASTA_VECTOR,
    AlphabetType,
    IndexConfiguration,
)

POSITIONS_PER_BLOCK = alpha.POSITIONS_PER_BLOCK


# ---------------------------------------------------------------------------
# Geometry helpers (AwFmIndexStruct.c:77-130)
# ---------------------------------------------------------------------------

def block_index_from_position(position):
    """pos // 256 (AwFmIndexStruct.c:117-119)."""
    return position // POSITIONS_PER_BLOCK


def local_position_in_block(position):
    """pos % 256 (AwFmIndexStruct.c:121-124)."""
    return position % POSITIONS_PER_BLOCK


def num_blocks_from_bwt_length(bwt_length: int) -> int:
    """1 + (len-1)//256 (AwFmIndexStruct.c:104-106)."""
    return 1 + (bwt_length - 1) // POSITIONS_PER_BLOCK


def search_range_length(start, end):
    """end - start + 1 if valid else 0 (AwFmIndexStruct.c:126-130)."""
    start = np.asarray(start)
    end = np.asarray(end)
    return np.where(start <= end, end - start + 1, 0)


def search_range_is_valid(start, end):
    """startPtr <= endPtr (AwFmIndexStruct.c:99-102)."""
    return start <= end


def prefix_sums_length(alphabet: AlphabetType) -> int:
    """|A| + 2 (AwFmIndexStruct.c:108-111)."""
    return alpha.cardinality(alphabet) + 2


def kmer_table_length(alphabet: AlphabetType, k: int) -> int:
    """|A| ** k (AwFmIndexStruct.c:77-86)."""
    return alpha.cardinality(alphabet) ** k


def sampled_sa_length(bwt_length: int, ratio: int) -> int:
    """ceil(bwtLength / ratio) (AwFmSuffixArray.c:144-147)."""
    return (bwt_length + ratio - 1) // ratio


# ---------------------------------------------------------------------------
# FASTA metadata (FastaVector equivalent)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FastaMetadata:
    """Multi-sequence metadata, equivalent to the reference's FastaVector
    header/metadata vectors (used at AwFmCreate.c:162-196,
    AwFmSearch.c:284-315, AwFmFile.c:157-187).

    ``headers`` is the concatenated header text; ``header_ends`` and
    ``sequence_ends`` are cumulative end offsets per sequence (exclusive),
    matching FastaVectorMetadata's {headerEndPosition, sequenceEndPosition}.
    """

    headers: bytes
    header_ends: np.ndarray  # (num_seqs,) uint64, cumulative exclusive ends
    sequence_ends: np.ndarray  # (num_seqs,) uint64, cumulative exclusive ends

    @property
    def num_sequences(self) -> int:
        return len(self.sequence_ends)

    def get_header(self, sequence_number: int) -> bytes:
        if not 0 <= sequence_number < self.num_sequences:
            # the reference's size_t sequenceNumber makes a negative
            # argument fail its bounds check (AwFmIllegalPositionError,
            # AwFmSearch.c:303-315); Python indexing must not silently
            # return the wrong record's header
            raise IndexError(
                f"sequence number {sequence_number} out of range "
                f"[0, {self.num_sequences})"
            )
        start = 0 if sequence_number == 0 else int(self.header_ends[sequence_number - 1])
        return self.headers[start:int(self.header_ends[sequence_number])]

    def local_position_from_global(self, global_position):
        """Global concatenated position -> (sequence_number, local_position).

        Vectorized equivalent of fastaVectorGetLocalSequencePositionFromGlobal
        (used at AwFmSearch.c:284-301): searchsorted over cumulative ends.
        """
        pos = np.asarray(global_position, dtype=np.uint64)
        seq_num = np.searchsorted(self.sequence_ends, pos, side="right")
        starts = np.concatenate([[0], self.sequence_ends[:-1]]).astype(np.uint64)
        local = pos - starts[seq_num]
        return seq_num, local


# ---------------------------------------------------------------------------
# Device-side view
# ---------------------------------------------------------------------------
#
# The device layout fuses each BWT block into ONE row of uint8 lanes:
#
#   nucleotide: [plane0 x32B | plane1 x32B | plane2 x32B |
#                milestones 5 x u32LE | pad] = 128 B  (128 lanes)
#   amino:      [plane0..plane4 x32B | milestones 21 x u32LE | pad]
#               = 256 B  (2 x 128 lanes)
#
# Plane byte j holds local positions j*8..j*8+7, bit p%8 = position bit
# (the same strided information as the reference's 256-bit SIMD planes,
# AwFmIndex.h:55-65). One gather fetches planes AND milestones; rank is
# then XOR/OR/NOT + population_count on uint8 lanes — the device's
# masked popcount (AwFmSimdConfig.c:89-114 equivalent, inclusive).
#
# uint8 with a 128-element row was the faster row-gather shape on the
# accelerator this layout was first tuned on; u8 vs u32 lanes is not
# measured on the H100 (ROADMAP A4).


@dataclasses.dataclass
class DeviceIndex:
    """Device (jax.Array) view of the index, ready for batched search.

    Registered as a jax pytree: array fields are leaves, geometry fields
    are static metadata (hashed into jit caches).

    ``packed_pair`` is the PAIR-ROW table: row b fuses the bit-planes of
    blocks b AND b+1 (512 consecutive positions) plus block b's
    milestones. After seeding, search ranges are nearly always narrower
    than one block, so start-1 and end land inside one pair row and a
    backward step needs ONE row gather instead of two (the gain is not
    measured on the H100). The reference fetches two blocks per step
    (AwFmSearch.c:57-58).

    ``ratio`` is the DEVICE sampling ratio of ``sampled_sa``; it equals
    the config's saCompressionRatio unless a denser device-side SA was
    requested (the in-memory-SA speed knob, README.md:207-213 analogue).
    """

    packed: object  # (num_blocks, row_bytes) uint8 fused blocks
    packed_pair: object  # (num_blocks, 2*row_bytes) uint8 pair rows, or None
    prefix_sums: object  # (A+2,) uint32
    seed_table: object  # (A**k, 2) uint32
    sampled_sa: object  # (num_samples,) uint32, or None (SA on disk)
    code_masks: object  # (A+2, n_planes) uint8 full-byte letter code masks
    vec_to_index: object  # (2**n_planes,) int32 compressed-code -> letter
    bwt_length: int
    ratio: int
    kmer_length_in_seed_table: int
    alphabet: AlphabetType

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
    def milestone_offset(self) -> int:
        """Byte offset of the milestone u32 array within a row."""
        return self.n_planes * 32

    @property
    def row_bytes(self) -> int:
        return device_row_bytes(self.alphabet)


def device_row_bytes(alphabet: AlphabetType) -> int:
    """Bytes per fused block row: planes*32 + milestones*4, padded to a
    multiple of 128 (one full uint8 lane row)."""
    n_planes = alpha.num_bit_planes(alphabet)
    need = n_planes * 32 + (alpha.cardinality(alphabet) + 1) * 4
    return ((need + 127) // 128) * 128


def _register_device_index_pytree():
    import jax

    jax.tree_util.register_dataclass(
        DeviceIndex,
        data_fields=[
            "packed",
            "packed_pair",
            "prefix_sums",
            "seed_table",
            "sampled_sa",
            "code_masks",
            "vec_to_index",
        ],
        meta_fields=["bwt_length", "ratio", "kmer_length_in_seed_table", "alphabet"],
    )


_register_device_index_pytree()


def pack_device_blocks(
    bwt_letters: np.ndarray, milestones: np.ndarray, alphabet: AlphabetType
) -> np.ndarray:
    """Fuse bit-planes + milestones into (num_blocks, row_bytes) uint8."""
    n_planes = alpha.num_bit_planes(alphabet)
    card = alpha.cardinality(alphabet)
    row_bytes = device_row_bytes(alphabet)
    bwt_length = len(bwt_letters)
    nb = num_blocks_from_bwt_length(bwt_length)

    codes = np.zeros(nb * POSITIONS_PER_BLOCK, dtype=np.uint8)
    codes[:bwt_length] = alpha.index_to_vector_lut(alphabet)[bwt_letters]

    out = np.zeros((nb, row_bytes), dtype=np.uint8)
    for b in range(n_planes):
        bits = ((codes >> b) & 1).reshape(nb, POSITIONS_PER_BLOCK)
        out[:, b * 32 : (b + 1) * 32] = np.packbits(
            bits, axis=1, bitorder="little"
        )
    ms = milestones[:, : card + 1].astype("<u4")
    out[:, n_planes * 32 : n_planes * 32 + (card + 1) * 4] = ms.view(
        np.uint8
    ).reshape(nb, (card + 1) * 4)
    return out


def device_pair_row_bytes(alphabet: AlphabetType) -> int:
    """Bytes per pair row: planes*64 + milestones*4, padded to 128."""
    n_planes = alpha.num_bit_planes(alphabet)
    need = n_planes * 64 + (alpha.cardinality(alphabet) + 1) * 4
    return ((need + 127) // 128) * 128


def pack_pair_rows_from_blocks(
    packed: np.ndarray, alphabet: AlphabetType
) -> np.ndarray:
    """Derive the pair-row table from the per-block fused rows.

    Pair row b = plane bytes of blocks b,b+1 interleaved per plane
    (plane i covers pair-local positions 0..511 at bytes
    [i*64, (i+1)*64)) + block b's milestones. The final row's missing
    partner is zero planes — code 0 is not a queryable letter's code in
    either alphabet, so it can never produce a false match.
    """
    n_planes = alpha.num_bit_planes(alphabet)
    card = alpha.cardinality(alphabet)
    nb = packed.shape[0]
    row_bytes = device_pair_row_bytes(alphabet)
    out = np.zeros((nb, row_bytes), dtype=np.uint8)
    for i in range(n_planes):
        plane = packed[:, i * 32 : (i + 1) * 32]
        out[:, i * 64 : i * 64 + 32] = plane
        out[:-1, i * 64 + 32 : (i + 1) * 64] = plane[1:]
    ms_off = n_planes * 32
    ms_len = (card + 1) * 4
    out[:, n_planes * 64 : n_planes * 64 + ms_len] = packed[
        :, ms_off : ms_off + ms_len
    ]
    return out


def device_code_masks(alphabet: AlphabetType) -> np.ndarray:
    """(A+2, n_planes) uint8: 0xFF/0x00 mask per code bit per letter."""
    lut = alpha.index_to_vector_lut(alphabet)
    n_planes = alpha.num_bit_planes(alphabet)
    bits = (lut[:, None] >> np.arange(n_planes)[None, :]) & 1
    return (bits * np.uint8(0xFF)).astype(np.uint8)


# ---------------------------------------------------------------------------
# Host-side canonical index
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FmIndex:
    """Host-canonical FM index (struct AwFmIndex, AwFmIndex.h:94-109).

    Holds NumPy arrays; use :meth:`to_device` for the search-ready jax view.
    """

    config: IndexConfiguration
    bwt_length: int
    bwt_letters: np.ndarray  # (bwt_length,) uint8 letter indices
    prefix_sums: np.ndarray  # (A+2,) uint64
    # (A**k, 2) uint64 [start, end]; may be None while the table lives
    # only on device (built there) — use seed_table_host() to access.
    kmer_seed_table: Optional[np.ndarray]
    sampled_sa: Optional[np.ndarray]  # (num_samples,) uint64; None if on disk
    version_number: int = CURRENT_VERSION_NUMBER
    feature_flags: int = 0
    sequence: Optional[bytes] = None  # original (unsanitized) sequence
    fasta_metadata: Optional[FastaMetadata] = None
    file_path: Optional[str] = None  # backing .awfmi file, if any
    # the 8 pad bytes trailing the packed-SA region: the reference's
    # in-place packer leaves full-SA leftovers there (AwFmSuffixArray.c:
    # 58-112); kept for byte-identical .awfmi output (io/awfmi.py)
    sa_guard_bytes: bytes = b"\x00" * 8
    suffix_array_file_offset: Optional[int] = None
    sequence_file_offset: Optional[int] = None
    # Denser DEVICE-side suffix-array samples (the device analogue of the
    # reference's memory-for-locate-speed trade, README.md:207-213):
    # sampled at device_sa_ratio < saCompressionRatio when requested at
    # build (create_index(device_sa_ratio=...)). NOT serialized — the
    # .awfmi file keeps the config ratio and stays byte-compatible; a
    # file-loaded index cannot densify without rebuilding (the full SA
    # exists only during construction, exactly as in the reference).
    device_sa: Optional[np.ndarray] = dataclasses.field(
        default=None, repr=False, compare=False
    )
    device_sa_ratio: Optional[int] = None
    _device_cache: Optional[DeviceIndex] = dataclasses.field(
        default=None, repr=False, compare=False
    )

    # -- basic getters ------------------------------------------------------

    @property
    def alphabet(self) -> AlphabetType:
        return self.config.alphabet_type

    @property
    def cardinality(self) -> int:
        return alpha.cardinality(self.alphabet)

    @property
    def sentinel_index(self) -> int:
        return alpha.sentinel_index(self.alphabet)

    @property
    def num_blocks(self) -> int:
        return num_blocks_from_bwt_length(self.bwt_length)

    @property
    def contains_fasta_vector(self) -> bool:
        """featureFlags bit 0 (AwFmIndexStruct.c:136-139)."""
        return bool(self.feature_flags & (1 << FEATURE_FLAG_BIT_FASTA_VECTOR))

    def num_sequences(self) -> int:
        """awFmGetNumSequences (AwFmIndexStruct.c:149-155)."""
        if self.fasta_metadata is not None:
            return self.fasta_metadata.num_sequences
        return 1

    def bwt_position_is_sampled(self, position) -> np.ndarray:
        """pos % ratio == 0 (AwFmIndexStruct.c:88-91)."""
        return np.asarray(position) % self.config.suffix_array_compression_ratio == 0

    def seed_table_host(self) -> np.ndarray:
        """The (A**k, 2) uint64 seed table, materializing from device if
        it was built there (only serde and host-side inspection need
        it)."""
        if self.kmer_seed_table is None:
            if self._device_cache is None:
                raise ValueError("index has no seed table (not yet built)")
            k = int(self.config.kmer_length_in_seed_table)
            if self._device_cache.seed_table.shape[0] != self.cardinality**k:
                # to_device() installs a (1, N) zeros placeholder until
                # the builder attaches the real table — serializing it
                # would silently write a bogus 16-byte seed table
                raise ValueError("index has no seed table (not yet built)")
            st = np.asarray(self._device_cache.seed_table).astype(np.uint64)
            if st.shape[1] == 4:  # wide layout: [s_lo, s_hi, e_lo, e_hi]
                st = np.stack(
                    [(st[:, 1] << 32) | st[:, 0], (st[:, 3] << 32) | st[:, 2]],
                    axis=1,
                )
            self.kmer_seed_table = st
        return self.kmer_seed_table

    # -- host-side milestone/rank helpers (used by builders & oracles) ------

    def letters_as_blocks(self) -> np.ndarray:
        """(num_blocks, 256) uint8, tail padded with the sentinel index."""
        n_blocks = self.num_blocks
        padded = np.full(n_blocks * POSITIONS_PER_BLOCK, self.sentinel_index, np.uint8)
        padded[: self.bwt_length] = self.bwt_letters
        return padded.reshape(n_blocks, POSITIONS_PER_BLOCK)

    def milestones(self) -> np.ndarray:
        """(num_blocks, A+2) uint64 occurrence counts at block starts.

        Column j = count of letter j in bwt_letters[: 256*block].
        Includes the ambiguity letter (col A) and sentinel (col A+1),
        mirroring baseOccurrences (AwFmCreate.c:309, 366).
        """
        n_letters = self.cardinality + 2
        # per-letter per-block sums over the (nb, 256) uint8 view: avoids
        # the O(bwt_length) int64 key temporaries a flat bincount needs
        # (~50 GB transient at hg38 scale)
        blocks_mat = self.letters_as_blocks()
        if self.bwt_length % POSITIONS_PER_BLOCK:
            # mask the sentinel-padded tail out of the counts
            blocks_mat = blocks_mat.copy()
            blocks_mat.reshape(-1)[self.bwt_length :] = 255
        counts = np.empty((self.num_blocks, n_letters), dtype=np.uint64)
        for lett in range(n_letters):
            counts[:, lett] = (blocks_mat == lett).sum(axis=1)
        cum = np.cumsum(counts, axis=0)
        milestones = np.zeros_like(cum)
        milestones[1:] = cum[:-1]
        return milestones

    # -- device view --------------------------------------------------------

    def to_device(
        self, refresh: bool = False, wide: Optional[bool] = None
    ) -> DeviceIndex:
        """Upload the search-critical arrays to the default device(s).

        ``wide`` selects the 64-bit-capacity device layout (hi/lo u32
        pairs, u64 milestones — ops/rank64.py); by default it is chosen
        automatically for bwtLength >= 2^32, restoring the reference's
        u64 capacity (AwFmIndex.h:94-109). The 32-bit layout stays the
        throughput path for everything smaller.
        """
        import jax.numpy as jnp

        if wide is None:
            wide = self.bwt_length >= 2**32
        if self._device_cache is not None and not refresh:
            is_wide = not isinstance(self._device_cache, DeviceIndex)
            if is_wide == wide:
                return self._device_cache
        if wide:
            return self._to_device_wide()
        if self.bwt_length >= 2**32:
            raise ValueError(
                "bwtLength >= 2**32 requires the 64-bit device layout "
                "(to_device(wide=True), chosen automatically)"
            )
        import os

        packed = pack_device_blocks(self.bwt_letters, self.milestones(), self.alphabet)
        # pair rows: the one-gather backward step (default on; 2x the
        # packed table's bytes — AWFM_PAIR_ROWS=0 trades the speed back)
        pair = None
        if os.environ.get("AWFM_PAIR_ROWS", "1") != "0":
            pair = jnp.asarray(pack_pair_rows_from_blocks(packed, self.alphabet))
        if self.kmer_seed_table is not None:
            seed_dev = jnp.asarray(self.kmer_seed_table.astype(np.uint32))
        elif isinstance(self._device_cache, DeviceIndex):
            seed_dev = self._device_cache.seed_table  # device-built table
        elif self._device_cache is not None:
            # wide cache: (A^k, 4) [s_lo, s_hi, e_lo, e_hi] — narrow it
            # (values < 2^32 here by construction; the hi words are 0)
            st64 = self._device_cache.seed_table
            seed_dev = jnp.stack([st64[:, 0], st64[:, 2]], axis=1)
        else:
            # placeholder until the builder attaches the real table
            seed_dev = jnp.zeros((1, 2), dtype=jnp.uint32)
        # denser device-side SA (device_sa_ratio < config ratio) when it
        # was requested at build: shortens every LF backtrace chain at
        # HBM cost, results identical (tests/test_locate.py)
        dev_sa = self.sampled_sa
        dev_ratio = int(self.config.suffix_array_compression_ratio)
        if self.device_sa is not None:
            dev_sa = self.device_sa
            dev_ratio = int(self.device_sa_ratio)
        dev = DeviceIndex(
            packed=jnp.asarray(packed),
            packed_pair=pair,
            prefix_sums=jnp.asarray(self.prefix_sums.astype(np.uint32)),
            seed_table=seed_dev,
            # None = suffix array left on disk; locate resolves via file
            # reads (awFmGetSuffixArrayValueFromFile parity)
            sampled_sa=(
                None if dev_sa is None
                else jnp.asarray(dev_sa.astype(np.uint32))
            ),
            code_masks=jnp.asarray(device_code_masks(self.alphabet)),
            vec_to_index=jnp.asarray(
                alpha.vector_to_index_lut(self.alphabet).astype(np.int32)
            ),
            bwt_length=int(self.bwt_length),
            ratio=dev_ratio,
            kmer_length_in_seed_table=int(self.config.kmer_length_in_seed_table),
            alphabet=self.alphabet,
        )
        self._device_cache = dev
        return dev

    def densify_device_sa(
        self,
        ratio: int,
        chunk: int = 1 << 22,
        wide: Optional[bool] = None,
    ) -> DeviceIndex:
        """Rebuild a DENSER device-side suffix array from the loaded one.

        ``create_index(device_sa_ratio=r)`` can only cut a denser SA at
        build time, when the full SA exists (the reference's equivalent
        memory-for-speed trade is likewise build-time-only,
        /root/reference/README.md:207-213). But the device can recover
        density by itself: every BWT position's SA value is reachable
        from the stored samples via LF backtrace (AwFmSearch.c:203-223
        semantics), so this runs the existing sync-free compaction
        driver over all ceil(n/ratio) target positions — a one-time
        O(n/ratio * oldRatio/2) LF pass — and installs the result as
        the device SA.
        Locate backtrace chains then shorten to ~ratio/2 steps.

        The new samples live ON DEVICE only; the `.awfmi` file and the
        host model keep the config ratio, so serialization is untouched.
        Values are bit-identical to a build-time dense SA
        (tests/test_locate.py).

        Returns the refreshed DeviceIndex (also installed as this
        index's device cache, so later ``to_device()``/engine
        constructions see it). Requires the sampled SA on device
        (``keep_suffix_array_in_memory`` loads); an on-disk SA cannot
        seed the pass without per-chain file reads. ``wide`` selects
        the hi/lo 64-bit layout (default: auto — bwtLength >= 2^32 or
        an already-installed wide device cache); the reference's
        memory-for-speed SA trade has no scale cutoff
        (/root/reference/README.md:207-213) and neither does this one.
        """
        import functools

        import jax
        import jax.numpy as jnp
        from jax import lax

        if ratio < 1:
            raise ValueError("ratio must be >= 1")
        if wide is None:
            wide = self.bwt_length >= 2**32 or (
                self._device_cache is not None
                and not isinstance(self._device_cache, DeviceIndex)
            )
        if wide:
            return self._densify_device_sa_wide(ratio, chunk)
        dev = self.to_device()
        if dev.sampled_sa is None:
            raise ValueError(
                "densify_device_sa needs the sampled suffix array on "
                "device (load with keep_suffix_array_in_memory=True)"
            )
        if ratio == dev.ratio:
            return dev
        from ..search import _resolve_samples, backtrace_all

        new_len = (self.bwt_length + ratio - 1) // ratio
        n_chunks = (new_len + chunk - 1) // chunk
        chunk = min(chunk, ((new_len + 255) // 256) * 256)

        @functools.partial(jax.jit, donate_argnums=(0,))
        def fill(out, dv, start_idx):
            # targets start_idx*ratio, (start_idx+1)*ratio, ... — a
            # contiguous slice of the new sample set, so the chunk
            # lands with ONE dynamic_update_slice (no scatter)
            t = (
                start_idx + jnp.arange(chunk, dtype=jnp.uint32)
            ) * jnp.uint32(ratio)
            t = jnp.minimum(t, jnp.uint32(self.bwt_length - 1))
            p, off = backtrace_all(dv, t)
            vals = _resolve_samples(dv, p, off)
            return lax.dynamic_update_slice(
                out, vals, (start_idx.astype(jnp.int32),)
            )

        out = jnp.zeros((n_chunks * chunk,), dtype=jnp.uint32)
        for c in range(n_chunks):
            out = fill(out, dev, jnp.uint32(c * chunk))
        dense = dataclasses.replace(
            dev, sampled_sa=out[:new_len], ratio=int(ratio)
        )
        self.device_sa_ratio = int(ratio)
        self._device_cache = dense
        return dense

    def _densify_device_sa_wide(self, ratio: int, chunk: int):
        """hi/lo-lane counterpart of the narrow densify pass above.

        Same one-time device-side LF sweep (AwFmSearch.c:203-223
        semantics) over every new sample target i*ratio, with 64-bit
        target enumeration via 16-bit-limb multiply (rank64.mul_small64)
        and the wide sync-free backtrace (search64.backtrace_all64).
        Result rows are (lo, hi) u32 pairs, bit-identical to a
        build-time ``device_sa_ratio`` wide upload
        (tests/test_index64.py).
        """
        import functools

        import jax
        import jax.numpy as jnp
        from jax import lax

        from ..ops import rank64 as r64

        dev = self.to_device(wide=True)
        if dev.sampled_sa is None:
            raise ValueError(
                "densify_device_sa needs the sampled suffix array on "
                "device (load with keep_suffix_array_in_memory=True)"
            )
        if ratio == dev.ratio:
            return dev
        new_len = (self.bwt_length + ratio - 1) // ratio
        if new_len >= 2**31:
            raise ValueError(
                "dense device SA gather index must fit int32: need "
                "bwtLength / ratio < 2^31"
            )
        from ..search64 import _resolve_samples64, backtrace_all64

        n_chunks = (new_len + chunk - 1) // chunk
        chunk = min(chunk, ((new_len + 255) // 256) * 256)
        n1 = self.bwt_length - 1
        n1_hi = jnp.uint32(n1 >> 32)
        n1_lo = jnp.uint32(n1 & 0xFFFFFFFF)

        @functools.partial(jax.jit, donate_argnums=(0,))
        def fill(out, dv, start_idx):
            i = start_idx + jnp.arange(chunk, dtype=jnp.uint32)
            t_hi, t_lo = r64.mul_small64(i, ratio)
            over = ~r64.le64(t_hi, t_lo, n1_hi, n1_lo)
            t_hi, t_lo = r64.where64(over, n1_hi, n1_lo, t_hi, t_lo)
            p_hi, p_lo, off = backtrace_all64(dv, t_hi, t_lo)
            h_hi, h_lo = _resolve_samples64(dv, p_hi, p_lo, off)
            vals = jnp.stack([h_lo, h_hi], axis=1)
            return lax.dynamic_update_slice(
                out, vals, (start_idx.astype(jnp.int32), jnp.int32(0))
            )

        out = jnp.zeros((n_chunks * chunk, 2), dtype=jnp.uint32)
        for c in range(n_chunks):
            out = fill(out, dev, jnp.uint32(c * chunk))
        dense = dataclasses.replace(
            dev, sampled_sa=out[:new_len], ratio=int(ratio)
        )
        self.device_sa_ratio = int(ratio)
        self._device_cache = dense
        return dense

    def _to_device_wide(self):
        """Build the 64-bit-capacity device view (ops/rank64.py)."""
        import jax.numpy as jnp

        from ..ops import rank64 as r64

        if self.num_blocks >= 2**31:
            raise ValueError(
                "device block index rides int32 gathers: bwtLength must "
                "be < 2^39 positions (~550 G bases)"
            )
        ratio = int(self.config.suffix_array_compression_ratio)
        if self.bwt_length // ratio >= 2**31:
            raise ValueError(
                "sampled-SA gather index must fit int32: need "
                "bwtLength / saCompressionRatio < 2^31"
            )
        import os

        # pair-fused rows are free for nucleotide — DNA and RNA share the
        # 256 B row either way (they fill former row padding); amino pair
        # rows cost +128 B/block, so the capacity-minded AWFM_PAIR_ROWS=0
        # keeps the compact 384 B amino layout
        pair_fused = self.alphabet != AlphabetType.AMINO or os.environ.get(
            "AWFM_PAIR_ROWS", "1"
        ) != "0"
        packed = r64.pack_device_blocks64(
            self.bwt_letters, self.milestones(), self.alphabet,
            pair=pair_fused,
        )
        ps_hi, ps_lo = r64.split_u64_host(self.prefix_sums)
        # denser device-side SA (create_index(device_sa_ratio=...)) —
        # same memory-for-speed trade as the narrow layout; the
        # reference applies it at every scale (README.md:207-213)
        dev_sa_np = self.sampled_sa
        dev_ratio = ratio
        if self.device_sa is not None:
            dev_sa_np = self.device_sa
            dev_ratio = int(self.device_sa_ratio)
        dev = r64.DeviceIndex64(
            packed=jnp.asarray(packed),
            prefix_hi=jnp.asarray(ps_hi),
            prefix_lo=jnp.asarray(ps_lo),
            seed_table=jnp.zeros((1, 4), dtype=jnp.uint32),
            sampled_sa=None,
            code_masks=jnp.asarray(device_code_masks(self.alphabet)),
            vec_to_index=jnp.asarray(
                alpha.vector_to_index_lut(self.alphabet).astype(np.int32)
            ),
            bwt_length=int(self.bwt_length),
            ratio=dev_ratio,
            kmer_length_in_seed_table=int(
                self.config.kmer_length_in_seed_table
            ),
            alphabet=self.alphabet,
            pair_fused=pair_fused,
        )
        k = int(self.config.kmer_length_in_seed_table)
        narrow_cache = (
            self._device_cache
            if isinstance(self._device_cache, DeviceIndex)
            and self.bwt_length < 2**32
            and self._device_cache.seed_table.shape[0] == self.cardinality**k
            else None
        )
        if self.kmer_seed_table is not None:
            st = self.kmer_seed_table.astype(np.uint64)
            s_hi, s_lo = r64.split_u64_host(st[:, 0])
            e_hi, e_lo = r64.split_u64_host(st[:, 1])
            dev.seed_table = jnp.asarray(
                np.stack([s_lo, s_hi, e_lo, e_hi], axis=1)
            )
        elif narrow_cache is not None:
            # widen the existing 32-bit device table (values < 2^32, so
            # hi words are zero) instead of re-running the device BFS
            st32 = narrow_cache.seed_table
            zeros = jnp.zeros_like(st32[:, 0])
            dev.seed_table = jnp.stack(
                [st32[:, 0], zeros, st32[:, 1], zeros], axis=1
            )
        else:
            from ..search64 import build_seed_table_device64

            dev.seed_table = build_seed_table_device64(
                dev, self.cardinality, k, self.prefix_sums
            )
        if dev_sa_np is not None:
            sa_hi, sa_lo = r64.split_u64_host(dev_sa_np)
            dev.sampled_sa = jnp.asarray(np.stack([sa_lo, sa_hi], axis=1))
        self._device_cache = dev
        return dev

    # -- FastaVector-parity accessors ---------------------------------------

    def get_local_sequence_position(self, global_position):
        """awFmGetLocalSequencePositionFromIndexPosition (AwFmSearch.c:284-301)."""
        if self.fasta_metadata is None:
            raise ValueError("index was not built from a FASTA (no metadata)")
        return self.fasta_metadata.local_position_from_global(global_position)

    def get_header(self, sequence_number: int) -> bytes:
        """awFmGetHeaderStringFromSequenceNumber (AwFmSearch.c:303-315)."""
        if self.fasta_metadata is None:
            raise ValueError("index was not built from a FASTA (no metadata)")
        return self.fasta_metadata.get_header(sequence_number)
