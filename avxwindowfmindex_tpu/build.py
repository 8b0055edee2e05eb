"""Index construction (awFmCreateIndex / awFmCreateIndexFromFasta parity).

Pipeline mirrors AwFmCreate.c:31-137 / 140-279:
  1. sanitize a copy of the sequence (ambiguity -> 'x'/'z');
  2. append the '$' sentinel;
  3. build the suffix array (native SA-IS or NumPy doubling, replacing
     divsufsort64);
  4. derive BWT letters + prefix sums (setBwtAndPrefixSums,
     AwFmCreate.c:281-405) — here a fully vectorized NumPy pass;
  5. build the k-mer seed table (batched BFS on device, ops/seed_table.py);
  6. sample the suffix array (every ratio-th BWT position);
  7. optionally serialize to a byte-compatible `.awfmi` file.
"""

from __future__ import annotations

from typing import Optional, Union

import numpy as np

from . import suffix_array as sa_mod
from .models import alphabet as alpha
from .models.config import (
    CURRENT_VERSION_NUMBER,
    FEATURE_FLAG_BIT_FASTA_VECTOR,
    AlphabetType,
    IndexConfiguration,
)
from .models.index import FastaMetadata, FmIndex


def _compute_bwt_letters(
    sanitized_with_sentinel: np.ndarray, sa: np.ndarray, alphabet: AlphabetType
) -> np.ndarray:
    """BWT letter indices in SA order (AwFmCreate.c:315-335).

    letter[i] = sentinel if SA[i] == 0 else letterIndex(seq[SA[i] - 1]).

    Chunked so the int64 temporaries stay bounded: at hg38 scale the SA
    is ~25 GB and whole-array `sa - 1` / `np.where` doubles-to-triples
    that transiently.
    """
    n = len(sa)
    lett = np.empty(n, dtype=np.uint8)
    sentinel = alpha.sentinel_index(alphabet)
    chunk = 1 << 26
    for lo in range(0, n, chunk):
        s = sa[lo : lo + chunk]
        prev = s - 1
        np.maximum(prev, 0, out=prev)
        part = alpha.ascii_to_index(
            sanitized_with_sentinel[prev], alphabet
        ).astype(np.uint8, copy=False)
        part[s == 0] = sentinel
        lett[lo : lo + chunk] = part
    return lett


def _compute_prefix_sums(bwt_letters: np.ndarray, alphabet: AlphabetType) -> np.ndarray:
    """Cumulative letter counts with the sentinel counted into
    prefixSums[0] = 1 (AwFmCreate.c:338-344, 397-403).

    prefix_sums[0] = 1; prefix_sums[i] = 1 + sum(counts of letters < i)
    for i in 1..A+1 (ambiguity included); prefix_sums[A+1] == bwtLength.
    """
    card = alpha.cardinality(alphabet)
    counts = np.bincount(bwt_letters, minlength=card + 2).astype(np.uint64)
    ps = np.empty(card + 2, dtype=np.uint64)
    ps[0] = 1
    ps[1:] = 1 + np.cumsum(counts[: card + 1])
    return ps


def _build_from_sanitized(
    sanitized: np.ndarray,
    original_sequence: Optional[bytes],
    config: IndexConfiguration,
    fasta_metadata: Optional[FastaMetadata],
    file_src: Optional[str],
    sa_backend: Optional[str],
    device_sa_ratio: Optional[int] = None,
) -> FmIndex:
    seq_with_sentinel = np.concatenate(
        [sanitized, np.array([ord("$")], dtype=np.uint8)]
    )
    bwt_length = len(seq_with_sentinel)

    sa = sa_mod.build_suffix_array(seq_with_sentinel, backend=sa_backend)

    bwt_letters = _compute_bwt_letters(seq_with_sentinel, sa, config.alphabet_type)
    prefix_sums = _compute_prefix_sums(bwt_letters, config.alphabet_type)
    sampled = sa[:: config.suffix_array_compression_ratio].astype(np.uint64)
    guard = sa_mod.guard_bytes_from_full_sa(
        sa, bwt_length, config.suffix_array_compression_ratio
    )
    # denser DEVICE-side SA samples (locate-speed knob; the .awfmi
    # file keeps the config ratio): must be cut from the full SA, which
    # exists only here
    if device_sa_ratio is None:
        import os

        env = os.environ.get("AWFM_DEVICE_SA_RATIO")
        device_sa_ratio = int(env) if env else None
    device_sa = None
    if device_sa_ratio is not None:
        if device_sa_ratio < 1:
            raise ValueError("device_sa_ratio must be >= 1")
        if device_sa_ratio >= config.suffix_array_compression_ratio:
            # no denser than the serialized samples: nothing to gain
            device_sa_ratio = None
        elif bwt_length // device_sa_ratio >= 2**31:
            raise ValueError(
                "dense device SA gather index must fit int32: need "
                "bwtLength / device_sa_ratio < 2^31"
            )
        else:
            device_sa = sa[::device_sa_ratio].astype(np.uint64)
    del sa  # the full SA (~25 GB at hg38 scale) is not needed past sampling

    feature_flags = 0
    if fasta_metadata is not None:
        feature_flags |= 1 << FEATURE_FLAG_BIT_FASTA_VECTOR

    index = FmIndex(
        config=config,
        bwt_length=bwt_length,
        bwt_letters=bwt_letters,
        prefix_sums=prefix_sums,
        kmer_seed_table=None,  # built on device below
        sampled_sa=sampled,
        sa_guard_bytes=guard,
        version_number=CURRENT_VERSION_NUMBER,
        feature_flags=feature_flags,
        sequence=original_sequence if config.store_original_sequence else None,
        fasta_metadata=fasta_metadata,
        device_sa=device_sa,
        device_sa_ratio=device_sa_ratio if device_sa is not None else None,
    )

    # seed table: batched BFS on device using the same backward-step math
    # the search uses (exact parity with the DFS at AwFmCreate.c:407-450),
    # then one copy to the host model, which serde and host-side
    # inspection read (seed_table_host joins the wide layout's hi/lo
    # columns)
    attach_device_seed_table(index)
    index.seed_table_host()

    if file_src is not None:
        from .io import awfmi

        awfmi.write_index(index, file_src)
        index.file_path = file_src
        if not config.keep_suffix_array_in_memory:
            index.sampled_sa = None
            index._device_cache = None
    elif not config.keep_suffix_array_in_memory:
        raise ValueError(
            "keep_suffix_array_in_memory=False requires a file_src to page "
            "suffix-array values from"
        )
    return index


def attach_device_seed_table(index) -> None:
    """(Re)build the narrow device seed table for an index whose host
    copy is absent — used at build, and by loaders of artifacts saved
    without a seed table (io/artifact.py).

    Wide layout (bwtLength >= 2^32): no-op — `_to_device_wide` already
    ran the hi/lo device BFS (search64.build_seed_table_device64) and
    left the (A^k, 4) table attached; running the 32-bit builder would
    crash on the missing prefix_sums field and clobber the wide table.
    """
    import dataclasses as _dc

    from .models.index import DeviceIndex as _DeviceIndex
    from .ops import seed_table as seed_mod

    dev = index.to_device()
    if isinstance(dev, _DeviceIndex):
        table_dev = seed_mod.build_seed_table_device(
            dev,
            alpha.cardinality(index.config.alphabet_type),
            index.config.kmer_length_in_seed_table,
            prefix_sums_host=index.prefix_sums,
        )
        index._device_cache = _dc.replace(dev, seed_table=table_dev)


def _warn_mixed_case_amino(seq_arr: np.ndarray, alphabet: AlphabetType) -> None:
    """Mixed-case amino databases are invalid input in BOTH libraries.

    Amino sanitization preserves case (matching the reference), so the
    suffix order is the mixed-case byte order while letter indices
    collapse case — the resulting "BWT" is not a BWT, its LF mapping can
    have fixed points, and locate loops forever (the reference hangs
    identically). Nucleotide sanitization normalizes case, so this only
    bites amino. Warn loudly instead of letting locate spin.
    """
    if alphabet != AlphabetType.AMINO:
        return
    has_upper = bool(((seq_arr >= 0x41) & (seq_arr <= 0x5A)).any())
    has_lower = bool(((seq_arr >= 0x61) & (seq_arr <= 0x7A)).any())
    if has_upper and has_lower:
        import warnings

        warnings.warn(
            "mixed-case amino database: suffix order is case-sensitive "
            "byte order but matching collapses case, so locate on this "
            "index can loop forever (in the reference library too). "
            "Normalize the database to a single case.",
            UserWarning,
            stacklevel=3,
        )


def create_index(
    sequence: Union[bytes, str, np.ndarray],
    config: Optional[IndexConfiguration] = None,
    file_src: Optional[str] = None,
    sa_backend: Optional[str] = None,
    device_sa_ratio: Optional[int] = None,
) -> FmIndex:
    """Build an index from a raw sequence (awFmCreateIndex,
    AwFmCreate.c:31-137).

    ``device_sa_ratio``: optional DEVICE-side SA sampling denser than
    the config ratio (env fallback AWFM_DEVICE_SA_RATIO) — the device
    analogue of the reference's in-memory-SA locate-speed trade
    (README.md:207-213); the .awfmi file keeps the config ratio."""
    config = config or IndexConfiguration()
    if isinstance(sequence, str):
        sequence = sequence.encode()
    if isinstance(sequence, (bytes, bytearray)):
        seq_arr = np.frombuffer(bytes(sequence), dtype=np.uint8)
    else:
        seq_arr = np.asarray(sequence, dtype=np.uint8)
    if len(seq_arr) == 0:
        raise ValueError("sequence must be non-empty")
    _warn_mixed_case_amino(seq_arr, config.alphabet_type)
    sanitized = alpha.sanitize(seq_arr, config.alphabet_type)
    # only materialize an original-sequence copy when it will be stored:
    # at genome scale this is a multi-GB buffer held through the peak-
    # memory suffix-array build
    original = None
    if config.store_original_sequence:
        original = (
            sequence if isinstance(sequence, bytes) else bytes(seq_arr)
        )
    return _build_from_sanitized(
        sanitized, original, config, None, file_src, sa_backend,
        device_sa_ratio,
    )


def create_index_from_fasta(
    fasta_src: str,
    config: Optional[IndexConfiguration] = None,
    index_file_src: Optional[str] = None,
    sa_backend: Optional[str] = None,
    device_sa_ratio: Optional[int] = None,
) -> FmIndex:
    """Build an index from every sequence in a FASTA file
    (awFmCreateIndexFromFasta, AwFmCreate.c:140-279)."""
    from .io import fasta as fasta_mod

    config = config or IndexConfiguration()
    sequence, metadata = fasta_mod.read_fasta(fasta_src)
    if len(sequence) == 0:
        raise ValueError(f"no sequence data in {fasta_src}")
    seq_arr = np.frombuffer(sequence, dtype=np.uint8)
    _warn_mixed_case_amino(seq_arr, config.alphabet_type)
    sanitized = alpha.sanitize(seq_arr, config.alphabet_type)
    return _build_from_sanitized(
        sanitized, sequence, config, metadata, index_file_src, sa_backend,
        device_sa_ratio
    )
