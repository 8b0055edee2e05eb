"""Native index artifact format (.awfmx): a compressed NPZ container.

The `.awfmi` format (io/awfmi.py) is kept byte-compatible with the
reference for interoperability; this native format is the fast load
path — arrays load directly into the host model with no
bit-plane unpacking, and it preserves everything including the device
layout inputs.

Contents: config scalars, BWT letter indices, prefix sums, seed table,
sampled suffix array, optional original sequence and FASTA metadata.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..models.config import AlphabetType, IndexConfiguration
from ..models.index import FastaMetadata, FmIndex

# v1: every field mandatory, incl. kmer_seed_table.
# v2: kmer_seed_table optional (device-only builds omit it; loaders
#     rebuild via the device BFS). Bumped so v1-era readers reject the
#     file with a clear version error instead of a KeyError.
# v3: sampled_sa / device_sa stored uint32 when bwtLength < 2^32 (the
#     host model stays uint64; loaders upcast) — 4.65 GB less NPZ I/O
#     at hg38 (sampled 3.1 + device 6.2 GB -> 1.55 + 3.1). v2 files
#     (u64 arrays) stay readable: the loader upcasts whatever width it
#     finds.
_FORMAT_VERSION = 3
_READABLE_VERSIONS = (1, 2, 3)


def save_artifact(index: FmIndex, path: str, *,
                  pull_device_seed_table: bool = False,
                  compress: bool = True) -> None:
    """Serialize to the native .awfmx (NPZ) artifact.

    When the seed table exists only on device (the narrow build leaves
    it there), it is OMITTED unless ``pull_device_seed_table``:
    ``load_artifact`` rebuilds it with the batched device BFS.

    ``compress=False`` writes a plain NPZ: suffix arrays are
    near-incompressible, so zlib buys ~40%% size for minutes of
    single-threaded CPU at genome scale (measured ~6 MB/s) — local
    warm-start caches (bench.py) want disk-speed writes instead.
    """
    if index.sampled_sa is None:
        raise ValueError("cannot serialize: sampled suffix array not in memory")
    cfg = index.config
    payload = {
        "format_version": np.int64(_FORMAT_VERSION),
        "awfmi_version": np.int64(index.version_number),
        "feature_flags": np.int64(index.feature_flags),
        "ratio": np.int64(cfg.suffix_array_compression_ratio),
        "seed_k": np.int64(cfg.kmer_length_in_seed_table),
        "alphabet": np.int64(int(cfg.alphabet_type)),
        "store_original_sequence": np.int64(int(cfg.store_original_sequence)),
        "bwt_length": np.int64(index.bwt_length),
        "bwt_letters": index.bwt_letters,
        "prefix_sums": index.prefix_sums,
        "sampled_sa": _narrowed(index.sampled_sa, index.bwt_length),
        "sa_guard_bytes": np.frombuffer(index.sa_guard_bytes, dtype=np.uint8),
    }
    if index.kmer_seed_table is not None or pull_device_seed_table:
        payload["kmer_seed_table"] = index.seed_table_host()
    if index.device_sa is not None:
        # the denser device-only SA (create_index(device_sa_ratio=...))
        # is a build-time product; preserving it makes the artifact a
        # complete warm start
        payload["device_sa"] = _narrowed(index.device_sa, index.bwt_length)
        payload["device_sa_ratio"] = np.int64(index.device_sa_ratio)
    if index.sequence is not None:
        payload["sequence"] = np.frombuffer(index.sequence, dtype=np.uint8)
    if index.fasta_metadata is not None:
        md = index.fasta_metadata
        payload["fasta_headers"] = np.frombuffer(md.headers, dtype=np.uint8)
        payload["fasta_header_ends"] = md.header_ends
        payload["fasta_sequence_ends"] = md.sequence_ends
    # write through a file object: np.savez_compressed silently appends
    # ".npz" to bare string paths, which would break the advertised
    # save_artifact('x.awfmx') -> load_artifact('x.awfmx') round trip
    writer = np.savez_compressed if compress else np.savez
    with open(path, "wb") as fh:
        writer(fh, **payload)


def _narrowed(values: np.ndarray, bwt_length: int) -> np.ndarray:
    """uint32 view of SA values when every one fits (bwt < 2^32)."""
    if bwt_length < 2**32 and values.dtype != np.uint32:
        return values.astype(np.uint32)
    return values


def load_artifact(path: str) -> FmIndex:
    """Load a native .awfmx (NPZ) artifact.

    Artifacts saved without a host seed table (see ``save_artifact``)
    get theirs rebuilt by the batched device BFS before returning, so
    a loaded index is always search-ready."""
    with np.load(path) as z:
        version = int(z["format_version"])
        if version not in _READABLE_VERSIONS:
            raise ValueError(f"{path}: unsupported artifact version {version}")
        cfg = IndexConfiguration(
            suffix_array_compression_ratio=int(z["ratio"]),
            kmer_length_in_seed_table=int(z["seed_k"]),
            alphabet_type=AlphabetType(int(z["alphabet"])),
            keep_suffix_array_in_memory=True,
            store_original_sequence=bool(int(z["store_original_sequence"])),
        )
        sequence: Optional[bytes] = None
        if "sequence" in z:
            sequence = z["sequence"].tobytes()
        metadata: Optional[FastaMetadata] = None
        if "fasta_sequence_ends" in z:
            metadata = FastaMetadata(
                headers=z["fasta_headers"].tobytes(),
                header_ends=z["fasta_header_ends"].copy(),
                sequence_ends=z["fasta_sequence_ends"].copy(),
            )
        idx = FmIndex(
            config=cfg,
            bwt_length=int(z["bwt_length"]),
            bwt_letters=z["bwt_letters"].copy(),
            prefix_sums=z["prefix_sums"].copy(),
            kmer_seed_table=(
                z["kmer_seed_table"].copy()
                if "kmer_seed_table" in z
                else None
            ),
            sampled_sa=z["sampled_sa"].astype(np.uint64),
            version_number=int(z["awfmi_version"]),
            feature_flags=int(z["feature_flags"]),
            sequence=sequence,
            fasta_metadata=metadata,
            file_path=None,
            sa_guard_bytes=(
                z["sa_guard_bytes"].tobytes()
                if "sa_guard_bytes" in z
                else b"\x00" * 8
            ),
            device_sa=(
                z["device_sa"].astype(np.uint64)
                if "device_sa" in z
                else None
            ),
            device_sa_ratio=(
                int(z["device_sa_ratio"]) if "device_sa_ratio" in z else None
            ),
        )
    if idx.kmer_seed_table is None:
        from ..build import attach_device_seed_table

        attach_device_seed_table(idx)
    return idx
