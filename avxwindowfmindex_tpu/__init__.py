"""avxwindowfmindex_tpu — a batched FM-index engine in JAX.

A from-scratch reimplementation of the capabilities of
TravisWheelerLab/AvxWindowFmIndex (an AVX2/NEON-optimized FM-index for
nucleotide and amino-acid sequences) designed for an accelerator: the
windowed BWT is stored in device-native shapes, rank is a batched
gather + masked popcount, backward search steps thousands of queries at
once, and multi-device scaling uses ``shard_map`` over a device mesh
instead of OpenMP threads.

Quick start::

    import avxwindowfmindex_tpu as awfm

    cfg = awfm.IndexConfiguration(
        alphabet_type=awfm.AlphabetType.DNA,
        kmer_length_in_seed_table=8,
        suffix_array_compression_ratio=8,
    )
    index = awfm.create_index("ACGTACGTTAGC...", cfg, file_src="genome.awfmi")
    engine = awfm.SearchEngine(index)
    counts = engine.count(["ACGTAC", "TTAGC"])
    hits = engine.locate(["ACGTAC"])
"""

from .build import create_index, create_index_from_fasta
from .models.alphabet import (
    AMINO_CARDINALITY,
    NUCLEOTIDE_CARDINALITY,
    POSITIONS_PER_BLOCK,
)
from .models.config import (
    CURRENT_VERSION_NUMBER,
    AlphabetType,
    IndexConfiguration,
    ReturnCode,
)
from .models.index import (
    DeviceIndex,
    FastaMetadata,
    FmIndex,
    search_range_length,
)
from .search import (
    DigramSearchEngine,
    NgramSearchEngine,
    SearchEngine,
    backtrace_return_previous_letter_index,
    create_initial_query_range,
    find_database_hit_position_single,
    find_database_hit_positions,
    find_search_range_for_string,
    iterative_step_backward_search,
    query_can_use_kmer_table,
    search_range_is_valid,
    single_kmer_exists,
)


def chunked_corpus_index(sequence, config=None, chunk_bases=(1 << 31), overlap=255):
    """Build a ChunkedCorpusIndex for corpora beyond the uint32 device
    limit (overlapping sub-indexes behaving like one big index)."""
    from .parallel.chunked import ChunkedCorpusIndex

    return ChunkedCorpusIndex.build(
        sequence, config, chunk_bases=chunk_bases, overlap=overlap
    )


def save_artifact(index, path: str) -> None:
    """Serialize to the native .awfmx NPZ artifact (fast load path)."""
    from .io import artifact

    artifact.save_artifact(index, path)


def load_artifact(path: str):
    """Load a native .awfmx NPZ artifact."""
    from .io import artifact

    return artifact.load_artifact(path)


def read_index_from_file(path: str, keep_suffix_array_in_memory: bool = True):
    """awFmReadIndexFromFile parity — load a `.awfmi` index."""
    from .io import awfmi

    return awfmi.read_index(path, keep_suffix_array_in_memory)


def write_index_to_file(index, path: str) -> None:
    """awFmWriteIndexToFile parity — serialize to `.awfmi`."""
    from .io import awfmi

    awfmi.write_index(index, path)


def parallel_search_count(index, kmers, num_threads: int = 0):
    """awFmParallelSearchCount parity (threads are a no-op on device)."""
    from .parallel.api import parallel_search_count as _f

    return _f(index, kmers, num_threads)


def parallel_search_locate(index, kmers, num_threads: int = 0):
    """awFmParallelSearchLocate parity (threads are a no-op on device)."""
    from .parallel.api import parallel_search_locate as _f

    return _f(index, kmers, num_threads)


__version__ = "0.1.0"

__all__ = [
    "AlphabetType",
    "IndexConfiguration",
    "ReturnCode",
    "FmIndex",
    "DeviceIndex",
    "FastaMetadata",
    "SearchEngine",
    "NgramSearchEngine",
    "DigramSearchEngine",
    "create_index",
    "create_index_from_fasta",
    "read_index_from_file",
    "write_index_to_file",
    "parallel_search_count",
    "parallel_search_locate",
    "find_search_range_for_string",
    "find_database_hit_positions",
    "find_database_hit_position_single",
    "backtrace_return_previous_letter_index",
    "save_artifact",
    "load_artifact",
    "chunked_corpus_index",
    "single_kmer_exists",
    "query_can_use_kmer_table",
    "iterative_step_backward_search",
    "search_range_is_valid",
    "create_initial_query_range",
    "search_range_length",
    "CURRENT_VERSION_NUMBER",
    "NUCLEOTIDE_CARDINALITY",
    "AMINO_CARDINALITY",
    "POSITIONS_PER_BLOCK",
]
