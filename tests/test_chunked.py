"""Chunked-corpus index: must behave like one big index."""

import numpy as np
import pytest

from avxwindowfmindex_tpu import (
    AlphabetType,
    IndexConfiguration,
    SearchEngine,
    create_index,
)
from avxwindowfmindex_tpu.parallel.chunked import ChunkedCorpusIndex

from oracle import random_kmer, random_sequence


def _cfg():
    return IndexConfiguration(
        suffix_array_compression_ratio=4,
        kmer_length_in_seed_table=3,
        alphabet_type=AlphabetType.DNA,
    )


def test_chunked_matches_monolithic(rng):
    seq = random_sequence(rng, 3000, AlphabetType.DNA)
    mono = SearchEngine(create_index(seq, _cfg()))
    chunked = ChunkedCorpusIndex.build(
        seq, _cfg(), chunk_bases=1000, overlap=15
    )
    assert chunked.num_chunks == 3
    kmers = [random_kmer(rng, int(rng.integers(3, 13)), AlphabetType.DNA)
             for _ in range(120)]
    np.testing.assert_array_equal(chunked.count(kmers), mono.count(kmers))
    got = chunked.locate(kmers)
    want = mono.locate(kmers)
    for kmer, a, b in zip(kmers, got, want):
        np.testing.assert_array_equal(
            a, np.sort(b.astype(np.uint64)), err_msg=repr(kmer)
        )


def test_boundary_straddling_matches(rng):
    # a kmer deliberately placed across every chunk boundary
    marker = b"GATTACAGATTA"
    seq = bytearray(random_sequence(rng, 2500, AlphabetType.DNA))
    for boundary in (1000, 2000):
        seq[boundary - 6 : boundary + 6] = marker
    seq = bytes(seq)
    mono = SearchEngine(create_index(seq, _cfg()))
    chunked = ChunkedCorpusIndex.build(seq, _cfg(), chunk_bases=1000, overlap=15)
    np.testing.assert_array_equal(
        chunked.count([marker]), mono.count([marker])
    )
    np.testing.assert_array_equal(
        chunked.locate([marker])[0],
        np.sort(mono.locate([marker])[0].astype(np.uint64)),
    )


def test_overlong_query_rejected(rng):
    seq = random_sequence(rng, 2000, AlphabetType.DNA)
    chunked = ChunkedCorpusIndex.build(seq, _cfg(), chunk_bases=1000, overlap=7)
    with pytest.raises(ValueError, match="overlap"):
        chunked.count([b"ACGTACGTACGT"])  # 12 > overlap + 1


def test_single_chunk_passthrough(rng):
    seq = random_sequence(rng, 500, AlphabetType.DNA)
    mono = SearchEngine(create_index(seq, _cfg()))
    chunked = ChunkedCorpusIndex.build(seq, _cfg(), chunk_bases=10_000, overlap=0)
    assert chunked.num_chunks == 1
    kmers = [random_kmer(rng, 30, AlphabetType.DNA)]  # long ok: 1 chunk
    np.testing.assert_array_equal(chunked.count(kmers), mono.count(kmers))


def test_high_frequency_kmer_count(rng):
    # poly-A rich corpus: the counted kmers occur thousands of times and
    # straddle every boundary — count() must stay exact (and O(1)/kmer,
    # not locate-derived)
    seq = bytearray(random_sequence(rng, 4000, AlphabetType.DNA))
    for i in range(0, 4000, 7):
        seq[i] = ord("A")
    seq = bytes(seq).replace(b"C", b"A")
    mono = SearchEngine(create_index(seq, _cfg()))
    chunked = ChunkedCorpusIndex.build(seq, _cfg(), chunk_bases=900, overlap=12)
    kmers = [b"AA", b"AAA", b"AAAAA", b"AT", b"TAA", b"GA", b"AAAAAAAAAAAAA"[:13]]
    np.testing.assert_array_equal(chunked.count(kmers), mono.count(kmers))
    # and count agrees with the locate-derived value
    np.testing.assert_array_equal(
        chunked.count(kmers),
        np.array([len(h) for h in chunked.locate(kmers)], dtype=np.uint64),
    )


def test_count_without_junction_texts_falls_back(rng):
    # direct construction without junction texts must stay correct
    seq = random_sequence(rng, 2000, AlphabetType.DNA)
    built = ChunkedCorpusIndex.build(seq, _cfg(), chunk_bases=800, overlap=10)
    bare = ChunkedCorpusIndex(
        built.engines, built.chunk_bases, built.overlap, built.total_bases
    )
    kmers = [random_kmer(rng, 6, AlphabetType.DNA) for _ in range(20)]
    np.testing.assert_array_equal(bare.count(kmers), built.count(kmers))


def test_chunked_empty_query_list(rng):
    """Empty batches raise the same clear error as SearchEngine (not the
    opaque max()-of-empty-sequence crash _check_query_lengths used to
    hit first)."""
    seq = random_sequence(rng, 2500, AlphabetType.DNA)
    chunked = ChunkedCorpusIndex.build(
        seq, _cfg(), chunk_bases=1000, overlap=15
    )
    with pytest.raises(ValueError, match="non-empty"):
        chunked.count([])
    with pytest.raises(ValueError, match="non-empty"):
        chunked.locate([])
