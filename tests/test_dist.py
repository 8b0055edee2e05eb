"""Distributed (shard_map) search parity on the 8-device CPU mesh.

The reference has nothing distributed to test (SURVEY.md §4); these are
the multi-device tests the device design requires: sharded results must be
bit-identical to single-device results, at every mesh size.
"""

import numpy as np
import pytest

from avxwindowfmindex_tpu import (
    AlphabetType,
    IndexConfiguration,
    SearchEngine,
    create_index,
)
from avxwindowfmindex_tpu.parallel.dist import (
    DistributedSearchEngine,
    make_query_mesh,
)

from oracle import random_kmer, random_sequence


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(7)
    seq = random_sequence(rng, 3000, AlphabetType.DNA)
    cfg = IndexConfiguration(
        suffix_array_compression_ratio=4,
        kmer_length_in_seed_table=3,
        alphabet_type=AlphabetType.DNA,
    )
    return seq, create_index(seq, cfg)


@pytest.mark.parametrize("n_dev", [1, 2, 8])
def test_sharded_count_matches_single_device(built, rng, n_dev):
    seq, index = built
    mesh = make_query_mesh(n_dev)
    dist = DistributedSearchEngine(index, mesh)
    single = SearchEngine(index)
    kmers = [random_kmer(rng, int(rng.integers(1, 9)), AlphabetType.DNA)
             for _ in range(100)]
    np.testing.assert_array_equal(dist.count(kmers), single.count(kmers))


def test_sharded_locate_matches_single_device(built, rng):
    seq, index = built
    dist = DistributedSearchEngine(index, make_query_mesh(8))
    single = SearchEngine(index)
    kmers = [random_kmer(rng, int(rng.integers(2, 7)), AlphabetType.DNA)
             for _ in range(40)]
    got = dist.locate(kmers)
    want = single.locate(kmers)
    for kmer, a, b in zip(kmers, got, want):
        np.testing.assert_array_equal(a, b, err_msg=repr(kmer))


def test_count_replicated_allgather(built, rng):
    seq, index = built
    dist = DistributedSearchEngine(index, make_query_mesh(8))
    single = SearchEngine(index)
    kmers = [random_kmer(rng, 6, AlphabetType.DNA) for _ in range(64)]
    np.testing.assert_array_equal(
        dist.count_replicated(kmers), single.count(kmers)
    )


def test_sharded_locate_with_on_disk_sa(rng, tmp_path):
    """keep_suffix_array_in_memory=False under DistributedSearchEngine:
    the backtrace must stay mesh-sharded with only
    the final packed-SA file reads on host, and hits must equal the
    in-memory single-device answer."""
    from unittest import mock

    from avxwindowfmindex_tpu import read_index_from_file
    from avxwindowfmindex_tpu.parallel import dist as dist_mod

    seq = random_sequence(rng, 2500, AlphabetType.DNA)
    cfg = IndexConfiguration(
        suffix_array_compression_ratio=4,
        kmer_length_in_seed_table=3,
        alphabet_type=AlphabetType.DNA,
    )
    path = tmp_path / "ondisk.awfmi"
    in_mem = create_index(seq, cfg, file_src=str(path))
    loaded = read_index_from_file(str(path), keep_suffix_array_in_memory=False)
    assert loaded.sampled_sa is None

    mesh = make_query_mesh(8)
    dist = DistributedSearchEngine(loaded, mesh)
    single = SearchEngine(in_mem)
    kmers = [random_kmer(rng, int(rng.integers(2, 7)), AlphabetType.DNA)
             for _ in range(40)]
    want = single.locate(kmers)

    calls = []
    real = dist_mod._sharded_backtrace_fn

    def spy(mesh_arg):
        calls.append(mesh_arg)
        return real(mesh_arg)

    with mock.patch.object(dist_mod, "_sharded_backtrace_fn", spy):
        got = dist.locate(kmers)
    assert calls, "on-disk locate must route through the sharded backtrace"
    for kmer, a, b in zip(kmers, got, want):
        np.testing.assert_array_equal(a, b, err_msg=repr(kmer))


def test_mixed_eligibility_sharded(built, rng):
    seq, index = built
    dist = DistributedSearchEngine(index, make_query_mesh(4))
    single = SearchEngine(index)
    kmers = [b"ACGT", b"AC", b"ACGNT", b"TTTTTTT", b"x", b"GATTACA"]
    np.testing.assert_array_equal(dist.count(kmers), single.count(kmers))


def test_dist_steploop_matches(built, rng, monkeypatch):
    # force the GSPMD step-loop path (default on accelerator backends)
    import avxwindowfmindex_tpu.parallel.dist as dist_mod

    monkeypatch.setattr(dist_mod, "_use_step_loop", lambda: True)
    seq, index = built
    dist = DistributedSearchEngine(index, make_query_mesh(8))
    single = SearchEngine(index)
    kmers = [random_kmer(rng, int(rng.integers(2, 9)), AlphabetType.DNA)
             for _ in range(80)]
    np.testing.assert_array_equal(dist.count(kmers), single.count(kmers))


def test_dist_steploop_pair_fixup_on_nonpow2_mesh(rng, monkeypatch):
    """A flagged pair-window re-run inside the sharded step loop must
    pad its sub-batch to the mesh size — on a 6-device mesh the pow2
    sub-batch (64) is not divisible by n_dev and used to crash the
    device_put in the exact-rerun path."""
    import avxwindowfmindex_tpu.parallel.dist as dist_mod
    from avxwindowfmindex_tpu.utils import metrics

    monkeypatch.setattr(dist_mod, "_use_step_loop", lambda: True)
    # low-complexity corpus: seeded ranges stay wider than the pair
    # window, forcing flags on every seeded batch
    seq = bytes(rng.choice(np.frombuffer(b"AC", np.uint8), size=4000))
    cfg = IndexConfiguration(
        suffix_array_compression_ratio=4,
        kmer_length_in_seed_table=3,
        alphabet_type=AlphabetType.DNA,
    )
    index = create_index(seq, cfg)
    flagged_before = metrics.snapshot().get("search.pair_fixup.flagged", 0)
    dist = DistributedSearchEngine(index, make_query_mesh(6))
    single = SearchEngine(index)
    kmers = [b"ACACACAC", b"AAAA", b"CCCCCC", b"ACAC", b"CACA"] + [
        random_kmer(rng, int(rng.integers(3, 8)), AlphabetType.DNA)
        for _ in range(40)
    ]
    np.testing.assert_array_equal(dist.count(kmers), single.count(kmers))
    assert metrics.snapshot().get(
        "search.pair_fixup.flagged", 0
    ) > flagged_before


def test_dist_wide_matches_single_device(built, rng):
    """A forced-wide DeviceIndex64 (hi/lo-u32, bwtLength >= 2^32 layout)
    runs query-sharded: count, locate, and count_replicated must equal
    the narrow single-device engine."""
    seq, index = built
    wide_dev = index.to_device(refresh=True, wide=True)
    dist = DistributedSearchEngine(wide_dev, make_query_mesh(4))
    assert dist.wide
    single = SearchEngine(index)
    kmers = [random_kmer(rng, int(rng.integers(2, 12)), AlphabetType.DNA)
             for _ in range(64)]
    np.testing.assert_array_equal(dist.count(kmers), single.count(kmers))
    hits = dist.locate(kmers[:16])
    want = single.locate(kmers[:16])
    for a, b in zip(hits, want):
        np.testing.assert_array_equal(a, b)
    eligible = [random_kmer(rng, 8, AlphabetType.DNA) for _ in range(24)]
    np.testing.assert_array_equal(
        dist.count_replicated(eligible), single.count(eligible)
    )
    index._device_cache = None


def test_dist_wide_steploop_pair_fixup(rng, monkeypatch):
    """Wide + GSPMD step loop + pair-window flags firing on a non-pow2
    mesh: the fixup sub-batch must keep mesh divisibility
    (ranges64 pad_multiple) and stay exact."""
    import avxwindowfmindex_tpu.search64 as search64_mod
    from avxwindowfmindex_tpu.utils import metrics

    monkeypatch.setattr(search64_mod, "_use_step_loop", lambda: True)
    seq = bytes(rng.choice(np.frombuffer(b"AC", np.uint8), size=4000))
    cfg = IndexConfiguration(
        suffix_array_compression_ratio=4,
        kmer_length_in_seed_table=3,
        alphabet_type=AlphabetType.DNA,
    )
    index = create_index(seq, cfg)
    flagged_before = metrics.snapshot().get("search64.pair_fixup.flagged", 0)
    wide_dev = index.to_device(refresh=True, wide=True)
    dist = DistributedSearchEngine(wide_dev, make_query_mesh(6))
    single = SearchEngine(index)
    kmers = [b"ACACACAC", b"AAAA", b"CCCCCC", b"ACAC", b"CACA"] + [
        random_kmer(rng, int(rng.integers(3, 8)), AlphabetType.DNA)
        for _ in range(40)
    ]
    np.testing.assert_array_equal(dist.count(kmers), single.count(kmers))
    assert metrics.snapshot().get(
        "search64.pair_fixup.flagged", 0
    ) > flagged_before
    index._device_cache = None


def test_dist_wide_count_replicated_steploop(rng, monkeypatch):
    """Wide count_replicated under the GSPMD step loop: the clean path
    folds flag+count lanes into one readback; a flag-rich corpus routes
    through the exact re-run. Both must equal the single-device count."""
    import avxwindowfmindex_tpu.parallel.dist as dist_mod
    import avxwindowfmindex_tpu.search64 as search64_mod

    monkeypatch.setattr(dist_mod, "_use_step_loop", lambda: True)
    monkeypatch.setattr(search64_mod, "_use_step_loop", lambda: True)
    cfg = IndexConfiguration(
        suffix_array_compression_ratio=4,
        kmer_length_in_seed_table=3,
        alphabet_type=AlphabetType.DNA,
    )
    # clean random corpus (flags unlikely) and AC-repeat corpus (flags
    # near-certain with k=3 seeds) — both paths covered
    for seq in (
        random_sequence(rng, 3000, AlphabetType.DNA),
        bytes(rng.choice(np.frombuffer(b"AC", np.uint8), size=3000)),
    ):
        index = create_index(seq, cfg)
        wide_dev = index.to_device(refresh=True, wide=True)
        dist = DistributedSearchEngine(wide_dev, make_query_mesh(4))
        single = SearchEngine(index)
        kmers = [b"ACACACAC", b"AAAACCCC", b"CACACACA", b"ACGTACGT"] + [
            random_kmer(rng, 8, AlphabetType.DNA) for _ in range(20)
        ]
        np.testing.assert_array_equal(
            dist.count_replicated(kmers), single.count(kmers)
        )
        index._device_cache = None
