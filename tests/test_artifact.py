"""Native .awfmx artifact roundtrip tests."""

import numpy as np
import pytest

from avxwindowfmindex_tpu import (
    AlphabetType,
    IndexConfiguration,
    SearchEngine,
    create_index,
    create_index_from_fasta,
)
from avxwindowfmindex_tpu.io import artifact

from oracle import random_kmer, random_sequence


@pytest.mark.parametrize("alphabet", [AlphabetType.DNA, AlphabetType.AMINO])
def test_artifact_roundtrip(rng, tmp_path, alphabet):
    seq = random_sequence(rng, 600, alphabet)
    cfg = IndexConfiguration(4, 3, alphabet)
    index = create_index(seq, cfg)
    path = str(tmp_path / "t.awfmx.npz")
    artifact.save_artifact(index, path)
    loaded = artifact.load_artifact(path)
    np.testing.assert_array_equal(loaded.bwt_letters, index.bwt_letters)
    np.testing.assert_array_equal(loaded.prefix_sums, index.prefix_sums)
    np.testing.assert_array_equal(loaded.kmer_seed_table, index.kmer_seed_table)
    np.testing.assert_array_equal(loaded.sampled_sa, index.sampled_sa)
    assert loaded.sequence == index.sequence
    kmers = [random_kmer(rng, 4, alphabet) for _ in range(20)]
    np.testing.assert_array_equal(
        SearchEngine(loaded).count(kmers), SearchEngine(index).count(kmers)
    )


def test_artifact_uncompressed_roundtrip(rng, tmp_path):
    """compress=False writes a plain NPZ (disk-speed cache writes);
    load_artifact must read it identically to the compressed form."""
    seq = random_sequence(rng, 600, AlphabetType.DNA)
    cfg = IndexConfiguration(4, 3, AlphabetType.DNA)
    index = create_index(seq, cfg)
    path = str(tmp_path / "t.awfmx")
    artifact.save_artifact(index, path, compress=False)
    loaded = artifact.load_artifact(path)
    np.testing.assert_array_equal(loaded.bwt_letters, index.bwt_letters)
    np.testing.assert_array_equal(loaded.sampled_sa, index.sampled_sa)
    kmers = [random_kmer(rng, 4, AlphabetType.DNA) for _ in range(10)]
    np.testing.assert_array_equal(
        SearchEngine(loaded).count(kmers), SearchEngine(index).count(kmers)
    )


def test_artifact_with_fasta_metadata(rng, tmp_path):
    fasta = tmp_path / "m.fasta"
    fasta.write_text(">one\nGATTACA\n>two\nACGTACGT\n")
    index = create_index_from_fasta(str(fasta), IndexConfiguration(2, 2, AlphabetType.DNA))
    path = str(tmp_path / "t.awfmx.npz")
    artifact.save_artifact(index, path)
    loaded = artifact.load_artifact(path)
    assert loaded.num_sequences() == 2
    assert loaded.get_header(1) == b"two"
    seqn, local = loaded.get_local_sequence_position(8)
    assert (int(seqn), int(local)) == (1, 1)


def test_artifact_plain_awfmx_extension_roundtrip(rng, tmp_path):
    """save_artifact('x.awfmx') must be loadable as 'x.awfmx' — numpy's
    savez appends '.npz' to bare string paths, breaking the advertised
    round trip unless written through a file object."""
    seq = random_sequence(rng, 1200, AlphabetType.DNA)
    index = create_index(seq, IndexConfiguration(4, 3, AlphabetType.DNA))
    path = tmp_path / "plain.awfmx"
    artifact.save_artifact(index, str(path))
    assert path.exists()
    loaded = artifact.load_artifact(str(path))
    kmers = [random_kmer(rng, 6, AlphabetType.DNA) for _ in range(20)]
    np.testing.assert_array_equal(
        SearchEngine(loaded).count(kmers), SearchEngine(index).count(kmers)
    )


def test_artifact_preserves_device_sa(rng, tmp_path):
    """The denser device-only SA (create_index(device_sa_ratio=r))
    survives the artifact round trip — a warm-started deployment keeps
    its short locate chains (bench.py AWFM_BENCH_CACHE relies on it)."""
    seq = random_sequence(rng, 800, AlphabetType.DNA)
    cfg = IndexConfiguration(8, 3, AlphabetType.DNA)
    index = create_index(seq, cfg, device_sa_ratio=2)
    assert index.device_sa is not None
    path = str(tmp_path / "d.awfmx")
    artifact.save_artifact(index, path)
    loaded = artifact.load_artifact(path)
    np.testing.assert_array_equal(loaded.device_sa, index.device_sa)
    assert loaded.device_sa_ratio == index.device_sa_ratio
    kmers = [random_kmer(rng, 5, AlphabetType.DNA) for _ in range(20)]
    a = [sorted(h.tolist()) for h in SearchEngine(loaded).locate(kmers)]
    b = [sorted(h.tolist()) for h in SearchEngine(index).locate(kmers)]
    assert a == b


def test_ngram_build_cache_roundtrip(rng, tmp_path):
    """build_ngram_device(cache_path=...) writes finished host rows and
    reloads them bit-identically (and ignores a stale cache whose
    prebias flag differs)."""
    from avxwindowfmindex_tpu.ops import ngram as ngram_ops

    seq = random_sequence(rng, 700, AlphabetType.DNA)
    index = create_index(seq, IndexConfiguration(4, 3, AlphabetType.DNA))
    path = str(tmp_path / "ng.npz")
    fresh = ngram_ops.build_ngram_device(index, 2, cache_path=path)
    cached = ngram_ops.build_ngram_device(index, 2, cache_path=path)
    np.testing.assert_array_equal(
        np.asarray(fresh.packed), np.asarray(cached.packed)
    )
    np.testing.assert_array_equal(np.asarray(fresh.cn), np.asarray(cached.cn))
    assert cached.biased == fresh.biased
    # flipped prebias must NOT serve the stale cache
    other = ngram_ops.build_ngram_device(
        index, 2, bias_cn=not fresh.biased, cache_path=path
    )
    assert other.biased == (not fresh.biased)
    # an n=2 cache file must NOT be served to an n=3 build (the rows'
    # geometry differs; a silent hit would corrupt every result)
    tri = ngram_ops.build_ngram_device(index, 3, cache_path=path)
    assert tri.n == 3
    assert np.asarray(tri.packed).shape != np.asarray(fresh.packed).shape
    # nor a cache built from a DIFFERENT corpus (bwt_length mismatch)
    seq2 = random_sequence(rng, 900, AlphabetType.DNA)
    index2 = create_index(seq2, IndexConfiguration(4, 3, AlphabetType.DNA))
    crossed = ngram_ops.build_ngram_device(index2, 2, cache_path=path)
    assert np.asarray(crossed.packed).shape[0] != np.asarray(fresh.packed).shape[0]


def test_artifact_version_gate(rng, tmp_path):
    """New artifacts stamp v3 (u32 SA arrays on narrow indexes); the
    loader accepts v1-v3 and rejects anything newer by version number,
    not by KeyError."""
    seq = random_sequence(rng, 600, AlphabetType.DNA)
    index = create_index(seq, IndexConfiguration(4, 3, AlphabetType.DNA))
    path = str(tmp_path / "v.awfmx")
    artifact.save_artifact(index, path)
    with np.load(path) as z:
        payload = {k: z[k] for k in z.files}
    assert int(payload["format_version"]) == 3
    assert payload["sampled_sa"].dtype == np.uint32  # narrow v3 width
    # a v2-era file (u64 arrays) still loads with identical values
    payload["format_version"] = np.int64(2)
    payload["sampled_sa"] = payload["sampled_sa"].astype(np.uint64)
    with open(path, "wb") as fh:
        np.savez(fh, **payload)
    v2 = artifact.load_artifact(path)
    assert v2.sampled_sa.dtype == np.uint64
    np.testing.assert_array_equal(v2.sampled_sa, index.sampled_sa)
    # a v1 file (always carries the seed table) still loads
    payload["format_version"] = np.int64(1)
    with open(path, "wb") as fh:
        np.savez(fh, **payload)
    assert artifact.load_artifact(path).bwt_length == index.bwt_length
    # an unknown future version is rejected with a clear error
    payload["format_version"] = np.int64(4)
    with open(path, "wb") as fh:
        np.savez(fh, **payload)
    with pytest.raises(ValueError, match="version 4"):
        artifact.load_artifact(path)


def test_artifact_without_host_seed_table(rng, tmp_path):
    """An index whose seed table lives only on device serializes WITHOUT
    it (no device->host pull) and load_artifact rebuilds it via the device
    BFS — results identical."""
    seq = random_sequence(rng, 900, AlphabetType.DNA)
    index = create_index(seq, IndexConfiguration(4, 4, AlphabetType.DNA))
    kmers = [random_kmer(rng, 6, AlphabetType.DNA) for _ in range(30)]
    want = list(SearchEngine(index).count(kmers))
    index.kmer_seed_table = None  # simulate the device-only state
    path = str(tmp_path / "ns.awfmx")
    artifact.save_artifact(index, path)
    import numpy as _np

    with _np.load(path) as z:
        assert "kmer_seed_table" not in z
    loaded = artifact.load_artifact(path)
    assert list(SearchEngine(loaded).count(kmers)) == want
