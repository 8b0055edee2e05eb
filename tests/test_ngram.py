"""n-step (n-gram) search parity tests (n = 2 and 3).

The n-gram path must return bit-identical ranges/counts/hits to the
single-step engine on its fast path, and fall back transparently
elsewhere.
"""

import numpy as np
import pytest

from avxwindowfmindex_tpu import (
    AlphabetType,
    IndexConfiguration,
    SearchEngine,
    create_index,
)
from avxwindowfmindex_tpu.ops import ngram as ngram_ops
from avxwindowfmindex_tpu.search import DigramSearchEngine, NgramSearchEngine

from oracle import count_occurrences, random_kmer, random_sequence


def _cfg(k=3, ratio=4):
    return IndexConfiguration(
        suffix_array_compression_ratio=ratio,
        kmer_length_in_seed_table=k,
        alphabet_type=AlphabetType.DNA,
    )


@pytest.mark.parametrize("n", [2, 3])
def test_ngram_codes_match_definition(rng, n):
    # BWTn[i] = the n characters preceding suffix SA[i]
    from avxwindowfmindex_tpu.models import alphabet as alpha
    from oracle import suffix_array_naive

    seq = random_sequence(rng, 400, AlphabetType.DNA)
    index = create_index(seq, _cfg())
    codes, cn = ngram_ops.build_ngram_host(index, n)
    dirty = 4**n
    sanitized = alpha.sanitize(np.frombuffer(seq, np.uint8), AlphabetType.DNA)
    full = bytes(sanitized) + b"$"
    sa = suffix_array_naive(full)
    lett = alpha.ascii_to_index(np.frombuffer(full, np.uint8), AlphabetType.DNA)
    for i in range(index.bwt_length):
        p = sa[i]
        if p < n:
            assert codes[i] == dirty, i
        else:
            window = [int(lett[p - n + j]) for j in range(n)]
            if all(x < 4 for x in window):
                want = 0
                for x in window:
                    want = want * 4 + x
            else:
                want = dirty
            assert codes[i] == want, (i, p, window)


@pytest.mark.parametrize("n", [2, 3])
def test_cn_is_nmer_range_start(rng, n):
    seq = random_sequence(rng, 800, AlphabetType.DNA, clean=True)
    index = create_index(seq, _cfg(k=n))
    _, cn = ngram_ops.build_ngram_host(index, n)
    # present n-mers: cn must equal the seed table's range start
    for w in range(4**n):
        start, end = index.kmer_seed_table[w]
        if start <= end:
            assert cn[w] == start, w


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("kmer_len", [4, 5, 9, 12, 13])
def test_ngram_counts_match_single_step(rng, n, kmer_len):
    seq = random_sequence(rng, int(rng.integers(500, 3000)), AlphabetType.DNA)
    index = create_index(seq, _cfg())
    single = SearchEngine(index)
    multi = NgramSearchEngine(index, n=n)
    kmers = [random_kmer(rng, kmer_len, AlphabetType.DNA) for _ in range(150)]
    counts = multi.count(kmers)
    np.testing.assert_array_equal(counts, single.count(kmers))
    for kmer, got in zip(kmers, counts):
        assert got == count_occurrences(seq, kmer, AlphabetType.DNA), kmer


@pytest.mark.parametrize("n", [2, 3])
def test_ngram_locate_matches(rng, n):
    seq = random_sequence(rng, 1500, AlphabetType.DNA)
    index = create_index(seq, _cfg(ratio=3))
    single = SearchEngine(index)
    multi = NgramSearchEngine(index, n=n)
    kmers = [random_kmer(rng, 7, AlphabetType.DNA) for _ in range(60)]
    got = multi.locate(kmers)
    want = single.locate(kmers)
    for kmer, a, b in zip(kmers, got, want):
        np.testing.assert_array_equal(a, b, err_msg=repr(kmer))


def test_ngram_fallback_paths(rng):
    seq = random_sequence(rng, 800, AlphabetType.DNA)
    index = create_index(seq, _cfg(k=4))
    single = SearchEngine(index)
    multi = NgramSearchEngine(index, n=3)
    # mixed lengths -> fallback
    kmers = [b"ACGT", b"ACGTAC", b"GATTACA"]
    np.testing.assert_array_equal(multi.count(kmers), single.count(kmers))
    # ambiguity chars -> fallback
    kmers = [b"ACGNT", b"ACGNT", b"ACGNT"]
    np.testing.assert_array_equal(multi.count(kmers), single.count(kmers))
    # exactly seed-length -> pure seed lookup
    kmers = [b"ACGT", b"TTTT"]
    np.testing.assert_array_equal(multi.count(kmers), single.count(kmers))


def test_digram_alias(rng):
    seq = random_sequence(rng, 500, AlphabetType.DNA)
    index = create_index(seq, _cfg())
    eng = DigramSearchEngine(index)
    assert eng.ng.n == 2
    assert eng.count([b"GATTACA"])[0] == count_occurrences(
        seq, b"GATTACA", AlphabetType.DNA
    )


def test_ngram_rejects_amino(rng):
    seq = random_sequence(rng, 200, AlphabetType.AMINO)
    index = create_index(seq, IndexConfiguration(4, 2, AlphabetType.AMINO))
    with pytest.raises(NotImplementedError):
        NgramSearchEngine(index, n=2)


def test_invalid_n(rng):
    seq = random_sequence(rng, 200, AlphabetType.DNA)
    index = create_index(seq, _cfg())
    with pytest.raises(ValueError):
        NgramSearchEngine(index, n=4)


@pytest.mark.parametrize("fuse", ["1", "2", "3"])
@pytest.mark.parametrize("n", [2, 3])
def test_steploop_fused_matches_scan(rng, monkeypatch, n, fuse):
    # the step-loop + fusion path normally runs only on accelerator backends;
    # force it here and compare against the scan path
    import avxwindowfmindex_tpu.search as search_mod

    monkeypatch.setattr(search_mod, "_use_step_loop", lambda: True)
    monkeypatch.setenv("AWFM_FUSE_STEPS", fuse)
    seq = random_sequence(rng, 1200, AlphabetType.DNA)
    index = create_index(seq, _cfg())
    single = SearchEngine(index)
    multi = NgramSearchEngine(index, n=n)
    kmers = [random_kmer(rng, 11, AlphabetType.DNA) for _ in range(80)]
    counts = multi.count(kmers)
    np.testing.assert_array_equal(counts, single.count(kmers))
    # ragged batch exercises the masked single-step loop
    ragged = [random_kmer(rng, int(rng.integers(2, 9)), AlphabetType.DNA)
              for _ in range(40)]
    np.testing.assert_array_equal(multi.count(ragged), single.count(ragged))


@pytest.mark.parametrize("n", [2, 3])
def test_chunked_host_build_matches_unchunked(rng, n, monkeypatch):
    # genome-scale builds stream in _HOST_CHUNK pieces; force many tiny
    # chunks and require bit-identical codes/Cn
    seq = random_sequence(rng, 3000, AlphabetType.DNA)
    index = create_index(seq, _cfg())
    want_codes, want_cn = ngram_ops.build_ngram_host(index, n)
    monkeypatch.setattr(ngram_ops, "_HOST_CHUNK", 257)  # not a divisor
    got_codes, got_cn = ngram_ops.build_ngram_host(index, n)
    np.testing.assert_array_equal(got_codes, want_codes)
    np.testing.assert_array_equal(got_cn, want_cn)


def test_letter_counts_before_matches_bruteforce(rng):
    bwt = rng.integers(0, 6, size=5000).astype(np.uint8)
    bounds = np.array([0, 1, 256, 257, 4999, 5000, 2500, 5000])
    out = ngram_ops._letter_counts_before(bwt, bounds)
    for i, b in enumerate(bounds):
        for x in range(4):
            assert out[x, i] == int((bwt[:b] == x).sum()), (x, b)


def test_letter_counts_before_chunked(rng, monkeypatch):
    monkeypatch.setattr(ngram_ops, "_HOST_CHUNK", 64)
    bwt = rng.integers(0, 6, size=1000).astype(np.uint8)
    bounds = rng.integers(0, 1001, size=16)
    out = ngram_ops._letter_counts_before(bwt, bounds)
    for i, b in enumerate(bounds):
        for x in range(4):
            assert out[x, i] == int((bwt[:b] == x).sum()), (x, b)


@pytest.mark.parametrize("knob", ["AWFM_NGRAM_U32", "AWFM_MS_WSUM", "AWFM_OCC_DOT"])
def test_u32_lane_path_identical(rng, monkeypatch, knob):
    """Alternate kernel formulations must be bit-identical to the
    byte-lane default for both step formulations: AWFM_NGRAM_U32
    (u32-lane match/mask/popcount) and AWFM_MS_WSUM (weighted-byte-sum
    milestone select, no bitcast)."""
    import jax.numpy as jnp

    from avxwindowfmindex_tpu import AlphabetType, IndexConfiguration, create_index
    from avxwindowfmindex_tpu.ops import ngram as ngram_ops

    seq = bytes(
        rng.choice(np.frombuffer(b"ACGT", np.uint8), size=4000).tobytes()
    )
    cfg = IndexConfiguration(4, 3, AlphabetType.DNA)
    index = create_index(seq, cfg)
    ng = ngram_ops.build_ngram_device(index, 2)

    b = 512
    start = jnp.asarray(
        rng.integers(0, index.bwt_length - 1, size=b).astype(np.uint32)
    )
    width = rng.integers(0, 600, size=b).astype(np.uint32)
    end = jnp.asarray(
        np.minimum(
            np.asarray(start, dtype=np.uint64) + width,
            index.bwt_length - 1,
        ).astype(np.uint32)
    )
    letters = [
        jnp.asarray(rng.integers(0, 4, size=b).astype(np.int32))
        for _ in range(2)
    ]
    pos = jnp.asarray(
        rng.integers(0, index.bwt_length, size=b).astype(np.uint32)
    )

    def run_all():
        # fresh traces per env setting: the knob is read at trace time
        occ = jnp.asarray(ngram_ops.ngram_occurrence(ng, pos, letters))
        s1, e1 = ngram_ops.ngram_backward_step(ng, start, end, letters)
        s2, e2, bad = ngram_ops.ngram_backward_step_pair(
            ng, start, end, letters, jnp.zeros(b, dtype=bool)
        )
        return (
            np.asarray(occ), np.asarray(s1), np.asarray(e1),
            np.asarray(s2), np.asarray(e2), np.asarray(bad),
        )

    monkeypatch.setenv(knob, "0")
    base = run_all()
    monkeypatch.setenv(knob, "1")
    got = run_all()
    for a, b_ in zip(base, got):
        np.testing.assert_array_equal(a, b_)


def test_prebias_milestones_identical(rng):
    """A Cn-pre-biased table (AWFM_MS_PREBIAS / bias_cn=True) must give
    bit-identical backward steps to the unbiased table in both
    formulations, and its occurrence must be exactly Cn[w] + occ."""
    import jax.numpy as jnp

    from avxwindowfmindex_tpu import AlphabetType, IndexConfiguration, create_index
    from avxwindowfmindex_tpu.ops import ngram as ngram_ops

    seq = bytes(
        rng.choice(np.frombuffer(b"ACGT", np.uint8), size=5000).tobytes()
    )
    index = create_index(seq, IndexConfiguration(4, 3, AlphabetType.DNA))
    ng = ngram_ops.build_ngram_device(index, 2, bias_cn=False)
    ngb = ngram_ops.build_ngram_device(index, 2, bias_cn=True)
    assert not ng.biased and ngb.biased

    b = 512
    start = jnp.asarray(
        rng.integers(0, index.bwt_length - 1, size=b).astype(np.uint32)
    )
    width = rng.integers(0, 600, size=b).astype(np.uint32)
    end = jnp.asarray(
        np.minimum(
            np.asarray(start, dtype=np.uint64) + width,
            index.bwt_length - 1,
        ).astype(np.uint32)
    )
    letters = [
        jnp.asarray(rng.integers(0, 4, size=b).astype(np.int32))
        for _ in range(2)
    ]
    pos = jnp.asarray(
        rng.integers(0, index.bwt_length, size=b).astype(np.uint32)
    )

    s1, e1 = ngram_ops.ngram_backward_step(ng, start, end, letters)
    s1b, e1b = ngram_ops.ngram_backward_step(ngb, start, end, letters)
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s1b))
    np.testing.assert_array_equal(np.asarray(e1), np.asarray(e1b))

    bad0 = jnp.zeros(b, dtype=bool)
    s2, e2, bad = ngram_ops.ngram_backward_step_pair(ng, start, end, letters, bad0)
    s2b, e2b, badb = ngram_ops.ngram_backward_step_pair(ngb, start, end, letters, bad0)
    np.testing.assert_array_equal(np.asarray(s2), np.asarray(s2b))
    np.testing.assert_array_equal(np.asarray(e2), np.asarray(e2b))
    np.testing.assert_array_equal(np.asarray(bad), np.asarray(badb))

    occ = np.asarray(ngram_ops.ngram_occurrence(ng, pos, letters))
    occb = np.asarray(ngram_ops.ngram_occurrence(ngb, pos, letters))
    v = np.asarray(letters[0]) * 4 + np.asarray(letters[1])
    cn = np.asarray(ng.cn)
    np.testing.assert_array_equal(occb, occ + cn[v])
