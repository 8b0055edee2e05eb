"""Pair-row (one-gather) backward step: correctness incl. the flag/fixup.

The pair step is exact only while a query's range fits its 512-position
pair window; wider ranges are flagged on device and re-run through the
classic two-gather step (search._fixup_flagged). These tests force the
accelerator step-loop path on CPU and attack exactly that machinery:

  - repeat-rich sequences whose seed ranges stay wide for several steps
    (near-certain flagging);
  - mixed-length (masked) batches — the steploop's masked branch;
  - amino batches (256-position blocks, 512 B pair rows);
  - the AWFM_PAIR_ROWS=0 escape hatch.
"""

import numpy as np
import pytest

import avxwindowfmindex_tpu.search as search_mod
from avxwindowfmindex_tpu import (
    AlphabetType,
    IndexConfiguration,
    NgramSearchEngine,
    SearchEngine,
    create_index,
)

from oracle import count_occurrences, random_kmer, random_sequence


def _cfg(alphabet=AlphabetType.DNA, k=3, ratio=4):
    return IndexConfiguration(
        suffix_array_compression_ratio=ratio,
        kmer_length_in_seed_table=k,
        alphabet_type=alphabet,
    )


@pytest.fixture
def steploop(monkeypatch):
    monkeypatch.setattr(search_mod, "_use_step_loop", lambda: True)


def _repeat_rich_sequence(rng, n):
    """~half the text is AAAA/ACAC runs: seed ranges stay wide."""
    seq = bytearray(random_sequence(rng, n, AlphabetType.DNA))
    i = 0
    while i < n - 64:
        run = rng.integers(16, 64)
        if rng.random() < 0.5:
            seq[i : i + run] = (b"A" * run)
        i += run * 2
    return bytes(seq)


def test_pair_step_flags_and_fixup(rng, steploop, monkeypatch):
    seq = _repeat_rich_sequence(rng, 6000)
    index = create_index(seq, _cfg(k=2))  # k=2: very wide seed ranges
    eng = SearchEngine(index)
    assert eng.dev.packed_pair is not None
    # spy: the fixup must actually fire for this corpus (else the test
    # isn't exercising the flag machinery at all)
    fired = []
    real_fixup = search_mod._fixup_flagged

    def spy(dev, mat, lengths, start, end, bad, classic_fn, defer=None,
            pad_multiple=1):
        import numpy as _np

        fired.append(int(_np.asarray(search_mod._flag_count(bad))))
        return real_fixup(dev, mat, lengths, start, end, bad, classic_fn,
                          defer, pad_multiple)

    monkeypatch.setattr(search_mod, "_fixup_flagged", spy)
    # poly-A kmers keep ranges wide through MANY steps -> flags fire
    kmers = [b"AAAA", b"AAAAAAA", b"AAAAAAAAAA", b"ACAAAAAT"]
    kmers += [random_kmer(rng, int(rng.integers(3, 10)), AlphabetType.DNA)
              for _ in range(60)]
    got = eng.count(kmers)
    want = np.array([count_occurrences(seq, k, AlphabetType.DNA) for k in kmers], dtype=np.uint64)
    np.testing.assert_array_equal(got, want)
    assert sum(fired) > 0, "adversarial corpus failed to trigger any flags"


def test_pair_step_mixed_lengths_masked_branch(rng, steploop):
    # non-uniform lengths drive the masked (active) pair-step branch
    seq = random_sequence(rng, 5000, AlphabetType.DNA)
    index = create_index(seq, _cfg(k=3))
    eng = SearchEngine(index)
    kmers = [random_kmer(rng, int(rng.integers(3, 15)), AlphabetType.DNA)
             for _ in range(120)]
    lengths = {len(k) for k in kmers}
    assert len(lengths) > 1
    got = eng.count(kmers)
    want = np.array([count_occurrences(seq, k, AlphabetType.DNA) for k in kmers], dtype=np.uint64)
    np.testing.assert_array_equal(got, want)
    # locate goes through the same ranges
    hits = eng.locate(kmers[:20])
    for k, h in zip(kmers[:20], hits):
        assert len(h) == count_occurrences(seq, k, AlphabetType.DNA)


@pytest.mark.parametrize("alphabet", [AlphabetType.DNA, AlphabetType.AMINO])
def test_pair_step_alphabets(rng, steploop, alphabet):
    seq = random_sequence(rng, 4000, alphabet)
    index = create_index(seq, _cfg(alphabet, k=2))
    eng = SearchEngine(index)
    kmers = [random_kmer(rng, int(rng.integers(2, 12)), alphabet)
             for _ in range(100)]
    got = eng.count(kmers)
    want = np.array(
        [count_occurrences(seq, k, alphabet) for k in kmers], dtype=np.uint64
    )
    np.testing.assert_array_equal(got, want)


def test_ngram_pair_flags_and_fixup(rng, steploop):
    seq = _repeat_rich_sequence(rng, 8000)
    index = create_index(seq, _cfg(k=2))
    eng = NgramSearchEngine(index, n=2)
    single = SearchEngine(index)
    # uniform-length clean batch (the n-gram fast path), poly-A heavy
    kmers = [b"AAAAAAAAAA", b"ACGTACGTAC", b"AAAAAAAAAT", b"TAAAAAAAAA"]
    kmers += [random_kmer(rng, 10, AlphabetType.DNA) for _ in range(60)]
    np.testing.assert_array_equal(eng.count(kmers), single.count(kmers))
    want = np.array([count_occurrences(seq, k, AlphabetType.DNA) for k in kmers], dtype=np.uint64)
    np.testing.assert_array_equal(eng.count(kmers), want)


def test_pair_rows_disabled_matches(rng, steploop, monkeypatch):
    seq = random_sequence(rng, 3000, AlphabetType.DNA)
    kmers = [random_kmer(rng, 8, AlphabetType.DNA) for _ in range(50)]
    index = create_index(seq, _cfg())
    with_pair = SearchEngine(index).count(kmers)
    monkeypatch.setenv("AWFM_PAIR_ROWS", "0")
    index2 = create_index(seq, _cfg())
    eng2 = SearchEngine(index2)
    assert eng2.dev.packed_pair is None
    np.testing.assert_array_equal(eng2.count(kmers), with_pair)


def test_pair_single_position_rank_matches_classic(rng):
    # pair_occurrence_single must be bit-identical to occurrence()
    import jax.numpy as jnp

    from avxwindowfmindex_tpu.ops import rank as rank_ops

    seq = random_sequence(rng, 3000, AlphabetType.DNA)
    index = create_index(seq, _cfg())
    dev = index.to_device()
    positions = jnp.asarray(
        rng.integers(0, index.bwt_length, 512).astype(np.uint32)
    )
    letts = jnp.asarray(rng.integers(0, 5, 512).astype(np.int32))
    a = rank_ops.occurrence(dev, positions, letts)
    b = rank_ops.pair_occurrence_single(dev, positions, letts)
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_deferred_fixup_exactness(rng, steploop):
    """defer=pend returns speculative ranges + a redo closure; the redo
    must deliver the exact two-gather answer for flagged batches."""
    seq = _repeat_rich_sequence(rng, 6000)
    index = create_index(seq, _cfg(k=2))
    eng = SearchEngine(index)
    kmers = [b"AAAA", b"AAAAAAA", b"AAAAAAAAAA", b"ACAAAAAT"] * 8
    mat, lengths, n = eng.encode_kmers(kmers)
    pend = []
    s_spec, e_spec = search_mod._ranges_steploop(
        eng.dev, mat, lengths, seeded=True, defer=pend
    )
    assert len(pend) == 1
    flag_count, redo = pend[0]
    assert int(np.asarray(flag_count)) > 0  # adversarial corpus flags
    s_exact, e_exact = redo()
    want = eng.find_ranges(kmers)  # synchronous (fixed-up) path
    np.testing.assert_array_equal(np.asarray(s_exact)[:n], want[:, 0])
    np.testing.assert_array_equal(np.asarray(e_exact)[:n], want[:, 1])
    # unflagged batch: speculative ranges are already exact, no redo
    clean = [random_kmer(rng, 8, AlphabetType.DNA) for _ in range(32)]
    mat2, lengths2, n2 = eng.encode_kmers(clean)
    pend2 = []
    s2, e2 = search_mod._ranges_steploop(
        eng.dev, mat2, lengths2, seeded=True, defer=pend2
    )
    if pend2 and int(np.asarray(pend2[0][0])) == 0:
        want2 = eng.find_ranges(clean)
        np.testing.assert_array_equal(np.asarray(s2)[:n2], want2[:, 0])
        np.testing.assert_array_equal(np.asarray(e2)[:n2], want2[:, 1])


def test_pair_overflow_flag_for_u32_wide_ranges(rng):
    """Widths >= 2^31 must still raise the pair-window flag.

    Regression: the window offset was cast uint32->int32 BEFORE the
    >= 512 comparison, so a range wider than 2^31 wrapped negative,
    escaped the flag, and silently returned a collapsed range instead
    of routing through the exact two-gather fixup.
    """
    import jax.numpy as jnp

    from avxwindowfmindex_tpu.ops import ngram as ngram_ops
    from avxwindowfmindex_tpu.ops import rank as rank_ops

    seq = random_sequence(rng, 4000, AlphabetType.DNA)
    index = create_index(seq, _cfg())
    dev = index.to_device()
    # synthetic ranges: [1, 2^31+5] (the int32-wrap width) and [1, 600]
    # (an ordinary over-window width); both must flag
    start = jnp.asarray(np.array([1, 1], dtype=np.uint32))
    end = jnp.asarray(np.array([2**31 + 5, 600], dtype=np.uint32))
    lett = jnp.zeros(2, dtype=jnp.int32)
    bad = jnp.zeros(2, dtype=bool)
    _, _, bad_out = rank_ops.backward_step_pair(dev, start, end, lett, bad)
    assert bool(np.asarray(bad_out).all())

    ng = ngram_ops.build_ngram_device(index, 2)
    bad2 = jnp.zeros(2, dtype=bool)
    _, _, bad2_out = ngram_ops.ngram_backward_step_pair(
        ng, start, end, [lett, lett], bad2
    )
    assert bool(np.asarray(bad2_out).all())


def test_engine_steploop_single_readback_fold(rng, steploop):
    """The public engine's step-loop branch joins [flags, start, end]
    into one readback; flagged batches must still produce exact counts
    (vs the scan-mode engine) through the rare-redo branch."""
    seq = _repeat_rich_sequence(rng, 6000)
    index = create_index(seq, _cfg(k=2))
    eng = SearchEngine(index)
    kmers = [b"AAAA", b"AAAAAAA", b"AAAAAAAAAA", b"ACAAAAAT"] + [
        random_kmer(rng, int(rng.integers(2, 10)), AlphabetType.DNA)
        for _ in range(60)
    ]
    got = eng.count(kmers)
    want = np.array(
        [count_occurrences(seq, k, AlphabetType.DNA) for k in kmers],
        dtype=np.uint64,
    )
    np.testing.assert_array_equal(got, want)
