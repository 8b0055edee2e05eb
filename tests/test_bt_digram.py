"""Pair-LF backtrace rows (ops/bt_digram.py).

The pair walk must be bit-identical to the single-LF reference walk
(AwFmParallelSearch.c:343-354 semantics): same sampled position, same
offset, for every chain — including sentinel hits, ambiguity letters,
and blocks with tail padding.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from avxwindowfmindex_tpu import (
    AlphabetType,
    IndexConfiguration,
    SearchEngine,
    create_index,
)
from avxwindowfmindex_tpu.ops import bt_digram, rank as rank_ops
from avxwindowfmindex_tpu import search as search_mod

from oracle import match_positions, random_kmer, random_sequence


def _cfg(ratio=8, k=3):
    return IndexConfiguration(
        suffix_array_compression_ratio=ratio,
        kmer_length_in_seed_table=k,
        alphabet_type=AlphabetType.DNA,
    )


def _build(rng, n, ratio=8):
    seq = random_sequence(rng, n, AlphabetType.DNA)  # includes ambiguity
    index = create_index(seq, _cfg(ratio=ratio))
    return seq, index


def test_pair_lf_matches_single_lf_composition(rng):
    """lf1 == LF(p) for all p; lf2 == LF(LF(p)) wherever lf1 is not the
    sentinel's 0 (the walk never consumes lf2 past a sentinel)."""
    for n in (61, 256, 700, 2048):
        _, index = _build(rng, n)
        dev = index.to_device()
        bt = bt_digram.build_backtrace_digram_device(index)
        p = jnp.arange(index.bwt_length, dtype=jnp.uint32)
        lett, lf_ref = rank_ops.letter_and_lf_at(dev, p)
        lf1, lf2 = bt_digram.pair_lf_at(bt, p)
        np.testing.assert_array_equal(np.asarray(lf1), np.asarray(lf_ref))
        _, lf2_ref = rank_ops.letter_and_lf_at(dev, lf_ref)
        ok = np.asarray(lett) != dev.sentinel  # lf2 defined off-sentinel
        np.testing.assert_array_equal(
            np.asarray(lf2)[ok], np.asarray(lf2_ref)[ok]
        )


@pytest.mark.parametrize("ratio", [2, 3, 8])
def test_backtrace_all_pair_equals_single(rng, ratio):
    for n in (100, 1500):
        _, index = _build(rng, n, ratio=ratio)
        dev = index.to_device()
        bt = bt_digram.build_backtrace_digram_device(index)
        pos = jnp.asarray(
            rng.integers(0, index.bwt_length, size=512).astype(np.uint32)
        )
        p0, off0 = search_mod.backtrace_all(dev, pos)
        p1, off1 = search_mod.backtrace_all(dev, pos, bt)
        np.testing.assert_array_equal(np.asarray(p1), np.asarray(p0))
        np.testing.assert_array_equal(np.asarray(off1), np.asarray(off0))


def test_backtrace_pair_steploop_mode(rng, monkeypatch):
    """The fused step-loop schedule (the accelerator path) gives the same
    walk as the scan formulation."""
    _, index = _build(rng, 900, ratio=8)
    dev = index.to_device()
    bt = bt_digram.build_backtrace_digram_device(index)
    pos = jnp.asarray(
        rng.integers(0, index.bwt_length, size=256).astype(np.uint32)
    )
    p0, off0 = search_mod.backtrace_all(dev, pos)
    monkeypatch.setattr(search_mod, "_use_step_loop", lambda: True)
    p1, off1 = search_mod.backtrace_all(dev, pos, bt)
    np.testing.assert_array_equal(np.asarray(p1), np.asarray(p0))
    np.testing.assert_array_equal(np.asarray(off1), np.asarray(off0))


def test_locate_with_and_without_bt(rng, monkeypatch):
    seq, index = _build(rng, 1200, ratio=8)
    kmers = [random_kmer(rng, int(rng.integers(1, 7)), AlphabetType.DNA)
             for _ in range(40)]
    monkeypatch.setenv("AWFM_BT_DIGRAM", "1")  # opt-in accelerator
    engine = SearchEngine(index)
    assert engine._bt_digram() is not None
    hits_bt = engine.locate(kmers)
    monkeypatch.delenv("AWFM_BT_DIGRAM")
    engine2 = SearchEngine(index)
    assert engine2._bt_digram() is None  # off by default
    hits_plain = engine2.locate(kmers)
    for kmer, a, b in zip(kmers, hits_bt, hits_plain):
        np.testing.assert_array_equal(a, b)
        want = match_positions(seq, kmer, AlphabetType.DNA)
        np.testing.assert_array_equal(np.sort(a.astype(np.int64)), want)


def test_locate_flat_device_with_bt(rng):
    seq, index = _build(rng, 800, ratio=8)
    dev = index.to_device()
    bt = bt_digram.build_backtrace_digram_device(index)
    engine = SearchEngine(index)
    kmers = [random_kmer(rng, 3, AlphabetType.DNA) for _ in range(16)]
    ranges = engine.find_ranges(kmers)
    s = jnp.asarray(ranges[:, 0].astype(np.uint32))
    e = jnp.asarray(ranges[:, 1].astype(np.uint32))
    total = search_mod.total_hits_host(s, e)
    cap = search_mod._round_up_pow2(max(total, 16))
    hits, qid, mask = search_mod.locate_flat_device(dev, s, e, capacity=cap, bt=bt)
    hits = np.asarray(hits)[np.asarray(mask)]
    qid = np.asarray(qid)[np.asarray(mask)]
    for i, kmer in enumerate(kmers):
        want = match_positions(seq, kmer, AlphabetType.DNA)
        got = np.sort(hits[qid == i].astype(np.int64))
        np.testing.assert_array_equal(got, want, err_msg=repr(kmer))


def test_amino_build_raises(rng):
    seq = random_sequence(rng, 300, AlphabetType.AMINO)
    cfg = IndexConfiguration(
        suffix_array_compression_ratio=4,
        kmer_length_in_seed_table=2,
        alphabet_type=AlphabetType.AMINO,
    )
    index = create_index(seq, cfg)
    with pytest.raises(NotImplementedError):
        bt_digram.build_backtrace_digram_device(index)
    # the engine silently skips the accelerator for amino
    assert SearchEngine(index)._bt_digram() is None
