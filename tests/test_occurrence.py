"""Rank-primitive property tests (model: test/occurrenceTests).

The reference tests AwFmMaskedVectorPopcount against counted bits on
known patterns and 20,000 random vectors; here the device occurrence op
is checked against a cumulative-count oracle over random BWTs, for both
alphabets, including the inclusive-mask boundary cases.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from avxwindowfmindex_tpu import AlphabetType, IndexConfiguration, create_index
from avxwindowfmindex_tpu.ops import rank as rank_ops

from oracle import random_sequence


@pytest.mark.parametrize("alphabet", [AlphabetType.DNA, AlphabetType.AMINO])
def test_occurrence_matches_cumulative_counts(rng, alphabet):
    seq = random_sequence(rng, 2000, alphabet)
    cfg = IndexConfiguration(4, 2, alphabet)
    index = create_index(seq, cfg)
    dev = index.to_device()
    bwt = index.bwt_letters.astype(np.int64)

    n = index.bwt_length
    positions = np.concatenate([
        rng.integers(0, n, size=500),
        # inclusive-mask boundaries: block edges, byte edges, bit 7
        np.array([0, 7, 8, 255 % n, min(256, n - 1), n - 1]),
    ]).astype(np.uint32)
    for lett in range(index.cardinality + 1):
        ll = np.full(len(positions), lett, dtype=np.int32)
        got = np.asarray(
            rank_ops.occurrence(dev, jnp.asarray(positions), jnp.asarray(ll))
        )
        cum = np.cumsum(bwt == lett)
        want = cum[positions.astype(np.int64)]
        np.testing.assert_array_equal(got, want, err_msg=f"letter {lett}")


@pytest.mark.parametrize("knob", ["AWFM_RANK_U32", "AWFM_MS_WSUM", "AWFM_OCC_DOT"])
@pytest.mark.parametrize("alphabet", [AlphabetType.DNA, AlphabetType.AMINO])
def test_u32_lane_rank_identical(rng, alphabet, monkeypatch, knob):
    """Alternate single-letter kernel formulations must be bit-identical
    to the byte-lane default across occurrence, the fused pair-row step,
    and the single-position pair lookup, for both alphabets:
    AWFM_RANK_U32 (u32-lane match/mask/popcount, opt-in)
    and AWFM_MS_WSUM (weighted-byte-sum milestone select)."""
    seq = random_sequence(rng, 3000, alphabet)
    index = create_index(seq, IndexConfiguration(4, 2, alphabet))
    dev = index.to_device()
    n = index.bwt_length

    b = 512
    positions = jnp.asarray(np.concatenate([
        rng.integers(0, n, size=b - 6),
        np.array([0, 7, 8, 255 % n, min(256, n - 1), n - 1]),
    ]).astype(np.uint32))
    letters = jnp.asarray(
        rng.integers(0, index.cardinality + 1, size=b).astype(np.int32)
    )
    start = jnp.asarray(rng.integers(0, n - 1, size=b).astype(np.uint32))
    width = rng.integers(0, 600, size=b).astype(np.uint32)
    end = jnp.asarray(
        np.minimum(np.asarray(start, np.uint64) + width, n - 1).astype(
            np.uint32
        )
    )

    def run_all():
        out = [np.asarray(rank_ops.occurrence(dev, positions, letters))]
        if dev.packed_pair is not None:
            s2, e2, bad = rank_ops.backward_step_pair(
                dev, start, end, letters, jnp.zeros(b, dtype=bool)
            )
            out += [np.asarray(s2), np.asarray(e2), np.asarray(bad)]
            out.append(np.asarray(
                rank_ops.pair_occurrence_single(dev, positions, letters)
            ))
        return out

    monkeypatch.setenv(knob, "0")
    base = run_all()
    monkeypatch.setenv(knob, "1")
    got = run_all()
    assert len(base) > 1 or alphabet is AlphabetType.AMINO
    for a, g in zip(base, got):
        np.testing.assert_array_equal(a, g)


@pytest.mark.parametrize("alphabet", [AlphabetType.DNA, AlphabetType.AMINO])
def test_letter_and_lf_matches_host(rng, alphabet):
    seq = random_sequence(rng, 1500, alphabet)
    index = create_index(seq, IndexConfiguration(4, 2, alphabet))
    dev = index.to_device()
    bwt = index.bwt_letters.astype(np.int64)
    ps = index.prefix_sums.astype(np.int64)
    n = index.bwt_length
    positions = rng.integers(0, n, size=400).astype(np.uint32)
    lett, lf = rank_ops.letter_and_lf_at(dev, jnp.asarray(positions))
    lett = np.asarray(lett)
    lf = np.asarray(lf)
    for p, l, f in zip(positions, lett, lf):
        assert l == bwt[p]
        if l == index.sentinel_index:
            assert f == 0
        else:
            want = ps[l] + np.sum(bwt[: p + 1] == l) - 1
            assert f == want, (p, l)
