"""64-bit-capacity device path (ops/rank64.py, search64.py).

Three layers of evidence:
  1. path equality — on ordinary (< 2^32) indexes the wide path must be
     bit-identical to the 32-bit path for count and locate;
  2. carry math — a handcrafted DeviceIndex64 whose milestones/prefix
     sums straddle 2^32 exercises every hi/lo carry against a NumPy
     uint64 oracle computed from the same synthetic arrays;
  3. (gated, AWFM_BIG_TESTS=1) a genuine > 2^32-position synthetic BWT,
     tiled from a small pattern, with rank queries across the boundary.
"""

import os

import numpy as np
import pytest

import jax.numpy as jnp

from avxwindowfmindex_tpu import (
    AlphabetType,
    IndexConfiguration,
    SearchEngine,
    create_index,
)
from avxwindowfmindex_tpu.models import alphabet as alpha
from avxwindowfmindex_tpu.ops import rank64 as r64
from avxwindowfmindex_tpu import search64

from oracle import random_kmer, random_sequence


def _cfg(alphabet=AlphabetType.DNA, k=3, ratio=4):
    return IndexConfiguration(
        suffix_array_compression_ratio=ratio,
        kmer_length_in_seed_table=k,
        alphabet_type=alphabet,
    )


@pytest.mark.parametrize("alphabet", [AlphabetType.DNA, AlphabetType.AMINO])
def test_wide_path_matches_narrow(rng, alphabet):
    seq = random_sequence(rng, 4000, alphabet)
    index = create_index(seq, _cfg(alphabet))
    narrow = SearchEngine(index)
    wide = SearchEngine(index.to_device(refresh=True, wide=True))
    wide.host_index = index
    assert wide.wide and not narrow.wide
    kmers = [
        random_kmer(rng, int(rng.integers(2, 12)), alphabet) for _ in range(200)
    ]
    np.testing.assert_array_equal(wide.count(kmers), narrow.count(kmers))
    got = wide.locate(kmers)
    want = narrow.locate(kmers)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    # drop the wide cache so later tests see the narrow default
    index._device_cache = None


def test_wide_path_unseeded_and_mixed_lengths(rng):
    seq = random_sequence(rng, 3000, AlphabetType.DNA)
    index = create_index(seq, _cfg(k=5))
    narrow = SearchEngine(index)
    wide = SearchEngine(index.to_device(refresh=True, wide=True))
    # short kmers (unseeded) + ambiguity in the last k letters + mixed
    kmers = [b"AC", b"GATTACA", b"ACGTN", b"TT", b"ACGTACGTACGT"]
    np.testing.assert_array_equal(wide.count(kmers), narrow.count(kmers))
    index._device_cache = None


def test_u64_helper_ops(rng):
    a = rng.integers(0, 2**64, size=256, dtype=np.uint64)
    b = rng.integers(0, 2**64, size=256, dtype=np.uint64)
    s = rng.integers(0, 2**32, size=256, dtype=np.uint64)
    ah, al = r64.split_u64_host(a)
    bh, bl = r64.split_u64_host(b)
    ah, al, bh, bl = map(jnp.asarray, (ah, al, bh, bl))
    su = jnp.asarray(s.astype(np.uint32))

    def join(h, l):
        return (np.asarray(h).astype(np.uint64) << np.uint64(32)) | np.asarray(
            l
        ).astype(np.uint64)

    h, l = r64.add64(ah, al, bh, bl)
    np.testing.assert_array_equal(join(h, l), a + b)
    h, l = r64.sub64(ah, al, bh, bl)
    np.testing.assert_array_equal(join(h, l), a - b)
    h, l = r64.add64_small(ah, al, su)
    np.testing.assert_array_equal(join(h, l), a + s)
    h, l = r64.sub64_small(ah, al, su)
    np.testing.assert_array_equal(join(h, l), a - s)
    np.testing.assert_array_equal(
        np.asarray(r64.le64(ah, al, bh, bl)), a <= b
    )
    for r in (1, 2, 7, 8, 255):
        np.testing.assert_array_equal(
            np.asarray(r64.mod_small64(ah, al, r)).astype(np.uint64), a % r
        )
        q = a // np.uint64(r)
        small = q < 2**32
        np.testing.assert_array_equal(
            np.asarray(r64.div_small64(ah, al, r)).astype(np.uint64)[small],
            q[small],
        )


def _synthetic_wide_dev(letters_blocks: np.ndarray, base: int,
                        alphabet=AlphabetType.DNA, ratio=8):
    """DeviceIndex64 whose milestone/prefix values sit near `base`.

    letters_blocks: (nb, 256) uint8 letter indices. The milestones are
    the true per-block cumulative counts OFFSET by `base` per letter —
    arithmetically consistent rank queries with values straddling 2^32.
    """
    nb = letters_blocks.shape[0]
    card = alpha.cardinality(alphabet)
    counts = np.stack(
        [(letters_blocks == j).sum(axis=1) for j in range(card + 2)], axis=1
    ).astype(np.uint64)
    cum = np.cumsum(counts, axis=0)
    ms = np.zeros_like(cum)
    ms[1:] = cum[:-1]
    ms += np.uint64(base)
    packed = r64.pack_device_blocks64(
        letters_blocks.reshape(-1), ms, alphabet
    )
    ps = np.arange(card + 2, dtype=np.uint64) * np.uint64(base // 2) + np.uint64(
        1
    )
    ps_hi, ps_lo = r64.split_u64_host(ps)
    return (
        r64.DeviceIndex64(
            packed=jnp.asarray(packed),
            prefix_hi=jnp.asarray(ps_hi),
            prefix_lo=jnp.asarray(ps_lo),
            seed_table=jnp.zeros((1, 4), dtype=jnp.uint32),
            sampled_sa=None,
            code_masks=None,
            vec_to_index=None,
            bwt_length=nb * 256,
            ratio=ratio,
            kmer_length_in_seed_table=3,
            alphabet=alphabet,
        ),
        ms,
        ps,
    )


@pytest.mark.parametrize(
    "sched",
    [
        {},
        {"AWFM_BT_SLACK": "0", "AWFM_BT_LEVEL_SEG": "1"},
        {"AWFM_BT_MIN_LEVEL": "64", "AWFM_BT_COMPACT": "nonzero"},
        {"AWFM_BT_MIN_LEVEL": "1000000"},  # no levels: pure while_loop
    ],
)
def test_wide_backtrace_schedules_match_narrow(rng, monkeypatch, sched):
    """The sync-free wide backtrace must walk exactly like the narrow
    one on the same index, under every compaction schedule (the
    zero-slack single-step setting forces truncation at every level,
    exercising the wide exactness net)."""
    from avxwindowfmindex_tpu import search as search_mod

    seq = random_sequence(rng, 4000, AlphabetType.DNA)
    index = create_index(seq, _cfg(ratio=8))
    dev = index.to_device()
    dev64 = index.to_device(refresh=True, wide=True)
    positions = rng.integers(0, index.bwt_length, size=4096).astype(np.uint32)
    want_p, want_off = map(
        np.asarray,
        search_mod.backtrace_all(dev, jnp.asarray(positions)),
    )
    for k, v in sched.items():
        monkeypatch.setenv(k, v)
    got_hi, got_lo, got_off = map(
        np.asarray,
        search64.backtrace_all64(
            dev64,
            jnp.zeros(len(positions), dtype=jnp.uint32),
            jnp.asarray(positions),
        ),
    )
    assert not got_hi.any()
    np.testing.assert_array_equal(got_lo, want_p)
    np.testing.assert_array_equal(got_off, want_off)


def test_wsum_milestone64_identical(rng, monkeypatch):
    """AWFM_MS_WSUM=1 (weighted-byte-sum milestone halves) must match
    the bitcast one-hot path bit-for-bit on a table whose milestones
    straddle 2^32 — the case where a wrong lo/hi byte weight or a
    carry mistake would show."""
    nb = 16
    letters = rng.integers(0, 6, size=(nb, 256)).astype(np.uint8)
    dev, ms, ps = _synthetic_wide_dev(letters, 2**32 - 100)

    positions = rng.integers(0, nb * 256, size=512, dtype=np.uint64)
    letts = jnp.asarray(rng.integers(0, 5, size=512).astype(np.int32))
    p_hi, p_lo = r64.split_u64_host(positions)
    args = (dev, jnp.asarray(p_hi), jnp.asarray(p_lo), letts)

    monkeypatch.setenv("AWFM_MS_WSUM", "0")
    base_hi, base_lo = map(np.asarray, r64.occurrence64(*args))
    monkeypatch.setenv("AWFM_MS_WSUM", "1")
    got_hi, got_lo = map(np.asarray, r64.occurrence64(*args))
    np.testing.assert_array_equal(base_hi, got_hi)
    np.testing.assert_array_equal(base_lo, got_lo)


def test_carry_rank_straddles_2_32(rng):
    """occurrence64 with milestones just below/above 2^32 vs u64 oracle."""
    nb = 16
    letters = rng.integers(0, 6, size=(nb, 256)).astype(np.uint8)
    base = 2**32 - 100  # counts cross the boundary mid-table
    dev, ms, ps = _synthetic_wide_dev(letters, base)
    flat = letters.reshape(-1)

    positions = rng.integers(0, nb * 256, size=512, dtype=np.uint64)
    letts = rng.integers(0, 5, size=512).astype(np.int32)
    p_hi, p_lo = r64.split_u64_host(positions)
    occ_hi, occ_lo = r64.occurrence64(
        dev, jnp.asarray(p_hi), jnp.asarray(p_lo), jnp.asarray(letts)
    )
    got = (np.asarray(occ_hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        occ_lo
    ).astype(np.uint64)
    # oracle: milestone(block, letter) + inclusive in-block count
    blocks = positions // 256
    want = np.empty(512, dtype=np.uint64)
    for i, (p, l) in enumerate(zip(positions, letts)):
        b = int(p // 256)
        within = np.count_nonzero(
            flat[b * 256 : int(p) + 1] == l
        )
        want[i] = ms[b, l] + np.uint64(within)
    np.testing.assert_array_equal(got, want)

    # backward_step64 on ranges built from those occs: formula check
    s0 = rng.integers(1, 2**33, size=64, dtype=np.uint64)
    e0 = s0 + rng.integers(0, nb * 256 - 1, size=64, dtype=np.uint64)
    # clamp positions into the covered table so gathers stay real
    s0 = s0 % np.uint64(nb * 256 - 2) + np.uint64(1)
    e0 = np.minimum(s0 + (e0 % np.uint64(512)), np.uint64(nb * 256 - 1))
    lt = rng.integers(0, 4, size=64).astype(np.int32)
    sh, sl = r64.split_u64_host(s0)
    eh, el = r64.split_u64_host(e0)
    nsh, nsl, neh, nel = r64.backward_step64(
        dev,
        jnp.asarray(sh),
        jnp.asarray(sl),
        jnp.asarray(eh),
        jnp.asarray(el),
        jnp.asarray(lt),
    )

    def occ_oracle(p, l):
        b = int(p) // 256
        return ms[b, l] + np.uint64(
            np.count_nonzero(flat[b * 256 : int(p) + 1] == l)
        )

    for i in range(64):
        c = ps[lt[i]]
        want_s = c + occ_oracle(s0[i] - 1, lt[i])
        want_e = c + occ_oracle(e0[i], lt[i]) - np.uint64(1)
        got_s = (int(nsh[i]) << 32) | int(nsl[i])
        got_e = (int(neh[i]) << 32) | int(nel[i])
        assert got_s == int(want_s) and got_e == int(want_e), i


@pytest.mark.skipif(
    not os.environ.get("AWFM_BIG_TESTS"),
    reason="multi-GB straddle test; set AWFM_BIG_TESTS=1",
)
def test_true_straddle_rank(rng):
    """rank at positions above 2^32 on a genuinely > 2^32-position table."""
    pattern = rng.integers(0, 6, size=(4096, 256)).astype(np.uint8)
    reps = (2**32 // (4096 * 256)) + 2  # > 2^32 positions total
    nb = 4096 * reps
    card = 4
    counts = np.stack(
        [(pattern == j).sum(axis=1) for j in range(card + 2)], axis=1
    ).astype(np.uint64)
    pat_total = counts.sum(axis=0)
    # tile the letters; milestones accumulate across tiles
    tiled = np.tile(pattern, (reps, 1))
    cum = np.cumsum(np.tile(counts, (reps, 1)), axis=0)
    ms = np.zeros_like(cum)
    ms[1:] = cum[:-1]
    packed = r64.pack_device_blocks64(
        tiled.reshape(-1), ms, AlphabetType.DNA
    )
    ps = np.concatenate([[1], np.cumsum(pat_total * reps) + 1]).astype(
        np.uint64
    )
    ps_hi, ps_lo = r64.split_u64_host(ps[:6])
    dev = r64.DeviceIndex64(
        packed=jnp.asarray(packed),
        prefix_hi=jnp.asarray(ps_hi),
        prefix_lo=jnp.asarray(ps_lo),
        seed_table=jnp.zeros((1, 4), dtype=jnp.uint32),
        sampled_sa=None,
        code_masks=None,
        vec_to_index=None,
        bwt_length=nb * 256,
        ratio=8,
        kmer_length_in_seed_table=3,
        alphabet=AlphabetType.DNA,
    )
    boundary = 2**32
    positions = np.concatenate(
        [
            rng.integers(boundary - 5000, boundary + 5000, 128),
            rng.integers(0, nb * 256, 128),
        ]
    ).astype(np.uint64)
    letts = rng.integers(0, 5, size=256).astype(np.int32)
    p_hi, p_lo = r64.split_u64_host(positions)
    occ_hi, occ_lo = r64.occurrence64(
        dev, jnp.asarray(p_hi), jnp.asarray(p_lo), jnp.asarray(letts)
    )
    got = (np.asarray(occ_hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
        occ_lo
    ).astype(np.uint64)
    flat_pat = pattern.reshape(-1)
    pat_len = flat_pat.shape[0]
    pat_cum = {
        l: np.concatenate([[0], np.cumsum(flat_pat == l)]) for l in range(5)
    }
    for i, (p, l) in enumerate(zip(positions, letts)):
        full, rem = divmod(int(p) + 1, pat_len)
        want = full * int(pat_cum[int(l)][-1]) + int(pat_cum[int(l)][rem])
        assert int(got[i]) == want, (i, p, l)


def test_pair_step_matches_classic_and_flags(rng):
    """backward_step64_pair == backward_step64 for in-window ranges;
    ranges wider than the 512-position pair window are flagged."""
    nb = 16
    letters = rng.integers(0, 6, size=(nb, 256)).astype(np.uint8)
    dev, ms, ps = _synthetic_wide_dev(letters, base=2**32 - 100)

    s0 = (rng.integers(1, nb * 256 - 600, size=256, dtype=np.uint64))
    width = rng.integers(0, 500, size=256, dtype=np.uint64)
    e0 = s0 + width  # always within the pair window of s0-1
    lt = rng.integers(0, 4, size=256).astype(np.int32)
    sh, sl = map(jnp.asarray, r64.split_u64_host(s0))
    eh, el = map(jnp.asarray, r64.split_u64_host(e0))
    bad = jnp.zeros(256, dtype=bool)
    psh, psl, peh, pel, bad = r64.backward_step64_pair(
        dev, sh, sl, eh, el, jnp.asarray(lt), bad
    )
    csh, csl, ceh, cel = r64.backward_step64(
        dev, sh, sl, eh, el, jnp.asarray(lt)
    )
    # in-window rows must agree exactly with the two-gather step
    ok = ~np.asarray(bad)
    assert ok.sum() > 200  # the construction keeps nearly all in-window
    for got, want in ((psh, csh), (psl, csl), (peh, ceh), (pel, cel)):
        np.testing.assert_array_equal(np.asarray(got)[ok], np.asarray(want)[ok])

    # genuinely wide valid ranges must be flagged
    s1 = np.full(8, 257, dtype=np.uint64)
    e1 = s1 + np.uint64(600)  # spans past block b+1
    sh1, sl1 = map(jnp.asarray, r64.split_u64_host(s1))
    eh1, el1 = map(jnp.asarray, r64.split_u64_host(e1))
    *_, bad1 = r64.backward_step64_pair(
        dev, sh1, sl1, eh1, el1,
        jnp.asarray(np.zeros(8, np.int32)), jnp.zeros(8, dtype=bool),
    )
    assert bool(np.asarray(bad1).all())


def test_wide_steploop_pair_matches_narrow(rng, monkeypatch):
    """The accelerator path (step loop + pair rows + fixup) on the
    wide layout must equal the 32-bit engine, including on a repeat-rich
    corpus whose seeded ranges stay wider than the pair window (forcing
    the flagged re-run)."""
    from avxwindowfmindex_tpu.utils import metrics

    monkeypatch.setattr(search64, "_use_step_loop", lambda: True)
    flagged_before = metrics.snapshot().get("search64.pair_fixup.flagged", 0)
    for seq_bytes in (
        random_sequence(rng, 4000, AlphabetType.DNA),
        # low-complexity: 2-letter alphabet keeps post-seed ranges wide
        bytes(rng.choice(np.frombuffer(b"AC", np.uint8), size=4000)),
    ):
        index = create_index(seq_bytes, _cfg(k=3))
        narrow = SearchEngine(index)
        wide = SearchEngine(index.to_device(refresh=True, wide=True))
        wide.host_index = index
        kmers = [
            random_kmer(rng, int(rng.integers(3, 12)), AlphabetType.DNA)
            for _ in range(128)
        ] + [b"ACACACAC", b"AAAA", b"CCCCCC"]
        np.testing.assert_array_equal(wide.count(kmers), narrow.count(kmers))
        got = wide.locate(kmers)
        want = narrow.locate(kmers)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        index._device_cache = None
    # the low-complexity corpus must actually exercise the flagged
    # re-run path (wide post-seed ranges overflow the pair window)
    assert metrics.snapshot().get(
        "search64.pair_fixup.flagged", 0
    ) > flagged_before


def test_wide_seed_table_widened_and_chunked_bfs_agree(rng):
    """The three ways to produce the wide seed table — widening the
    32-bit device table, the device BFS, and the memory-bounded chunked
    BFS — must be identical."""
    from avxwindowfmindex_tpu.search64 import build_seed_table_device64

    seq = random_sequence(rng, 3000, AlphabetType.DNA)
    index = create_index(seq, _cfg(k=4))
    index.to_device()  # narrow cache; enables the widening shortcut
    wide_dev = index.to_device(refresh=True, wide=True)
    bfs = build_seed_table_device64(wide_dev, 4, 4, index.prefix_sums)
    bfs_chunked = build_seed_table_device64(
        wide_dev, 4, 4, index.prefix_sums, chunk=64
    )
    np.testing.assert_array_equal(np.asarray(wide_dev.seed_table), np.asarray(bfs))
    np.testing.assert_array_equal(np.asarray(bfs), np.asarray(bfs_chunked))
    index._device_cache = None


def test_wide_compact_layout_opt_out(rng, monkeypatch):
    """AWFM_PAIR_ROWS=0 keeps the compact single-block wide layout
    (amino rows back to 384 B) and the classic two-gather step, with
    identical results."""
    monkeypatch.setenv("AWFM_PAIR_ROWS", "0")
    seq = random_sequence(rng, 3000, AlphabetType.AMINO)
    index = create_index(seq, _cfg(AlphabetType.AMINO))
    narrow = SearchEngine(index)
    dev = index.to_device(refresh=True, wide=True)
    assert not dev.pair_fused
    assert dev.packed.shape[1] == 384  # 5*32 planes + 21*8 milestones
    wide = SearchEngine(dev)
    wide.host_index = index
    kmers = [
        random_kmer(rng, int(rng.integers(2, 10)), AlphabetType.AMINO)
        for _ in range(100)
    ]
    np.testing.assert_array_equal(wide.count(kmers), narrow.count(kmers))
    got = wide.locate(kmers[:30])
    want = narrow.locate(kmers[:30])
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    index._device_cache = None


def test_pair_step_overflow_flag_u64_oracle(rng):
    """The pair-window overflow flag must equal the u64 oracle
    e - ((s-1) & ~0xFF) >= 512 for arbitrary 64-bit ranges, including
    windows that straddle a 2^32 boundary (where the hi-word borrow
    logic is the only thing deciding the flag)."""
    letters = rng.integers(0, 6, size=(4, 256)).astype(np.uint8)
    dev, _, _ = _synthetic_wide_dev(letters, base=0)
    s = rng.integers(1, 2**63, size=1024, dtype=np.uint64)
    # half narrow widths, half huge; plus adversarial near-2^32 windows
    width = np.where(
        rng.random(1024) < 0.5,
        rng.integers(0, 1000, size=1024, dtype=np.uint64),
        rng.integers(0, 2**40, size=1024, dtype=np.uint64),
    )
    s[:64] = np.uint64(2**32) - rng.integers(1, 300, size=64, dtype=np.uint64)
    width[:64] = rng.integers(0, 600, size=64, dtype=np.uint64)
    e = s + width
    want = (e - ((s - np.uint64(1)) & ~np.uint64(0xFF))) >= np.uint64(512)
    sh, sl = map(jnp.asarray, r64.split_u64_host(s))
    eh, el = map(jnp.asarray, r64.split_u64_host(e))
    lt = jnp.zeros(1024, dtype=jnp.int32)
    *_, bad = r64.backward_step64_pair(
        dev, sh, sl, eh, el, lt, jnp.zeros(1024, dtype=bool)
    )
    np.testing.assert_array_equal(np.asarray(bad), want)


def test_narrow_rebuild_after_wide_cache(rng):
    """Rebuilding the narrow device view while a WIDE cache is installed
    must not reuse the (A^k, 4) wide seed table as the (A^k, 2) narrow
    one (it silently zeroed every seeded count before the fix)."""
    seq = random_sequence(rng, 3000, AlphabetType.DNA)
    index = create_index(seq, _cfg(k=3))
    kmers = [
        random_kmer(rng, int(rng.integers(3, 9)), AlphabetType.DNA)
        for _ in range(64)
    ]
    want = SearchEngine(index).count(kmers)
    assert want.sum() > 0
    index.to_device(refresh=True, wide=True)  # installs the wide cache
    got = SearchEngine(index).count(kmers)  # narrow rebuild from wide cache
    np.testing.assert_array_equal(got, want)
    index._device_cache = None


def test_create_index_wide_route(rng, monkeypatch):
    """create_index must not run the 32-bit seed-table builder on a wide
    DeviceIndex64 (it would crash on the missing prefix_sums field and
    clobber the hi/lo table _to_device_wide already built)."""
    from avxwindowfmindex_tpu.models.index import FmIndex

    orig = FmIndex.to_device
    monkeypatch.setattr(
        FmIndex,
        "to_device",
        lambda self, refresh=False, wide=None: orig(
            self, refresh=refresh, wide=True
        ),
    )
    seq = random_sequence(rng, 3000, AlphabetType.DNA)
    index = create_index(seq, _cfg())  # crashed before the route fix
    st = index.seed_table_host()
    assert st.shape == (alpha.cardinality(AlphabetType.DNA) ** 3, 2)
    eng = SearchEngine(index)
    assert eng.wide
    monkeypatch.undo()
    narrow = SearchEngine(create_index(seq, _cfg()))
    kmers = [random_kmer(rng, int(rng.integers(2, 10)), AlphabetType.DNA)
             for _ in range(80)]
    np.testing.assert_array_equal(eng.count(kmers), narrow.count(kmers))


def test_wide_rna_rows_stay_pair_fused(rng, monkeypatch):
    """Nucleotide pair rows are free (256 B either way): RNA must fuse
    even under AWFM_PAIR_ROWS=0, like DNA; only amino honors the opt-out."""
    monkeypatch.setenv("AWFM_PAIR_ROWS", "0")
    seq = random_sequence(rng, 2000, AlphabetType.RNA)
    index = create_index(seq, _cfg(AlphabetType.RNA))
    dev = index.to_device(refresh=True, wide=True)
    assert dev.pair_fused
    index._device_cache = None


def test_seed_table_host_rejects_placeholder(rng):
    """to_device()'s zeros placeholder must never serialize as a real
    seed table."""
    seq = random_sequence(rng, 2000, AlphabetType.DNA)
    index = create_index(seq, _cfg())
    index.kmer_seed_table = None
    index._device_cache = None
    index.to_device()  # installs the (1, 2) placeholder
    with pytest.raises(ValueError, match="no seed table"):
        index.seed_table_host()
    index._device_cache = None


def test_wide_dense_device_sa_build_time(rng):
    """create_index(device_sa_ratio=r) must reach the wide layout too:
    the hi/lo device view installs the denser SA + ratio, and locate
    stays bit-identical to the narrow engine (the reference's
    memory-for-speed trade has no scale cutoff, README.md:207-213)."""
    seq = random_sequence(rng, 4000, AlphabetType.DNA)
    index = create_index(seq, _cfg(ratio=8), device_sa_ratio=2)
    plain = create_index(seq, _cfg(ratio=8))
    dev = index.to_device(refresh=True, wide=True)
    assert dev.ratio == 2
    assert dev.sampled_sa.shape[0] == (index.bwt_length + 1) // 2
    wide = SearchEngine(dev)
    wide.host_index = index
    narrow = SearchEngine(plain)
    kmers = [
        random_kmer(rng, int(rng.integers(2, 12)), AlphabetType.DNA)
        for _ in range(128)
    ]
    got = wide.locate(kmers)
    want = narrow.locate(kmers)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    index._device_cache = None


def test_wide_densify_device_sa_matches_build_time(rng):
    """densify_device_sa on the wide layout == build-time dense upload,
    bit for bit, and locate answers are unchanged."""
    seq = random_sequence(rng, 4000, AlphabetType.DNA)
    built = create_index(seq, _cfg(ratio=8), device_sa_ratio=2)
    built_dev = built.to_device(refresh=True, wide=True)

    index = create_index(seq, _cfg(ratio=8))
    index.to_device(refresh=True, wide=True)  # install wide cache
    dense = index.densify_device_sa(2, chunk=1024)  # auto-detects wide
    assert type(dense).__name__ == "DeviceIndex64"
    assert dense.ratio == 2
    assert index.device_sa_ratio == 2
    np.testing.assert_array_equal(
        np.asarray(dense.sampled_sa), np.asarray(built_dev.sampled_sa)
    )
    wide = SearchEngine(dense)
    wide.host_index = index
    narrow = SearchEngine(create_index(seq, _cfg(ratio=8)))
    kmers = [
        random_kmer(rng, int(rng.integers(2, 12)), AlphabetType.DNA)
        for _ in range(128)
    ]
    got = wide.locate(kmers)
    want = narrow.locate(kmers)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    built._device_cache = None
    index._device_cache = None


def test_mul_small64_oracle(rng):
    """rank64.mul_small64 vs a NumPy uint64 oracle across the u32 range."""
    import jax

    i_np = np.concatenate(
        [
            rng.integers(0, 2**32, size=256, dtype=np.uint64).astype(
                np.uint32
            ),
            np.array([0, 1, 0xFFFF, 0x10000, 0xFFFFFFFF], dtype=np.uint32),
        ]
    )
    for r in (1, 2, 7, 8, 255, 65535):
        hi, lo = jax.jit(lambda i: r64.mul_small64(i, r))(jnp.asarray(i_np))
        want = i_np.astype(np.uint64) * np.uint64(r)
        got = (np.asarray(hi).astype(np.uint64) << np.uint64(32)) | np.asarray(
            lo
        ).astype(np.uint64)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="mul_small64"):
        r64.mul_small64(jnp.uint32(1), 1 << 16)
