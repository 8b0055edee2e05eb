"""Locate (backtrace + SA resolve) tests.

Models: test/backtraceTest/backtraceTest.c and
test/parallelSearch/parallelSearchTest.c — every located position set is
verified against the naive scan oracle, for both alphabets, multiple
compression ratios, and the on-disk suffix-array path.
"""

import numpy as np
import pytest

from avxwindowfmindex_tpu import (
    AlphabetType,
    IndexConfiguration,
    SearchEngine,
    create_index,
)

from oracle import match_positions, random_kmer, random_sequence


def _cfg(alphabet, k=3, ratio=4):
    return IndexConfiguration(
        suffix_array_compression_ratio=ratio,
        kmer_length_in_seed_table=k,
        alphabet_type=alphabet,
    )


@pytest.mark.parametrize("alphabet", [AlphabetType.DNA, AlphabetType.AMINO])
@pytest.mark.parametrize("ratio", [1, 3, 8])
def test_locate_vs_bruteforce(rng, alphabet, ratio):
    for _ in range(3):
        n = int(rng.integers(60, 1200))
        seq = random_sequence(rng, n, alphabet)
        index = create_index(seq, _cfg(alphabet, ratio=ratio))
        engine = SearchEngine(index)
        kmers = [
            random_kmer(rng, int(rng.integers(1, 9)), alphabet)
            for _ in range(60)
        ]
        all_hits = engine.locate(kmers)
        for kmer, hits in zip(kmers, all_hits):
            want = match_positions(seq, kmer, alphabet)
            got = np.sort(hits.astype(np.int64))
            np.testing.assert_array_equal(got, want, err_msg=repr(kmer))


def test_locate_every_position_single_letter(rng):
    # a single-letter kmer hits a large fraction of positions; exercises
    # long backtrace chains and the sentinel wrap (AwFmSearch.c:237-241)
    seq = b"AAAAAAAAAACAAAAAAAGAAAAT" * 8
    index = create_index(seq, _cfg(AlphabetType.DNA, ratio=8))
    engine = SearchEngine(index)
    hits = engine.locate([b"A"])[0]
    want = match_positions(seq, b"A", AlphabetType.DNA)
    np.testing.assert_array_equal(np.sort(hits.astype(np.int64)), want)


def test_locate_order_is_range_order(rng):
    # positionList order = BWT range order (AwFmParallelSearch.c:333-362)
    seq = random_sequence(rng, 400, AlphabetType.DNA)
    index = create_index(seq, _cfg(AlphabetType.DNA))
    engine = SearchEngine(index)
    ranges = engine.find_ranges([b"AC"])
    s, e = int(ranges[0, 0]), int(ranges[0, 1])
    if s <= e:
        hits = engine.locate([b"AC"])[0]
        singles = [
            engine.resolve_positions(np.array([p], dtype=np.uint64))[0]
            for p in range(s, e + 1)
        ]
        np.testing.assert_array_equal(hits, np.array(singles, dtype=np.uint64))


def test_locate_empty_result(rng):
    seq = b"ACGTACGTACGT"
    index = create_index(seq, _cfg(AlphabetType.DNA, k=2))
    engine = SearchEngine(index)
    hits = engine.locate([b"TTT"])
    assert len(hits) == 1 and len(hits[0]) == 0


@pytest.mark.parametrize("steploop", [False, True])
def test_locate_flat_device_matches_host(rng, monkeypatch, steploop):
    # device-side enumerate+backtrace+resolve == host locate (content,
    # order, and query grouping), including invalid ranges and padding
    import jax.numpy as jnp

    import avxwindowfmindex_tpu.search as search_mod

    if steploop:
        monkeypatch.setattr(search_mod, "_use_step_loop", lambda: True)
    seq = random_sequence(rng, 700, AlphabetType.DNA)
    index = create_index(seq, _cfg(AlphabetType.DNA, ratio=8))
    engine = SearchEngine(index)
    kmers = [random_kmer(rng, int(rng.integers(1, 5)), AlphabetType.DNA) for _ in range(40)]
    kmers.append(b"TTTTTTTTTTTT")  # a (probably) absent kmer: invalid range
    want_lists = engine.locate(kmers)
    ranges = engine.find_ranges(kmers)
    s = jnp.asarray(ranges[:, 0].astype(np.uint32))
    e = jnp.asarray(ranges[:, 1].astype(np.uint32))
    total = search_mod.total_hits_host(s, e)
    assert total == sum(len(w) for w in want_lists)
    cap = search_mod._round_up_pow2(total, floor=64)
    hits, qid, mask = search_mod.locate_flat_device(engine.dev, s, e, capacity=cap)
    hits, qid, mask = np.asarray(hits), np.asarray(qid), np.asarray(mask)
    assert mask.sum() == total
    for q, want in enumerate(want_lists):
        got = hits[mask & (qid == q)]
        np.testing.assert_array_equal(got.astype(np.uint64), want)


def test_steploop_backtrace_fused_matches(rng, monkeypatch):
    import avxwindowfmindex_tpu.search as search_mod

    monkeypatch.setattr(search_mod, "_use_step_loop", lambda: True)
    monkeypatch.setenv("AWFM_FUSE_STEPS", "4")
    seq = random_sequence(rng, 900, AlphabetType.DNA)
    index = create_index(seq, _cfg(AlphabetType.DNA, ratio=8))
    engine = SearchEngine(index)
    kmers = [random_kmer(rng, 5, AlphabetType.DNA) for _ in range(30)]
    hits = engine.locate(kmers)
    for kmer, h in zip(kmers, hits):
        want = match_positions(seq, kmer, AlphabetType.DNA)
        np.testing.assert_array_equal(np.sort(h.astype(np.int64)), want)


@pytest.mark.parametrize("use_bt", [False, True])
def test_backtrace_truncation_net(rng, use_bt):
    """Correlated stragglers can exceed a compaction level's statistical
    size (duplicated positions walk in lock-step); the final full-batch
    while_loop net must finish the truncated remainder exactly."""
    import jax.numpy as jnp

    import avxwindowfmindex_tpu.search as search_mod
    from avxwindowfmindex_tpu.ops import bt_digram

    seq = random_sequence(rng, 3000, AlphabetType.DNA)
    index = create_index(seq, _cfg(AlphabetType.DNA, ratio=8))
    dev = index.to_device()
    bt = bt_digram.build_backtrace_digram_device(index) if use_bt else None
    # find a position whose chain outlives the first ratio-step pass
    all_p = jnp.arange(index.bwt_length, dtype=jnp.uint32)
    _, offs = search_mod.backtrace_all(dev, all_p)
    deep = int(np.asarray(jnp.argmax(offs)))
    assert int(np.asarray(offs[deep])) > 8
    want_p, want_off = search_mod.backtrace_all(
        dev, jnp.full((16,), np.uint32(deep))
    )
    b = 16384  # big enough for one compaction level (m=7424 < undone)
    p, off = search_mod.backtrace_all(dev, jnp.full((b,), np.uint32(deep)), bt)
    assert (np.asarray(p) == int(np.asarray(want_p[0]))).all()
    assert (np.asarray(off) == int(np.asarray(want_off[0]))).all()


@pytest.mark.parametrize(
    "sched",
    [
        {"AWFM_BT_SLACK": "0", "AWFM_BT_LEVEL_SEG": "1"},
        {"AWFM_BT_FIRST_SEG": "1", "AWFM_BT_SLACK": "2"},
        {"AWFM_BT_LEVEL_SEG": "32", "AWFM_BT_COMPACT": "nonzero"},
        {"AWFM_BT_MIN_LEVEL": "64", "AWFM_BT_COMPACT": "cumsum"},
        {"AWFM_BT_MIN_LEVEL": "1000000"},  # no levels: pure while_loop
    ],
)
def test_backtrace_schedule_knobs_exact(rng, monkeypatch, sched):
    """EVERY compaction schedule must produce the exact (p, off) walk —
    zero-slack and single-step levels force statistical truncation at
    every level, exercising the exactness net hard."""
    import jax.numpy as jnp

    import avxwindowfmindex_tpu.search as search_mod

    seq = random_sequence(rng, 4000, AlphabetType.DNA)
    index = create_index(seq, _cfg(AlphabetType.DNA, ratio=8))
    dev = index.to_device()
    positions = jnp.asarray(
        rng.integers(0, index.bwt_length, size=8192).astype(np.uint32)
    )
    want_p, want_off = map(
        np.asarray, search_mod.backtrace_all(dev, positions)
    )
    for k, v in sched.items():
        monkeypatch.setenv(k, v)
    got_p, got_off = map(np.asarray, search_mod.backtrace_all(dev, positions))
    np.testing.assert_array_equal(got_p, want_p)
    np.testing.assert_array_equal(got_off, want_off)


def test_enumerate_formulations_identical(rng, monkeypatch):
    """The scatter-marks enumerate (AWFM_ENUM_SCATTER=1) must equal the
    repeat form bit-for-bit, including zero-count queries stacked at
    shared segment starts, invalid ranges, and the padded tail."""
    import jax.numpy as jnp

    from avxwindowfmindex_tpu.search import enumerate_range_positions

    b = 512
    start = rng.integers(0, 10_000, size=b).astype(np.uint32)
    width = rng.integers(0, 12, size=b).astype(np.uint32)
    width[rng.random(b) < 0.4] = 0  # many single/empty
    end = start + width - np.uint32(rng.random(b) < 0.3)  # some invalid
    cap = int(((start <= end) * (end - start + 1)).sum() + 64)

    args = (jnp.asarray(start), jnp.asarray(end))
    monkeypatch.setenv("AWFM_ENUM", "repeat")
    base = [np.asarray(x) for x in
            enumerate_range_positions(*args, capacity=cap)]
    monkeypatch.setenv("AWFM_ENUM", "scatter")
    got = [np.asarray(x) for x in
           enumerate_range_positions(*args, capacity=cap)]
    for a, g in zip(base, got):
        np.testing.assert_array_equal(a, g)
    # the delta default (r5): one gather instead of three, same bits —
    # including delta's u32 wrap when seg_off > start
    monkeypatch.delenv("AWFM_ENUM", raising=False)
    monkeypatch.setenv("AWFM_ENUM_SCATTER", "0")
    got = [np.asarray(x) for x in
           enumerate_range_positions(*args, capacity=cap)]
    for a, g in zip(base, got):
        np.testing.assert_array_equal(a, g)
    # tiny-capacity truncation must also agree across forms
    small = max(8, cap // 3)
    monkeypatch.setenv("AWFM_ENUM", "repeat")
    base = [np.asarray(x) for x in
            enumerate_range_positions(*args, capacity=small)]
    monkeypatch.delenv("AWFM_ENUM", raising=False)
    got = [np.asarray(x) for x in
           enumerate_range_positions(*args, capacity=small)]
    for a, g in zip(base, got):
        np.testing.assert_array_equal(a, g)


def test_total_hits_exact_past_2_32(rng):
    """total_hits_host must not wrap at 2^32 total hits (u32 cumsum
    wrap-count formulation)."""
    import jax.numpy as jnp
    from avxwindowfmindex_tpu import search as search_mod

    start = jnp.asarray(np.ones(64, dtype=np.uint32))
    width = rng.integers(0, 2**31, size=64, dtype=np.uint64)
    end_np = (1 + width).astype(np.uint32)
    end = jnp.asarray(end_np)
    want = int(np.sum(end_np.astype(np.uint64)))  # sum of (end - 1 + 1)
    assert want > 2**32  # the test must actually cross the boundary
    got = search_mod.total_hits_host(start, end)
    assert got == want, (got, want)


def test_dense_device_sa_parity(rng, tmp_path):
    """create_index(device_sa_ratio=r) must change ONLY the device-side
    SA density: identical count/locate answers, dev.ratio == r, and a
    byte-identical .awfmi (the file keeps the config ratio)."""
    seq = random_sequence(rng, 3000, AlphabetType.DNA)
    cfg = _cfg(AlphabetType.DNA, ratio=8)
    plain_file = tmp_path / "plain.awfmi"
    dense_file = tmp_path / "dense.awfmi"
    plain = create_index(seq, cfg, file_src=str(plain_file))
    dense = create_index(
        seq, cfg, file_src=str(dense_file), device_sa_ratio=2
    )
    assert plain_file.read_bytes() == dense_file.read_bytes()

    dev = dense.to_device()
    assert dev.ratio == 2
    assert dev.sampled_sa.shape[0] == (dense.bwt_length + 1) // 2
    assert plain.to_device().ratio == 8

    e_plain = SearchEngine(plain)
    e_dense = SearchEngine(dense)
    kmers = [random_kmer(rng, int(rng.integers(2, 9)), AlphabetType.DNA)
             for _ in range(80)]
    np.testing.assert_array_equal(e_dense.count(kmers), e_plain.count(kmers))
    for km, a, b in zip(kmers, e_dense.locate(kmers), e_plain.locate(kmers)):
        np.testing.assert_array_equal(a, b, err_msg=repr(km))
    # a ratio-1 device SA degenerates the backtrace to zero LF steps
    instant = create_index(seq, cfg, device_sa_ratio=1)
    assert instant.to_device().ratio == 1
    e_instant = SearchEngine(instant)
    for km, a, b in zip(kmers, e_instant.locate(kmers), e_plain.locate(kmers)):
        np.testing.assert_array_equal(a, b, err_msg=repr(km))


def test_densify_on_load_matches_build_time_dense(rng, tmp_path):
    """densify_device_sa(r) on a FILE-LOADED index must produce the
    exact device SA a build-time device_sa_ratio=r cut from the full
    suffix array, and identical locate answers (reference analogue: the build-time-only in-memory-SA trade,
    /root/reference/README.md:207-213)."""
    from avxwindowfmindex_tpu import read_index_from_file

    seq = random_sequence(rng, 3000, AlphabetType.DNA)
    cfg = _cfg(AlphabetType.DNA, ratio=8)
    path = tmp_path / "d.awfmi"
    built_dense = create_index(seq, cfg, file_src=str(path),
                               device_sa_ratio=2)
    want_sa = np.asarray(built_dense.to_device().sampled_sa)

    loaded = read_index_from_file(str(path))
    assert loaded.to_device().ratio == 8
    dense_dev = loaded.densify_device_sa(2, chunk=512)  # force chunking
    assert dense_dev.ratio == 2
    np.testing.assert_array_equal(
        np.asarray(dense_dev.sampled_sa), want_sa
    )
    # the device cache is refreshed: engines built afterwards see it
    assert loaded.to_device() is dense_dev
    e_dense = SearchEngine(loaded)
    e_plain = SearchEngine(create_index(seq, cfg))
    kmers = [random_kmer(rng, int(rng.integers(2, 9)), AlphabetType.DNA)
             for _ in range(60)]
    np.testing.assert_array_equal(e_dense.count(kmers), e_plain.count(kmers))
    for km, a, b in zip(kmers, e_dense.locate(kmers), e_plain.locate(kmers)):
        np.testing.assert_array_equal(a, b, err_msg=repr(km))


def test_densify_on_load_ratios_and_validation(rng, tmp_path):
    from avxwindowfmindex_tpu import read_index_from_file

    seq = random_sequence(rng, 1500, AlphabetType.DNA)
    cfg = _cfg(AlphabetType.DNA, ratio=8)
    path = tmp_path / "v.awfmi"
    create_index(seq, cfg, file_src=str(path))

    # ratio 1: the device SA becomes the full SA (zero-step backtrace)
    loaded = read_index_from_file(str(path))
    full = loaded.densify_device_sa(1)
    want = create_index(seq, cfg, device_sa_ratio=1)
    np.testing.assert_array_equal(
        np.asarray(full.sampled_sa),
        np.asarray(want.to_device().sampled_sa),
    )
    # ratio 3 (not dividing 8) is exact too
    loaded3 = read_index_from_file(str(path))
    d3 = loaded3.densify_device_sa(3)
    w3 = create_index(seq, cfg, device_sa_ratio=3)
    np.testing.assert_array_equal(
        np.asarray(d3.sampled_sa), np.asarray(w3.to_device().sampled_sa)
    )
    # same ratio: no-op returning the existing device view
    loaded8 = read_index_from_file(str(path))
    dev8 = loaded8.to_device()
    assert loaded8.densify_device_sa(8) is dev8
    with pytest.raises(ValueError, match="ratio"):
        loaded8.densify_device_sa(0)
    # SA on disk cannot seed the pass
    nosa = read_index_from_file(str(path), keep_suffix_array_in_memory=False)
    with pytest.raises(ValueError, match="sampled suffix array"):
        nosa.densify_device_sa(2)


def test_dense_device_sa_env_and_validation(rng, monkeypatch):
    seq = random_sequence(rng, 500, AlphabetType.DNA)
    cfg = _cfg(AlphabetType.DNA, ratio=4)
    monkeypatch.setenv("AWFM_DEVICE_SA_RATIO", "2")
    idx = create_index(seq, cfg)
    assert idx.device_sa_ratio == 2 and idx.to_device().ratio == 2
    monkeypatch.delenv("AWFM_DEVICE_SA_RATIO")
    # >= config ratio: silently ignored (nothing to gain)
    idx2 = create_index(seq, cfg, device_sa_ratio=8)
    assert idx2.device_sa is None and idx2.to_device().ratio == 4
    with pytest.raises(ValueError):
        create_index(seq, cfg, device_sa_ratio=0)


def test_enumerate_delta_edges(rng):
    """Delta-enumerate edge cases: all-invalid batch, capacity == total,
    single query, leading zero-count queries, and a capacity-1 floor."""
    import jax.numpy as jnp

    from avxwindowfmindex_tpu.search import enumerate_range_positions

    # all ranges invalid: total 0, every slot masked off
    s = jnp.asarray(np.array([5, 9, 2], dtype=np.uint32))
    e = jnp.asarray(np.array([4, 8, 1], dtype=np.uint32))
    pos, qid, mask = enumerate_range_positions(s, e, capacity=8)
    assert not np.asarray(mask).any()
    assert (np.asarray(pos) == 0).all() and (np.asarray(qid) == 0).all()

    # exact-capacity fit (no pad slots at all)
    s = jnp.asarray(np.array([10, 0, 7], dtype=np.uint32))
    e = jnp.asarray(np.array([11, 0, 9], dtype=np.uint32))
    pos, qid, mask = enumerate_range_positions(s, e, capacity=6)
    np.testing.assert_array_equal(
        np.asarray(pos), [10, 11, 0, 7, 8, 9]
    )
    np.testing.assert_array_equal(np.asarray(qid), [0, 0, 1, 2, 2, 2])
    assert np.asarray(mask).all()

    # leading zero-count queries stack on the first live query's start
    s = jnp.asarray(np.array([3, 3, 100], dtype=np.uint32))
    e = jnp.asarray(np.array([2, 2, 101], dtype=np.uint32))
    pos, qid, mask = enumerate_range_positions(s, e, capacity=4)
    np.testing.assert_array_equal(np.asarray(pos)[:2], [100, 101])
    np.testing.assert_array_equal(np.asarray(qid)[:2], [2, 2])
    np.testing.assert_array_equal(np.asarray(mask), [True, True, False, False])

    # single query, capacity 1
    s = jnp.asarray(np.array([42], dtype=np.uint32))
    e = jnp.asarray(np.array([42], dtype=np.uint32))
    pos, qid, mask = enumerate_range_positions(s, e, capacity=1)
    assert np.asarray(pos)[0] == 42 and np.asarray(mask)[0]


def test_enumerate_delta_empty_batch():
    """b=0 must not gather from an empty delta operand."""
    import jax.numpy as jnp

    from avxwindowfmindex_tpu.search import enumerate_range_positions

    s = jnp.zeros(0, dtype=jnp.uint32)
    pos, qid, mask = enumerate_range_positions(s, s, capacity=4)
    assert pos.shape == (4,) and not np.asarray(mask).any()
