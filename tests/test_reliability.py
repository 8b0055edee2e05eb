"""Failure-handling tests: deterministic shard retry + index reload."""

import numpy as np
import pytest

from avxwindowfmindex_tpu import (
    AlphabetType,
    IndexConfiguration,
    SearchEngine,
    create_index,
)
from avxwindowfmindex_tpu.parallel.reliability import (
    ReliableSearchEngine,
    RetryPolicy,
)

from oracle import random_kmer, random_sequence


class FlakyEngine(SearchEngine):
    """Fails the first N calls, then behaves normally."""

    failures_remaining = 0

    def count(self, kmers):
        if FlakyEngine.failures_remaining > 0:
            FlakyEngine.failures_remaining -= 1
            raise RuntimeError("injected fault")
        return super().count(kmers)

    def locate(self, kmers):
        if FlakyEngine.failures_remaining > 0:
            FlakyEngine.failures_remaining -= 1
            raise RuntimeError("injected fault")
        return super().locate(kmers)


@pytest.fixture(autouse=True)
def _reset_flaky_state():
    FlakyEngine.failures_remaining = 0
    yield
    FlakyEngine.failures_remaining = 0


@pytest.fixture
def built(rng, tmp_path):
    seq = random_sequence(rng, 1200, AlphabetType.DNA)
    cfg = IndexConfiguration(4, 3, AlphabetType.DNA)
    path = str(tmp_path / "r.awfmi")
    return seq, create_index(seq, cfg, file_src=path)


def test_retry_recovers_and_matches(built, rng):
    seq, index = built
    kmers = [random_kmer(rng, 5, AlphabetType.DNA) for _ in range(300)]
    want = SearchEngine(index).count(kmers)

    FlakyEngine.failures_remaining = 2
    eng = ReliableSearchEngine(
        index, shard_size=100,
        policy=RetryPolicy(max_attempts=3, backoff_seconds=0.0),
        engine_factory=FlakyEngine,
    )
    got = eng.count(kmers)
    np.testing.assert_array_equal(got, want)
    assert eng.stats["retries"] == 2
    assert eng.stats["reloads"] == 2  # reload path exercised


def test_retry_exhaustion_raises(built, rng):
    seq, index = built
    FlakyEngine.failures_remaining = 99
    eng = ReliableSearchEngine(
        index, shard_size=100,
        policy=RetryPolicy(max_attempts=2, backoff_seconds=0.0,
                           reload_index_on_failure=False),
        engine_factory=FlakyEngine,
    )
    with pytest.raises(RuntimeError, match="injected fault"):
        eng.count([b"ACGT"] * 10)


def test_locate_through_retry(built, rng):
    seq, index = built
    kmers = [random_kmer(rng, 4, AlphabetType.DNA) for _ in range(50)]
    want = SearchEngine(index).locate(kmers)
    FlakyEngine.failures_remaining = 1
    eng = ReliableSearchEngine(
        index, shard_size=25,
        policy=RetryPolicy(max_attempts=2, backoff_seconds=0.0),
        engine_factory=FlakyEngine,
    )
    got = eng.locate(kmers)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)


def test_empty_kmer_list(built):
    seq, index = built
    eng = ReliableSearchEngine(index)
    assert len(eng.count([])) == 0
    assert eng.locate([]) == []


def test_reload_failure_does_not_abort_retries(built, rng, monkeypatch):
    """A transient reload error must not consume the retry budget or
    mask the shard error."""
    seq, index = built
    kmers = [random_kmer(rng, 5, AlphabetType.DNA) for _ in range(50)]
    want = SearchEngine(index).count(kmers)
    FlakyEngine.failures_remaining = 1
    eng = ReliableSearchEngine(
        index, shard_size=100,
        policy=RetryPolicy(max_attempts=3, backoff_seconds=0.0),
        engine_factory=FlakyEngine,
    )
    reload_attempts = []

    def broken_reload():
        reload_attempts.append(1)
        raise OSError("injected reload fault")

    monkeypatch.setattr(eng, "_reload_index", broken_reload)
    got = eng.count(kmers)  # retry with the CURRENT engine still works
    np.testing.assert_array_equal(got, want)
    assert reload_attempts


def test_no_recovery_work_after_final_attempt(built, rng):
    """The last failed attempt raises immediately — no index reload or
    backoff sleep for a result that is discarded."""
    _, index = built
    FlakyEngine.failures_remaining = 99
    eng = ReliableSearchEngine(
        index, shard_size=100,
        policy=RetryPolicy(max_attempts=2, backoff_seconds=0.0),
        engine_factory=FlakyEngine,
    )
    with pytest.raises(RuntimeError, match="injected fault"):
        eng.count([b"ACGT"])
    # reload runs between attempts only: 2 attempts -> 1 reload
    assert eng.stats["reloads"] == 1


def test_retry_policy_validates_attempts():
    with pytest.raises(ValueError, match="max_attempts"):
        RetryPolicy(max_attempts=0)


class BadInputEngine(SearchEngine):
    """Raises a deterministic input error on every call."""

    calls = 0

    def count(self, kmers):
        BadInputEngine.calls += 1
        raise ValueError("bad kmer")


def test_deterministic_error_fails_fast(built):
    """A ValueError (bad input) must NOT consume retries, reload the
    index, or back off — it is raised on the first attempt
    (reference analogue: fatal codes vs
    AwFmFileReadFail, AwFmParallelSearch.c:356-359)."""
    _, index = built
    BadInputEngine.calls = 0
    eng = ReliableSearchEngine(
        index, shard_size=100,
        policy=RetryPolicy(max_attempts=5, backoff_seconds=10.0),
        engine_factory=BadInputEngine,
    )
    with pytest.raises(ValueError, match="bad kmer"):
        eng.count([b"ACGT"])
    assert BadInputEngine.calls == 1  # exactly one attempt
    assert eng.stats["retries"] == 0
    assert eng.stats["reloads"] == 0


def test_custom_retryable_predicate(built):
    """The policy's retryable callback decides, so users can opt
    specific errors in/out."""
    _, index = built
    BadInputEngine.calls = 0
    eng = ReliableSearchEngine(
        index, shard_size=100,
        policy=RetryPolicy(max_attempts=3, backoff_seconds=0.0,
                           reload_index_on_failure=False,
                           retryable=lambda e: True),
        engine_factory=BadInputEngine,
    )
    with pytest.raises(ValueError, match="bad kmer"):
        eng.count([b"ACGT"])
    assert BadInputEngine.calls == 3  # opted back into retries
    assert eng.stats["retries"] == 3
