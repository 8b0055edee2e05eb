"""Run the engine's main path once on a GPU, at chromosome scale.

    python chip_smoke.py                # one card: the nine phases below
    python chip_smoke.py --four-cards   # four cards: the multi-device engines
    python chip_smoke.py --scale 0.01   # smaller corpora, for a quick compile check

The corpus has the length of GRCh38 chromosome 1 (248,956,422 bases),
drawn uniformly at random from ``--seed``, indexed with the reference's
recommended configuration (seed k = 12, suffix-array ratio 8). Every
answer is compared, with zero tolerance, with the host oracle (an
overlapping ``bytes.find`` scan of the corpus) or with another engine
that computes the same thing. All device arithmetic here is integer, so
any difference is a fault.

One card, in order: device, build (FASTA -> .awfmi -> load), count,
locate, dense device SA, routed gathers, wide layout, amino acids, and
each kernel-choosing ``AWFM_*`` option against the default. With
``--four-cards``: the query-replicated and the range-sharded engines
against single-card ``SearchEngine`` on device 0, and nothing else.

Each phase prints its wall seconds (cold: compilation included) and the
device's ``peak_bytes_in_use``. Any failed check raises, so the script
exits non-zero. The last line of standard output is one JSON object,
``{"ok": true, "device": {...}}``, printed only when every phase passed.
Without a GPU the script exits non-zero at once and prints no such line.

One process drives every card. Its only subprocesses are ``nvidia-smi``
and the g++ build of the native host library; neither opens a card.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np

CHR1_BASES = 248_956_422  # GRCh38 chromosome 1
AMINO_LETTERS = 64_000_000
OPTIONS_BASES = 1_000_000
SEED_K = 12  # the reference's recommended nucleotide seed length
AMINO_SEED_K = 5  # and its amino-acid one (README.md)
SA_RATIO = 8
KMER_LEN = 25
MULTI_HIT_LEN = 12  # ~15 hits each over a chr1-sized corpus
AMINO_QUERY_LEN = 20
ROUTED_QUERIES = 65_536

NT_LETTERS = np.frombuffer(b"ACGT", np.uint8)
AA_LETTERS = np.frombuffer(b"ACDEFGHIKLMNPQRSTVWY", np.uint8)

# kernel-choosing options that must each give the default's answers;
# routing is forced (on a tiny slab) where an option only acts there
OPTIONS = (
    {"AWFM_OCC_DOT": "1"},
    {"AWFM_NGRAM_U32": "1"},
    {"AWFM_RANK_U32": "1"},
    {"AWFM_BT_DIGRAM": "1"},
    {"AWFM_ENUM": "repeat"},
    {"AWFM_ENUM": "scatter"},
    {"AWFM_MS_WSUM": "0"},
    {"AWFM_MS_PREBIAS": "0"},
    {"AWFM_BT_PERMUTED": "0", "AWFM_ROUTE": "1",
     "AWFM_ROUTE_SLAB_BYTES": "16384"},
    {"AWFM_BT_COMPACT": "nonzero"},
)


class SmokeFailure(Exception):
    """An answer differed from its reference."""


def check(ok, what: str) -> None:
    if not ok:
        raise SmokeFailure(what)


# -- host side: corpora, queries and the oracle ------------------------------

def random_corpus(rng, n: int, letters: np.ndarray) -> np.ndarray:
    return letters[rng.integers(0, len(letters), size=n)]


def sample_kmers(rng, corpus: np.ndarray, n: int, length: int) -> list:
    """``n`` windows of ``length`` letters drawn from ``corpus``."""
    starts = rng.integers(0, len(corpus) - length + 1, size=n)
    buf = np.lib.stride_tricks.sliding_window_view(corpus, length)[
        starts
    ].tobytes()
    return [buf[i * length : (i + 1) * length] for i in range(n)]


def scan_positions(corpus: bytes, kmer: bytes) -> list:
    """Every (overlapping) start of ``kmer`` in ``corpus``."""
    out = []
    i = corpus.find(kmer)
    while i != -1:
        out.append(i)
        i = corpus.find(kmer, i + 1)
    return out


def write_fasta(path: str, name: bytes, seq: np.ndarray, width: int = 80):
    full = len(seq) // width
    with open(path, "wb") as fh:
        fh.write(b">" + name + b"\n")
        lines = np.empty((full, width + 1), np.uint8)
        lines[:, :width] = seq[: full * width].reshape(full, width)
        lines[:, width] = ord("\n")
        lines.tofile(fh)
        if full * width < len(seq):
            fh.write(seq[full * width :].tobytes() + b"\n")


def _flat(hits: list) -> tuple:
    lens = np.array([len(h) for h in hits], dtype=np.int64)
    flat = np.concatenate(hits) if hits else np.empty(0, np.uint64)
    return lens, flat


def same_hits(a: list, b: list) -> bool:
    """Equal hit lists, query by query and in order."""
    la, fa = _flat(a)
    lb, fb = _flat(b)
    return np.array_equal(la, lb) and np.array_equal(fa, fb)


def check_against_scan(corpus: bytes, kmers, counts, hits, sample, label):
    for i in sample:
        want = scan_positions(corpus, kmers[i])
        check(int(counts[i]) == len(want),
              f"{label}: count of query {i} is {counts[i]}, scan {len(want)}")
        if hits is not None:
            check(sorted(hits[i].tolist()) == want,
                  f"{label}: hits of query {i} differ from the scan")


@contextlib.contextmanager
def knobs(env: dict):
    """Set ``AWFM_*`` options for the block. The options are read when a
    step program is traced, so compiled programs are dropped on the way
    in and out."""
    import jax

    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    jax.clear_caches()
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        jax.clear_caches()


# -- reporting ----------------------------------------------------------------

def peak_bytes(devices) -> str:
    parts = []
    for d in devices:
        stats = d.memory_stats()
        parts.append(
            str(stats["peak_bytes_in_use"])
            if stats and "peak_bytes_in_use" in stats else "not available"
        )
    return ",".join(parts)


@contextlib.contextmanager
def phase(name: str, devices):
    t0 = time.perf_counter()
    yield
    secs = time.perf_counter() - t0
    print(
        f"phase {name}: {secs:.2f} s wall (cold, compile included); "
        f"peak_bytes_in_use={peak_bytes(devices)}",
        flush=True,
    )


# -- phases -------------------------------------------------------------------

def build_index(workdir: str, corpus: np.ndarray, *, seed_k=SEED_K,
                ratio=SA_RATIO):
    """FASTA -> create_index_from_fasta (native SA-IS) -> .awfmi -> load."""
    import avxwindowfmindex_tpu as awfm
    from avxwindowfmindex_tpu.native import hostlib

    check(hostlib.available(),
          "the native SA-IS library could not be built (g++)")
    fasta = os.path.join(workdir, "corpus.fa")
    path = os.path.join(workdir, "corpus.awfmi")
    write_fasta(fasta, b"chr1 random bases", corpus)
    cfg = awfm.IndexConfiguration(
        suffix_array_compression_ratio=ratio,
        kmer_length_in_seed_table=seed_k,
        alphabet_type=awfm.AlphabetType.DNA,
    )
    t0 = time.perf_counter()
    built = awfm.create_index_from_fasta(
        fasta, cfg, index_file_src=path, sa_backend="native"
    )
    t1 = time.perf_counter()
    check(built.bwt_length == len(corpus) + 1, "bwt length of the build")
    del built
    index = awfm.read_index_from_file(path)
    t2 = time.perf_counter()
    check(index.bwt_length == len(corpus) + 1, "bwt length of the load")
    print(
        f"  build {t1 - t0:.2f} s, load {t2 - t1:.2f} s, "
        f".awfmi {os.path.getsize(path)} bytes",
        flush=True,
    )
    return index


def run_count(index, corpus: np.ndarray, rng, *, n_sampled=1 << 20,
              n_random=1024, n_ambiguous=256, n_checked=64,
              n_missing_checked=16):
    """Count sampled, random and N-carrying 25-mers; returns the sampled
    k-mers and their counts."""
    import avxwindowfmindex_tpu as awfm

    text = corpus.tobytes()
    eng = awfm.SearchEngine(index)
    sampled = sample_kmers(rng, corpus, n_sampled, KMER_LEN)
    counts = eng.count(sampled)
    check(counts.shape == (n_sampled,), "count shape")
    check((counts >= 1).all(), "a sampled k-mer counted 0")
    check_against_scan(
        text, sampled, counts, None,
        rng.choice(n_sampled, min(n_checked, n_sampled), replace=False),
        "sampled count",
    )

    randoms = sample_kmers(
        rng, random_corpus(rng, n_random * KMER_LEN, NT_LETTERS),
        n_random, KMER_LEN,
    )
    rcounts = eng.count(randoms)
    missing = np.flatnonzero(rcounts == 0)
    hit = np.flatnonzero(rcounts != 0)
    check_against_scan(
        text, randoms, rcounts, None,
        list(missing[:n_missing_checked]) + list(hit), "random count",
    )

    check(b"N" not in text, "the corpus holds no N")
    ambiguous = []
    for km, j in zip(sampled[:n_ambiguous],
                     rng.integers(0, KMER_LEN, size=n_ambiguous)):
        ambiguous.append(km[:j] + b"N" + km[j + 1 :])
    acounts = eng.count(ambiguous)
    check((acounts == 0).all(), "a k-mer carrying N counted > 0")
    check_against_scan(
        text, ambiguous, acounts, None, range(min(16, n_ambiguous)),
        "N-carrying count",
    )

    ngram = awfm.NgramSearchEngine(index)
    check(np.array_equal(ngram.count(sampled), counts),
          "digram engine counts differ from single-step counts")
    return sampled, counts


def run_locate(index, corpus: np.ndarray, rng, sampled, counts, *,
               n_locate=1 << 18, n_multi=4096, n_checked=64):
    """Locate sampled 25-mers and multi-hit 12-mers; returns both batches
    with their hit lists."""
    import avxwindowfmindex_tpu as awfm

    text = corpus.tobytes()
    eng = awfm.SearchEngine(index)
    batches = {}
    queries = sampled[:n_locate]
    batches["sampled"] = (queries, counts[:n_locate], eng.locate(queries))
    multi = sample_kmers(rng, corpus, n_multi, MULTI_HIT_LEN)
    batches["multi-hit"] = (multi, eng.count(multi), eng.locate(multi))
    for label, (kmers, want, hits) in batches.items():
        lens, flat = _flat(hits)
        check(np.array_equal(lens, want.astype(np.int64)),
              f"{label}: hit totals differ from the counts")
        check((flat <= len(text) - len(kmers[0])).all(),
              f"{label}: a hit lies outside the corpus")
        check_against_scan(
            text, kmers, want, hits,
            rng.choice(len(kmers), min(n_checked, len(kmers)),
                       replace=False),
            f"{label} locate",
        )
        print(f"  {label}: {len(kmers)} queries, {len(flat)} hits",
              flush=True)
    return batches


def run_dense_sa(index, batches, ratio: int = 4):
    """Densify the loaded index's device SA; locate must not change."""
    import avxwindowfmindex_tpu as awfm

    index.densify_device_sa(ratio)
    eng = awfm.SearchEngine(index)
    check(eng.dev.ratio == ratio, "dense SA not installed")
    for label, (kmers, _, hits) in batches.items():
        check(same_hits(eng.locate(kmers), hits),
              f"{label}: dense-SA locate differs")


def run_routed(index, sampled, counts, hits, n=ROUTED_QUERIES):
    """Force slab-routed gathers; count and locate must not change."""
    import avxwindowfmindex_tpu as awfm

    queries = sampled[:n]
    with knobs({"AWFM_ROUTE": "1"}):
        eng = awfm.SearchEngine(index)
        ngram = awfm.NgramSearchEngine(index)
        check(np.array_equal(eng.count(queries), counts[:n]),
              "routed single-step count differs")
        check(np.array_equal(ngram.count(queries), counts[:n]),
              "routed digram count differs")
        check(same_hits(eng.locate(queries), hits[:n]),
              "routed locate differs")


def run_wide(index, sampled, counts, hits, n=ROUTED_QUERIES):
    """The hi/lo-u32 layout forced on the narrow corpus."""
    import avxwindowfmindex_tpu as awfm

    queries = sampled[:n]
    try:
        eng = awfm.SearchEngine(index.to_device(refresh=True, wide=True))
        check(eng.wide, "wide layout not installed")
        check(np.array_equal(eng.count(queries), counts[:n]),
              "wide count differs")
        check(same_hits(eng.locate(queries), hits[:n]),
              "wide locate differs")
    finally:
        index.to_device(refresh=True, wide=False)


def run_amino(rng, n_letters=AMINO_LETTERS, *, n_queries=ROUTED_QUERIES,
              n_checked=16, seed_k=AMINO_SEED_K):
    """A random protein corpus, count and locate of sampled 20-mers."""
    import avxwindowfmindex_tpu as awfm

    corpus = random_corpus(rng, n_letters, AA_LETTERS)
    cfg = awfm.IndexConfiguration(
        suffix_array_compression_ratio=SA_RATIO,
        kmer_length_in_seed_table=seed_k,
        alphabet_type=awfm.AlphabetType.AMINO,
    )
    index = awfm.create_index(corpus, cfg, sa_backend="native")
    eng = awfm.SearchEngine(index)
    queries = sample_kmers(rng, corpus, n_queries, AMINO_QUERY_LEN)
    counts = eng.count(queries)
    hits = eng.locate(queries)
    check((counts >= 1).all(), "a sampled amino k-mer counted 0")
    lens, _ = _flat(hits)
    check(np.array_equal(lens, counts.astype(np.int64)),
          "amino hit totals differ from the counts")
    check_against_scan(
        corpus.tobytes(), queries, counts, hits,
        rng.choice(n_queries, min(n_checked, n_queries), replace=False),
        "amino",
    )


def run_options(rng, n_bases=OPTIONS_BASES, *, n_queries=16_384,
                n_multi=1024, options=OPTIONS, seed_k=SEED_K):
    """Every kernel-choosing option must reproduce the default answers."""
    import jax.numpy as jnp

    import avxwindowfmindex_tpu as awfm
    from avxwindowfmindex_tpu.search import locate_flat_device

    corpus = random_corpus(rng, n_bases, NT_LETTERS)
    index = awfm.create_index(
        corpus,
        awfm.IndexConfiguration(
            suffix_array_compression_ratio=SA_RATIO,
            kmer_length_in_seed_table=seed_k,
            alphabet_type=awfm.AlphabetType.DNA,
        ),
        sa_backend="native",
    )
    queries = sample_kmers(rng, corpus, n_queries, KMER_LEN)
    multi = sample_kmers(rng, corpus, n_multi, 8)  # unseeded, many hits

    def answers():
        eng = awfm.SearchEngine(index)
        ngram = awfm.NgramSearchEngine(index)
        ranges = eng.find_ranges(queries)
        s, e = ranges[:, 0], ranges[:, 1]
        total = int(np.where(s <= e, e - s + 1, 0).sum())
        flat, qid, mask = locate_flat_device(
            eng.dev,
            jnp.asarray(s.astype(np.uint32)), jnp.asarray(e.astype(np.uint32)),
            capacity=-(-(total + 1) // 1024) * 1024,
        )
        mask = np.asarray(mask)
        return [
            eng.count(queries), ngram.count(queries), _flat(eng.locate(queries)),
            eng.count(multi), _flat(eng.locate(multi)),
            (np.asarray(flat)[mask], np.asarray(qid)[mask]),
        ]

    with knobs({}):
        want = answers()
    for env in options:
        with knobs(env):
            got = answers()
        for w, g in zip(want, got):
            w = w if isinstance(w, tuple) else (w,)
            g = g if isinstance(g, tuple) else (g,)
            check(all(np.array_equal(a, b) for a, b in zip(w, g)),
                  f"option {env} changed an answer")
        print(f"  {' '.join(f'{k}={v}' for k, v in env.items())}: identical",
              flush=True)


def run_four_cards(index, sampled, devices, *, n=1 << 18):
    """Replicated and range-sharded engines against one card."""
    import avxwindowfmindex_tpu as awfm
    from avxwindowfmindex_tpu.parallel.dist import (
        DistributedSearchEngine,
        make_query_mesh,
    )
    from avxwindowfmindex_tpu.parallel.range_sharded import (
        RangeShardedSearchEngine,
        make_index_mesh,
    )

    queries = sampled[:n]
    single = awfm.SearchEngine(index)
    want_counts = single.count(queries)
    want_hits = single.locate(queries)
    n_dev = len(devices)

    def spans_all(arr, what):
        held = {s.device for s in arr.addressable_shards if s.data.size}
        check(held == set(devices),
              f"{what} is on {len(held)} of {n_dev} devices")

    dist = DistributedSearchEngine(index, make_query_mesh(n_dev, devices))
    spans_all(dist.dev.packed, "replicated index")
    check(np.array_equal(dist.count(queries), want_counts),
          "replicated count differs")
    check(np.array_equal(dist.count_replicated(queries), want_counts),
          "all-gathered count differs")
    check(same_hits(dist.locate(queries), want_hits),
          "replicated locate differs")

    ranged = RangeShardedSearchEngine(index, make_index_mesh(n_dev, devices))
    spans_all(ranged.dev.packed, "range-sharded blocks")
    check(np.array_equal(ranged.count(queries), want_counts),
          "range-sharded count differs")
    check(same_hits(ranged.locate(queries), want_hits),
          "range-sharded locate differs")
    for d in devices:
        stats = d.memory_stats() or {}
        print(f"  {d}: bytes_in_use={stats.get('bytes_in_use')} "
              f"peak_bytes_in_use={stats.get('peak_bytes_in_use')}",
              flush=True)


# -- driver -------------------------------------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card engines and their "
                    "comparison with one card")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--scale", type=float, default=1.0,
                    help="multiply the corpus sizes (queries stay)")
    args = ap.parse_args(argv)

    import jax

    t0 = time.perf_counter()
    devices = jax.devices()
    print(f"device: platform={devices[0].platform} "
          f"kind={devices[0].device_kind} count={len(devices)} "
          f"jax={jax.__version__}", flush=True)
    if devices[0].platform != "gpu":
        print("chip_smoke: no GPU found; nothing was run", file=sys.stderr)
        return 2
    n_cards = 4 if args.four_cards else 1
    if len(devices) < n_cards:
        print(f"chip_smoke: needs {n_cards} cards, found {len(devices)}",
              file=sys.stderr)
        return 2
    devices = devices[:n_cards]

    from avxwindowfmindex_tpu.utils import devices as device_facts
    from avxwindowfmindex_tpu.utils.capacity import plan_capacity
    from avxwindowfmindex_tpu.utils.compile_cache import enable_compile_cache

    print(f"compile cache: {enable_compile_cache()}", flush=True)
    print(device_facts.nvidia_smi_name_and_power_limit(), flush=True)
    print(f"phase device: {time.perf_counter() - t0:.2f} s wall; "
          f"peak_bytes_in_use={peak_bytes(devices)}", flush=True)
    rng = np.random.default_rng(args.seed)
    n_bases = max(1 << 20, int(CHR1_BASES * args.scale))
    reduced = [
        f"{n_bases} random bases from seed {args.seed}, not GRCh38 chr1",
        "one chromosome, not the 3.1G-base genome",
        "wide layout forced on a narrow corpus (a real >2^32 corpus is "
        "not built: its host build takes about an hour)",
        "random amino letters, not a protein database",
    ]
    print("reduced: " + "; ".join(reduced), flush=True)

    corpus = random_corpus(rng, n_bases, NT_LETTERS)
    if args.four_cards:
        import avxwindowfmindex_tpu as awfm

        with phase("build", devices):
            index = awfm.create_index(
                corpus,
                awfm.IndexConfiguration(
                    suffix_array_compression_ratio=SA_RATIO,
                    kmer_length_in_seed_table=SEED_K,
                    alphabet_type=awfm.AlphabetType.DNA,
                ),
                sa_backend="native",
            )
        with phase("four cards", devices):
            run_four_cards(
                index, sample_kmers(rng, corpus, 1 << 18, KMER_LEN), devices
            )
    else:
        with tempfile.TemporaryDirectory() as workdir:
            with phase("build", devices):
                print("  capacity plan: "
                      + plan_capacity(n_bases, sa_ratio=SA_RATIO).summary(),
                      flush=True)
                index = build_index(workdir, corpus)
        with phase("count", devices):
            sampled, counts = run_count(index, corpus, rng)
        with phase("locate", devices):
            batches = run_locate(index, corpus, rng, sampled, counts)
        with phase("dense SA", devices):
            run_dense_sa(index, batches)
        hits = batches["sampled"][2]
        with phase("routed gathers", devices):
            run_routed(index, sampled, counts, hits)
        with phase("wide layout", devices):
            run_wide(index, sampled, counts, hits)
        del index, batches, hits
        with phase("amino", devices):
            run_amino(rng, max(1 << 20, int(AMINO_LETTERS * args.scale)))
        with phase("kernel options", devices):
            run_options(rng)

    d = jax.devices()[0]
    print(json.dumps({
        "ok": True,
        "device": {"platform": d.platform, "kind": d.device_kind,
                   "count": len(jax.devices())},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
