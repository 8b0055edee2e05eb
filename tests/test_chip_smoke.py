"""chip_smoke.py's phases, driven on the CPU at a tiny size.

On the card the script runs these same functions at chromosome scale
(``python chip_smoke.py``); here they run on small corpora so that their
checks, and the way they call the engines, are exercised on every test
run. ``test_chip_smoke_on_gpu`` runs the script itself and needs a card.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import chip_smoke as cs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEED_K = 8  # a small seed table keeps the CPU build cheap


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    rng = np.random.default_rng(11)
    corpus = cs.random_corpus(rng, 60_000, cs.NT_LETTERS)
    index = cs.build_index(
        str(tmp_path_factory.mktemp("smoke")), corpus, seed_k=SEED_K
    )
    sampled, counts = cs.run_count(
        index, corpus, rng, n_sampled=2048, n_random=64, n_ambiguous=32,
        n_checked=16,
    )
    return rng, corpus, index, sampled, counts


def test_build_and_count_phases(smoke):
    _, corpus, index, sampled, counts = smoke
    assert index.bwt_length == len(corpus) + 1
    assert index.config.kmer_length_in_seed_table == SEED_K
    assert len(sampled) == len(counts) == 2048
    assert (counts >= 1).all()


def test_locate_and_dense_sa_phases(smoke):
    rng, corpus, index, sampled, counts = smoke
    batches = cs.run_locate(index, corpus, rng, sampled, counts,
                            n_locate=1024, n_multi=128, n_checked=16)
    assert set(batches) == {"sampled", "multi-hit"}
    cs.run_dense_sa(index, batches, ratio=4)
    index.to_device(refresh=True)


def test_routed_and_wide_phases(smoke):
    _, _, index, sampled, counts = smoke
    import avxwindowfmindex_tpu as awfm

    hits = awfm.SearchEngine(index).locate(sampled[:512])
    cs.run_routed(index, sampled, counts, hits, n=512)
    cs.run_wide(index, sampled, counts, hits, n=512)
    assert not awfm.SearchEngine(index).wide  # narrow layout restored


def test_amino_phase():
    cs.run_amino(np.random.default_rng(12), 40_000, n_queries=512,
                 n_checked=8, seed_k=3)


def test_options_phase():
    cs.run_options(
        np.random.default_rng(13), 30_000, n_queries=256, n_multi=32,
        seed_k=SEED_K,
        options=({"AWFM_ENUM": "scatter"}, {"AWFM_OCC_DOT": "1"}),
    )


def test_four_cards_phase_on_virtual_devices(smoke):
    import jax

    _, _, index, sampled, _ = smoke
    cs.run_four_cards(index, sampled, jax.devices()[:4], n=512)


def test_a_wrong_answer_fails_the_phase(smoke):
    """The checks bite: counting against another corpus must fail."""
    rng, corpus, index, _, _ = smoke
    other = cs.random_corpus(np.random.default_rng(99), len(corpus),
                             cs.NT_LETTERS)
    with pytest.raises(cs.SmokeFailure):
        cs.run_count(index, other, rng, n_sampled=256, n_random=8,
                     n_ambiguous=8, n_checked=8)


def test_main_without_a_gpu_exits_nonzero(capsys):
    rc = cs.main([])
    out = capsys.readouterr().out
    assert rc != 0
    assert '"ok"' not in out


@pytest.fixture
def gpu_present():
    """The card is looked for here, at run time, never at import."""
    if shutil.which("nvidia-smi") is None:
        pytest.skip("no GPU: nvidia-smi is not installed")
    if subprocess.run(["nvidia-smi", "-L"], capture_output=True).returncode:
        pytest.skip("no GPU: nvidia-smi lists no card")


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu_present):
    """The whole script on the card at a small scale. It runs in its own
    process, which is the only one that opens the card: the test process
    stays on the CPU."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py", "--scale", "0.01"], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=1200,
    )
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.strip().splitlines()[-1].startswith('{"ok": true')
