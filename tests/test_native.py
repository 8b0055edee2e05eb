"""Native SA-IS parity vs the NumPy doubling implementation."""

import os

import numpy as np
import pytest

from avxwindowfmindex_tpu import suffix_array as sa_mod
from avxwindowfmindex_tpu.native import hostlib

from oracle import random_sequence
from avxwindowfmindex_tpu.models.config import AlphabetType

pytestmark = pytest.mark.skipif(
    not hostlib.available(), reason="native host library not built"
)


def test_sais_matches_numpy_random(rng):
    for _ in range(30):
        n = int(rng.integers(2, 3000))
        seq = random_sequence(rng, n, AlphabetType.DNA) + b"$"
        arr = np.frombuffer(seq, dtype=np.uint8)
        got = hostlib.suffix_array(arr)
        want = sa_mod.build_suffix_array_numpy(arr)
        np.testing.assert_array_equal(got, want)


def test_sais_degenerate_runs():
    for seq in [b"a$", b"aa$", b"a" * 1000 + b"$", b"abab" * 250 + b"$",
                b"zyxw" * 100 + b"$", b"\x01\x02\x01\x02$"]:
        arr = np.frombuffer(seq, dtype=np.uint8)
        got = hostlib.suffix_array(arr)
        want = sa_mod.build_suffix_array_numpy(arr)
        np.testing.assert_array_equal(got, want, err_msg=repr(seq[:20]))


def test_sais_with_zero_bytes():
    # general-input path (bytes shifted +1 internally)
    seq = b"ban\x00ana\x00banana$"
    arr = np.frombuffer(seq, dtype=np.uint8)
    got = hostlib.suffix_array(arr)
    want = sa_mod.build_suffix_array_numpy(arr)
    np.testing.assert_array_equal(got, want)


def test_sais_amino(rng):
    seq = random_sequence(rng, 5000, AlphabetType.AMINO) + b"$"
    arr = np.frombuffer(seq, dtype=np.uint8)
    np.testing.assert_array_equal(
        hostlib.suffix_array(arr), sa_mod.build_suffix_array_numpy(arr)
    )


def test_build_uses_native_backend(rng):
    from avxwindowfmindex_tpu import AlphabetType as AT
    from avxwindowfmindex_tpu import IndexConfiguration, create_index

    seq = random_sequence(rng, 2000, AT.DNA)
    cfg = IndexConfiguration(4, 3, AT.DNA)
    a = create_index(seq, cfg, sa_backend="native")
    b = create_index(seq, cfg, sa_backend="numpy")
    np.testing.assert_array_equal(a.bwt_letters, b.bwt_letters)
    np.testing.assert_array_equal(a.sampled_sa, b.sampled_sa)
    np.testing.assert_array_equal(a.kmer_seed_table, b.kmer_seed_table)


def test_native_fasta_matches_python(tmp_path):
    from avxwindowfmindex_tpu.io.fasta import read_fasta_python

    fasta = tmp_path / "x.fasta"
    fasta.write_text(
        ">first header with spaces\nGATTACA\nACGT ACGT\n"
        ">second\nTTTT\n\n>third empty\n>fourth\nCCC\n"
    )
    seq_n, md_n = hostlib.read_fasta(str(fasta))
    seq_p, md_p = read_fasta_python(str(fasta))
    assert seq_n == seq_p
    assert md_n.headers == md_p.headers
    np.testing.assert_array_equal(md_n.header_ends, md_p.header_ends)
    np.testing.assert_array_equal(md_n.sequence_ends, md_p.sequence_ends)


def test_native_fasta_crlf_and_headerless(tmp_path):
    from avxwindowfmindex_tpu.io.fasta import read_fasta_python

    fasta = tmp_path / "y.fasta"
    fasta.write_bytes(b"ACGT\r\nGGGG\r\n>named\r\nTTTT\r\n")
    seq_n, md_n = hostlib.read_fasta(str(fasta))
    seq_p, md_p = read_fasta_python(str(fasta))
    assert seq_n == seq_p == b"ACGTGGGGTTTT"
    assert md_n.num_sequences == md_p.num_sequences == 2
    np.testing.assert_array_equal(md_n.sequence_ends, md_p.sequence_ends)


def test_native_fasta_missing_file():
    with pytest.raises(FileNotFoundError):
        hostlib.read_fasta("/nonexistent/definitely_missing.fa")


def test_native_fasta_nul_bytes_match_python(tmp_path):
    # NUL inside a sequence line must not desynchronize the parse
    from avxwindowfmindex_tpu.io.fasta import read_fasta_python

    fasta = tmp_path / "nul.fasta"
    fasta.write_bytes(b">h1\nAC\x00GT\n>h2\nTTTT\n")
    seq_n, md_n = hostlib.read_fasta(str(fasta))
    seq_p, md_p = read_fasta_python(str(fasta))
    assert seq_n == seq_p == b"AC\x00GTTTTT"
    assert md_n.num_sequences == md_p.num_sequences == 2
    np.testing.assert_array_equal(md_n.sequence_ends, md_p.sequence_ends)


def test_native_empty_suffix_array():
    np.testing.assert_array_equal(
        hostlib.suffix_array(np.empty(0, np.uint8)), np.empty(0, np.int64)
    )


def test_fasta_midline_cr_stripped(tmp_path):
    """A stray mid-line CR must not enter the sequence (it would
    sanitize into an ambiguity letter and silently corrupt the index) —
    in BOTH parsers, which stay in lock-step."""
    from avxwindowfmindex_tpu.io.fasta import read_fasta_python

    fasta = tmp_path / "cr.fasta"
    fasta.write_bytes(b">h\nACGT\rACGT\nTT \tGG\n")
    seq_p, md_p = read_fasta_python(str(fasta))
    assert seq_p == b"ACGTACGTTTGG"
    assert md_p.sequence_ends.tolist() == [12]
    if hostlib.available():
        seq_n, md_n = hostlib.read_fasta(str(fasta))
        assert seq_n == seq_p
        np.testing.assert_array_equal(md_n.sequence_ends, md_p.sequence_ends)


@pytest.mark.parametrize("kind", ["stale", "foreign"])
def test_library_is_rebuilt_for_its_source_and_host(tmp_path, kind):
    """A library built from other sources never loads in place of this
    one's (its file name is keyed to the source's content, the flags and
    the host), and a file at the keyed name that does not load is
    rebuilt rather than trusted."""
    src = tmp_path / "awfm_host.cpp"
    src.write_bytes(open(hostlib._SRC, "rb").read())
    build = tmp_path / "build"
    first = hostlib.lib_path(str(src), str(build))
    if kind == "stale":
        # an old build sits beside the source, newer than it, under the
        # old source's key; editing the source must move to a new key
        assert hostlib.open_library(str(src), str(build)) is not None
        src.write_bytes(src.read_bytes() + b"\n// edited\n")
        path = hostlib.lib_path(str(src), str(build))
        assert path != first and not os.path.exists(path)
    else:
        # a file copied in from elsewhere (here: not a library at all)
        path = first
        os.makedirs(build)
        with open(path, "wb") as fh:
            fh.write(b"not an ELF file")
    lib = hostlib.open_library(str(src), str(build))
    assert lib is not None and hasattr(lib, "awfm_suffix_array")
    assert open(path, "rb").read(4) == b"\x7fELF"
