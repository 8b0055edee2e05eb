"""ctypes bindings for the native host library (libawfm_host.so).

The native library supplies the two host-side heavy lifts that the
reference delegates to C submodules:
  - 64-bit SA-IS suffix sorting (libdivsufsort equivalent,
    AwFmCreate.c:99-100);
  - buffered FASTA parsing (FastaVector equivalent, AwFmCreate.c:166-176).

The library is built on demand from native/src with g++ into
native/build, under a name keyed to the source's content, the compiler
flags and the host's architecture. A copy built for another source or
another machine therefore never loads in place of this one's, whatever
its file times say; a file at the keyed name that does not load is
rebuilt once. The flags carry no ``-march=native``, so a library built
on one x86-64 host runs on another. If a compiler or the sources are
unavailable, callers fall back to the NumPy/Python implementations.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_NATIVE_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_NATIVE_DIR, "src", "awfm_host.cpp")
_BUILD_DIR = os.path.join(_NATIVE_DIR, "build")
_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def lib_path(src: str = _SRC, build_dir: str = _BUILD_DIR) -> str:
    """Where the library built from ``src`` on this host lives."""
    digest = hashlib.sha256()
    with open(src, "rb") as fh:
        digest.update(fh.read())
    digest.update(" ".join(_FLAGS).encode())
    digest.update(f"{platform.system()}-{platform.machine()}".encode())
    return os.path.join(
        build_dir, f"libawfm_host-{digest.hexdigest()[:16]}.so"
    )


def _build(src: str, out: str) -> bool:
    os.makedirs(os.path.dirname(out), exist_ok=True)
    # build beside the target, then rename: concurrent builders (test
    # workers) never load a half-written file
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run(
            ["g++", *_FLAGS, src, "-o", tmp], capture_output=True,
            timeout=300,
        )
    except (OSError, subprocess.TimeoutExpired):
        return False
    if proc.returncode != 0:
        return False
    os.replace(tmp, out)
    return True


def open_library(src: str = _SRC, build_dir: str = _BUILD_DIR):
    """Load the library built from ``src``, building it first when the
    keyed file is missing or does not load. None if it cannot be built."""
    path = lib_path(src, build_dir)
    if not os.path.exists(path) and not _build(src, path):
        return None
    try:
        return ctypes.CDLL(path)
    except OSError:
        pass
    if not _build(src, path):
        return None
    try:
        return ctypes.CDLL(path)
    except OSError:
        return None


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None:
            return _lib
        if _build_failed or not os.path.exists(_SRC):
            _build_failed = True
            return None
        lib = open_library()
        if lib is None:
            _build_failed = True
            return None
        lib.awfm_suffix_array.restype = ctypes.c_int
        lib.awfm_suffix_array.argtypes = [
            ctypes.POINTER(ctypes.c_uint8),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64,
        ]
        lib.awfm_read_fasta.restype = ctypes.c_int
        lib.awfm_read_fasta.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
            ctypes.POINTER(ctypes.c_int64),
        ]
        lib.awfm_free.restype = None
        lib.awfm_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def suffix_array(sequence: np.ndarray) -> np.ndarray:
    """SA-IS suffix array over raw bytes; divsufsort64 call parity."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native host library unavailable")
    seq = np.ascontiguousarray(sequence, dtype=np.uint8)
    n = len(seq)
    if n == 0:
        return np.empty(0, dtype=np.int64)
    out = np.empty(n, dtype=np.int64)
    rc = lib.awfm_suffix_array(
        seq.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        ctypes.c_int64(n),
    )
    if rc != 0:
        raise RuntimeError(f"native suffix_array failed with code {rc}")
    return out


def read_fasta(path: str) -> Tuple[bytes, object]:
    """Native C++ FASTA parse (FastaVector-equivalent semantics)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native host library unavailable")
    from ..models.index import FastaMetadata

    seq_p = ctypes.POINTER(ctypes.c_uint8)()
    seq_len = ctypes.c_int64()
    hdr_p = ctypes.POINTER(ctypes.c_uint8)()
    hdr_len = ctypes.c_int64()
    hdr_ends_p = ctypes.POINTER(ctypes.c_int64)()
    seq_ends_p = ctypes.POINTER(ctypes.c_int64)()
    num_seqs = ctypes.c_int64()
    rc = lib.awfm_read_fasta(
        path.encode(), ctypes.byref(seq_p), ctypes.byref(seq_len),
        ctypes.byref(hdr_p), ctypes.byref(hdr_len),
        ctypes.byref(hdr_ends_p), ctypes.byref(seq_ends_p),
        ctypes.byref(num_seqs),
    )
    if rc == -1:
        raise FileNotFoundError(path)
    if rc != 0:
        raise RuntimeError(f"native read_fasta failed with code {rc}")
    try:
        n = num_seqs.value
        sequence = bytes(
            np.ctypeslib.as_array(seq_p, shape=(seq_len.value,))
        ) if seq_len.value else b""
        headers = bytes(
            np.ctypeslib.as_array(hdr_p, shape=(hdr_len.value,))
        ) if hdr_len.value else b""
        header_ends = (
            np.ctypeslib.as_array(hdr_ends_p, shape=(n,)).astype(np.uint64)
            if n else np.empty(0, np.uint64)
        )
        sequence_ends = (
            np.ctypeslib.as_array(seq_ends_p, shape=(n,)).astype(np.uint64)
            if n else np.empty(0, np.uint64)
        )
    finally:
        lib.awfm_free(seq_p)
        lib.awfm_free(hdr_p)
        lib.awfm_free(hdr_ends_p)
        lib.awfm_free(seq_ends_p)
    return sequence, FastaMetadata(
        headers=headers, header_ends=header_ends, sequence_ends=sequence_ends
    )
