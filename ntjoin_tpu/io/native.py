"""ctypes bindings for the native host library (``native/libntjoin_native.so``).

Optional acceleration: a C++ streaming FASTA parser and the sequential
rolling-hash sketcher (the host-native indexlr equivalent).  Everything here
degrades gracefully — callers check :func:`available` and fall back to the
pure-python/NumPy paths.  Build with ``make -C native`` (done automatically
on first use if a compiler is present).
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_LIB = None
_TRIED = False
_NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
)


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    so = os.path.join(_NATIVE_DIR, "libntjoin_native.so")
    src = os.path.join(_NATIVE_DIR, "ntjoin_native.cpp")
    stale = (
        os.path.exists(src)
        and os.path.exists(so)
        and os.path.getmtime(so) < os.path.getmtime(src)
    )
    if (not os.path.exists(so) or stale) and os.path.exists(src):
        # (re)build on first use AND whenever the source is newer than the
        # binary — loading a stale .so would silently ignore source fixes
        try:
            subprocess.run(
                ["make", "-C", _NATIVE_DIR],
                check=True,
                capture_output=True,
                timeout=120,
            )
        except (subprocess.SubprocessError, OSError):
            if stale:
                return None  # never load a known-stale binary
    if not os.path.exists(so):
        return None
    lib = ctypes.CDLL(so)
    lib.nj_sketch.restype = ctypes.c_int64
    lib.nj_sketch.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.nj_sketch_mt.restype = ctypes.c_int64
    lib.nj_sketch_mt.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
    ]
    lib.nj_canonical_hashes.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.nj_encode.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p]
    lib.nj_write_fai.restype = ctypes.c_int64
    lib.nj_write_fai.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.nj_write_dot.restype = ctypes.c_int64
    lib.nj_write_dot.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
        ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_void_p,
    ]
    lib.nj_fasta_open.restype = ctypes.c_void_p
    lib.nj_fasta_open.argtypes = [ctypes.c_char_p]
    lib.nj_fasta_count.restype = ctypes.c_int64
    lib.nj_fasta_count.argtypes = [ctypes.c_void_p]
    lib.nj_fasta_len.restype = ctypes.c_int64
    lib.nj_fasta_len.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.nj_fasta_name.restype = ctypes.c_int64
    lib.nj_fasta_name.argtypes = [
        ctypes.c_void_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.nj_fasta_seq.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.nj_fasta_seq_ptr.restype = ctypes.c_void_p
    lib.nj_fasta_seq_ptr.argtypes = [ctypes.c_void_p, ctypes.c_int64]
    lib.nj_fasta_codes.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
    lib.nj_fasta_close.argtypes = [ctypes.c_void_p]
    lib.nj_walk_chain.restype = ctypes.c_int64
    lib.nj_walk_chain.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p, ctypes.c_void_p,
    ]
    if hasattr(lib, "nj_pack2"):  # pre-r3 builds lack it; callers degrade
        lib.nj_pack2.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64,
        ]
    _LIB = lib
    return lib


def available() -> bool:
    return _load() is not None


def pack2_native(codes: np.ndarray, out: np.ndarray, byte_off: int) -> bool:
    """Pack int8 codes 4-per-byte into ``out[byte_off:]`` (C++ fast path).

    Returns False when the loaded library predates ``nj_pack2`` — callers
    fall back to the NumPy packer.
    """
    lib = _load()
    if lib is None or not hasattr(lib, "nj_pack2"):
        return False
    codes = np.ascontiguousarray(codes, dtype=np.int8)
    lib.nj_pack2(
        codes.ctypes.data, codes.shape[0], out.ctypes.data, byte_off
    )
    return True


def sketch_codes_native(codes: np.ndarray, k: int, w: int, threads: int = 0):
    """Rolling-hash sketch via the C++ library (bit-identical to the oracle).

    threads=0 uses all CPUs; tile-parallel with exact seam handling (N-free
    records; N-containing records run single-threaded).
    """
    from ntjoin_tpu.ops.nthash_np import Sketch

    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n = codes.shape[0]
    if k > n or w > n - k + 1:
        return Sketch(np.empty(0, dtype=np.int64), np.empty(0, dtype=np.uint64))
    cap = n - k + 2
    pos = np.empty(cap, dtype=np.int64)
    hashes = np.empty(cap, dtype=np.uint64)
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    threads = threads or (os.cpu_count() or 1)
    count = lib.nj_sketch_mt(
        codes.ctypes.data, n, k, w, threads,
        pos.ctypes.data, hashes.ctypes.data, cap,
    )
    return Sketch(positions=pos[:count].copy(), hashes=hashes[:count].copy())


def sketch_seq_host(seq: str | bytes, k: int, w: int):
    """Sketch an ASCII sequence on the fastest available host path.

    Native C++ encode + rolling sketch when the library is loadable, NumPy
    oracle otherwise — bit-identical either way (enforced by the parity
    suites).  This is the host analogue of the reference's in-process
    ``btllib.Indexlr`` use for overlap re-sketching
    (``ntjoin_assemble.py:478-479``).
    """
    lib = _load()
    if lib is None:
        from ntjoin_tpu.ops.nthash_np import sketch_seq

        return sketch_seq(seq, k, w)
    from ntjoin_tpu.ops.nthash_np import Sketch

    raw = seq.encode("ascii") if isinstance(seq, str) else bytes(seq)
    n = len(raw)
    if k > n or w > n - k + 1:
        return Sketch(np.empty(0, dtype=np.int64), np.empty(0, dtype=np.uint64))
    codes = np.empty(n, dtype=np.uint8)
    lib.nj_encode(raw, n, codes.ctypes.data)
    cap = n - k + 2
    pos = np.empty(cap, dtype=np.int64)
    hashes = np.empty(cap, dtype=np.uint64)
    count = lib.nj_sketch(codes.ctypes.data, n, k, w, pos.ctypes.data,
                          hashes.ctypes.data, cap)
    return Sketch(positions=pos[:count].copy(), hashes=hashes[:count].copy())


def read_fasta_native(path: str):
    """Parse FASTA via the C++ reader; returns list of FastaRecord."""
    from ntjoin_tpu.io.fasta import FastaRecord

    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    h = lib.nj_fasta_open(path.encode())
    if not h:
        raise FileNotFoundError(path)
    try:
        out = []
        cap = 4096
        name_buf = ctypes.create_string_buffer(cap)
        for i in range(lib.nj_fasta_count(h)):
            need = lib.nj_fasta_name(h, i, name_buf, cap)
            if need >= cap:  # metadata-stuffed header: grow and re-read
                cap = int(need) + 1
                name_buf = ctypes.create_string_buffer(cap)
                lib.nj_fasta_name(h, i, name_buf, cap)
            n = lib.nj_fasta_len(h, i)
            # single copy via string_at; latin-1 decode is a memcpy for the
            # byte-for-byte FASTA alphabet
            raw = ctypes.string_at(lib.nj_fasta_seq_ptr(h, i), n)
            out.append(FastaRecord(name_buf.value.decode(), raw.decode("latin-1")))
        return out
    finally:
        lib.nj_fasta_close(h)
