"""ctypes loader for the native host helpers (``csrc/host_pack.cpp``).

Counterpart of ``bsgs_tpu/utils/native.py``. The library is built with
``g++`` at first use into ``bsgs_tpu_torch/_build/``, named by a digest of
the source and the build command (an edit rebuilds), and never beside its
source. A failed build raises: nothing falls back. ``sort_prefixes_plain``
and ``csr_pack_plain`` are the numpy versions of the two entries, which
the tests hold the library against.

The native path matters for big host-packed tables: radix-sorting the
prefixes is the host-side hot spot of a host pack (the reference does this
with multi-threaded PureBasic/x86 insertion sorts, 1_9_7File.pb:2771-2895).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

SRC = Path(__file__).resolve().parent.parent / "csrc" / "host_pack.cpp"
BUILD = Path(__file__).resolve().parent.parent / "_build"
CMD = ["g++", "-O3", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_libs: list = []


def build() -> Path:
    """Compile host_pack.cpp unless this source and command are already
    built; returns the shared library. Raises if g++ fails."""
    h = hashlib.sha256(SRC.read_bytes())
    h.update(" ".join(CMD).encode())
    out = BUILD / f"libbsgs_host_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        r = subprocess.run(CMD + ["-o", str(tmp), str(SRC)],
                           capture_output=True, text=True, timeout=300)
        if r.returncode != 0:
            raise RuntimeError(f"g++ failed on {SRC.name}:\n{r.stderr}")
        os.replace(tmp, out)
    finally:
        if tmp.exists():
            tmp.unlink()
    return out


def _load():
    with _lock:
        if not _libs:
            lib = ctypes.CDLL(str(build()))
            u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
            u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
            lib.bsgs_sort_prefixes.argtypes = [u64p, u32p, ctypes.c_int64]
            lib.bsgs_sort_prefixes.restype = ctypes.c_int
            lib.bsgs_csr_pack.argtypes = [u64p, ctypes.c_int64, ctypes.c_int,
                                          u32p, u32p]
            lib.bsgs_csr_pack.restype = ctypes.c_int64
            _libs.append(lib)
        return _libs[0]


def sort_prefixes(pre: np.ndarray):
    """Sort 64-bit prefixes ascending (stable); returns (sorted_pre,
    positions) where positions are the 1-based original indices (baby
    indices)."""
    n = pre.shape[0]
    pos = np.arange(1, n + 1, dtype=np.uint32)
    pre = np.array(pre, dtype=np.uint64, copy=True, order="C")
    _load().bsgs_sort_prefixes(pre, pos, n)
    return pre, pos


def sort_prefixes_plain(pre: np.ndarray):
    """numpy version of sort_prefixes."""
    pos = np.arange(1, pre.shape[0] + 1, dtype=np.uint32)
    order = np.argsort(pre, kind="stable")
    return np.asarray(pre, np.uint64)[order], pos[order]


def csr_pack(sorted_pre: np.ndarray, htsz: int):
    """-> (offsets (2^htsz+1,) u32, disc (n,) u32, max_bucket)."""
    if not 1 <= htsz <= 31:
        raise ValueError(f"bad htsz {htsz}")
    n = sorted_pre.shape[0]
    offsets = np.empty((1 << htsz) + 1, np.uint32)
    disc = np.empty(max(n, 1), np.uint32)
    maxb = _load().bsgs_csr_pack(
        np.ascontiguousarray(sorted_pre, np.uint64), n, htsz, offsets, disc)
    return offsets, disc[:n], int(maxb)


def csr_pack_plain(sorted_pre: np.ndarray, htsz: int):
    """numpy version of csr_pack."""
    n = sorted_pre.shape[0]
    buckets = (sorted_pre >> np.uint64(64 - htsz)).astype(np.int64)
    counts = np.bincount(buckets, minlength=1 << htsz)
    offsets = np.zeros((1 << htsz) + 1, dtype=np.uint32)
    np.cumsum(counts, out=offsets[1:])
    disc = ((sorted_pre << np.uint64(htsz)) >> np.uint64(32)).astype(np.uint32)
    return offsets, disc, int(counts.max()) if n else 0
