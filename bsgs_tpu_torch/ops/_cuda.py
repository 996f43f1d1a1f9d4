"""Build and bind the CUDA kernels of ``bsgs_tpu_torch/csrc``.

Each ``csrc/*.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, at first use, into
``bsgs_tpu_torch/_build/`` (named by a hash of the sources, so an edit
rebuilds), and loaded with ``ctypes``. All sources are compiled at once,
one ``nvcc`` each. A failed build raises; nothing falls back.

Every C entry launches on the stream it is given and returns
``cudaGetLastError()``; ``launch`` raises when that is not 0.

``LAUNCHES`` counts the launches of every kernel wrapper of the package
(``ops/epoch_kernel.py``, ``ops/probe_kernel.py``): a wrapper adds one
where it launches its kernel and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "_build"
ARCH = "arch=compute_90a,code=sm_90a"

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry -> argument types (pointers and the stream as c_void_p)
SIGNATURES = {
    "bsgs_epoch_fwd": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "bsgs_epoch_bwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                       _P],
    "bsgs_mont_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "bsgs_mont_bwd": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "bsgs_modinv": [_P, _P, _I, _P],
    "bsgs_add_const": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _P],
    "bsgs_probe_rows": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
}

# kernel wrappers, in the order of the JAX package's Pallas kernels
KERNELS = ("epoch_fwd", "epoch_bwd", "mont_fwd", "mont_bwd", "fermat",
           "add_const", "probe_rows")
LAUNCHES = dict.fromkeys(KERNELS, 0)


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


_lock = threading.Lock()
_libs: list = []


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build(verbose: bool = False) -> list[Path]:
    """Compile every csrc/*.cu (in parallel) unless this source hash is
    already built; returns the shared libraries. Raises on any failure."""
    BUILD.mkdir(parents=True, exist_ok=True)
    tag = _digest()
    nvcc = _nvcc()
    jobs = []
    outs = []
    for src in _sources():
        out = BUILD / f"lib{src.stem}_{tag}.so"
        outs.append(out)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, "-gencode", ARCH, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-I", str(CSRC), "-o", str(tmp),
               str(src)]
        if verbose:
            cmd[1:1] = ["-Xptxas", "-v"]
        jobs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    errors = []
    for src, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {src.name}:\n{log}")
            continue
        if verbose and log:
            print(log, end="")
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return outs


def _load():
    with _lock:
        if not _libs:
            found = {}
            for path in build():
                lib = ctypes.CDLL(str(path))
                for name, argtypes in SIGNATURES.items():
                    if hasattr(lib, name):
                        fn = getattr(lib, name)
                        fn.argtypes = argtypes
                        fn.restype = ctypes.c_int
                        found[name] = fn
            missing = set(SIGNATURES) - set(found)
            if missing:
                raise RuntimeError(
                    f"kernel entries missing: {sorted(missing)}")
            _libs.append(found)
        return _libs[0]


def launch(name: str, *args) -> None:
    """Call C entry ``name`` with ``args`` (tensors become their data
    pointers) on PyTorch's current stream; raise if the launch failed."""
    fn = _load()[name]
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    conv = [a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args]
    with torch.cuda.device(dev):
        conv.append(torch.cuda.current_stream(dev).cuda_stream)
        err = fn(*conv)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")
