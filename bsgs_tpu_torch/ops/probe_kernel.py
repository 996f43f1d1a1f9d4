"""The dense-table probe: found[i] = any(dense[bucket[i], :] == disc[i]).

Counterpart of ``bsgs_tpu/ops/probe_kernel.py``. Its Pallas kernel
(``_probe_dma_kernel``) is a CUDA kernel here (``csrc/probe_kernels.cu``,
one warp per probe); ``probe_rows`` is its wrapper and ``probe_rows_plain``
the plain PyTorch version of the same function. In the JAX package the
kernel was an experiment beside ``models/table.probe_keys``; here it sits
where ``probe_keys`` sits and every probe goes through it.

Dispatch, as in ``ops/epoch_kernel.py``: CUDA tensors launch the kernel (a
failed build or launch raises), CPU tensors run the plain version; nothing
falls back. Each launch adds one to ``_cuda.LAUNCHES["probe_rows"]``.

``bucket`` and ``disc`` are (m,) int32 tensors holding uint32 bits, any
m >= 0; ``dense`` is the (2^htsz, window) int32 bucket matrix. An empty
slot holds 0xFFFFFFFF and a probe whose disc equals that matches it, as in
the JAX package; buckets are trusted to be below 2^htsz.
"""

from __future__ import annotations

import torch

from . import _cuda

# Probes the plain version gathers at once: bounds its (block, window)
# transients whatever the stream's length.
PLAIN_BLOCK = 1 << 18

_I32 = torch.int32


def probe_rows_plain(bucket, disc, dense):
    """An index gather of dense rows, a compare and an any, block by block
    of the stream."""
    m = bucket.shape[0]
    found = torch.empty((m,), dtype=torch.bool, device=bucket.device)
    for s in range(0, m, PLAIN_BLOCK):
        sl = slice(s, s + PLAIN_BLOCK)
        rows = dense[bucket[sl].long()]
        found[sl] = (rows == disc[sl, None]).any(dim=1)
    return found


def check_probe_args(bucket, disc, dense) -> None:
    """What the kernel takes: (m,) int32 bucket and disc, a contiguous
    (rows, window) int32 dense with window a multiple of 4 slots and rows
    16-byte aligned (a lane reads one 16-byte uint4), all on one device.
    Anything else raises ValueError."""
    for name, t in (("bucket", bucket), ("disc", disc)):
        if t.dtype != _I32 or t.dim() != 1:
            raise ValueError(f"{name} must be 1-D int32, got {t.dtype} "
                             f"{tuple(t.shape)}")
    if bucket.shape != disc.shape:
        raise ValueError(f"bucket {tuple(bucket.shape)} and disc "
                         f"{tuple(disc.shape)} differ in length")
    if dense.dtype != _I32 or dense.dim() != 2:
        raise ValueError(f"dense must be 2-D int32, got {dense.dtype} "
                         f"{tuple(dense.shape)}")
    if not (bucket.device == disc.device == dense.device):
        raise ValueError(f"tensors on {bucket.device}, {disc.device} and "
                         f"{dense.device}")
    if bucket.shape[0] >= 1 << 31:
        raise ValueError(f"stream of {bucket.shape[0]} probes is too long")
    window = dense.shape[1]
    if window < 4 or window % 4:
        raise ValueError(f"window {window} is not a multiple of 4 slots")
    if not (bucket.is_contiguous() and disc.is_contiguous()
            and dense.is_contiguous()):
        raise ValueError("kernel inputs must be contiguous")
    if dense.data_ptr() % 16:
        raise ValueError("dense rows are not 16-byte aligned")


def probe_rows(bucket, disc, dense):
    """found (m,) bool: whether row bucket[i] of dense holds disc[i]."""
    dev = dense.device
    if dev.type == "cpu":
        if bucket.device != dev or disc.device != dev:
            raise ValueError(f"tensors on {bucket.device}, {disc.device} "
                             f"and {dev}")
        return probe_rows_plain(bucket, disc, dense)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_probe_args(bucket, disc, dense)
    m = bucket.shape[0]
    found = torch.empty((m,), dtype=torch.bool, device=dev)
    if m == 0:
        return found
    _cuda.launch("bsgs_probe_rows", bucket, disc, dense, found, m,
                 dense.shape[1] // 4)
    _cuda.LAUNCHES["probe_rows"] += 1
    return found
