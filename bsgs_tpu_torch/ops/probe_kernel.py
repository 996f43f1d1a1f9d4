"""The dense-table probe over each row's occupied slots:
found[i] = any(dense[b, :n] == d) | (d == FILL & n < window), with
b = bucket[i], d = disc[i] and n = row_len[b].

Counterpart of ``bsgs_tpu/ops/probe_kernel.py``. Its Pallas kernel
(``_probe_dma_kernel``) is a CUDA kernel here (``csrc/probe_kernels.cu``:
a group of 8 lanes a probe, reading only its row's occupied slots);
``probe_rows`` is its wrapper and ``probe_rows_plain`` the plain PyTorch
version of the same function. In the JAX package the kernel was an
experiment beside ``models/table.probe_keys``; here it sits where
``probe_keys`` sits and every probe goes through it.

Every build fills a row from slot 0 and leaves FILL after its last entry,
so on its tables the function is bit for bit the JAX package's
any(dense[b, :] == d): an empty slot holds 0xFFFFFFFF and a probe whose
disc equals that matches it. The end of a row comes from ``row_len``, the
bucket counts (``row_lengths``), never from the first FILL slot, since a
real entry's disc can be 0xFFFFFFFF.

Dispatch, as in ``ops/epoch_kernel.py``: CUDA tensors launch the kernel (a
failed build or launch raises), CPU tensors run the plain version; nothing
falls back, and no path reads whole rows. Each launch adds one to
``_cuda.LAUNCHES["probe_rows"]``.

``bucket`` and ``disc`` are (m,) int32 tensors holding uint32 bits, any
m >= 0; ``dense`` is the (rows, window) int32 bucket matrix and
``row_len`` its (rows,) lengths, of ``row_len_dtype(window)``. Buckets are
trusted to be below rows, lengths to be at most the window.
"""

from __future__ import annotations

import torch

from . import _cuda

# Probes the plain version gathers at once: bounds its (block, window)
# transients whatever the stream's length.
PLAIN_BLOCK = 1 << 18

FILL = -1  # 0xFFFFFFFF as int32 bits

_I32 = torch.int32


def row_len_dtype(window: int) -> torch.dtype:
    """The row-length plane's type: uint8 up to 255 slots a row, int16
    above."""
    return torch.uint8 if window <= 255 else torch.int16


def row_lengths(counts, window: int) -> torch.Tensor:
    """A table's bucket counts (any integer tensor, each at most the
    window) -> its row-length plane."""
    return counts.to(row_len_dtype(window))


def probe_rows_plain(bucket, disc, dense, row_len):
    """An index gather of dense rows and their lengths, a compare masked
    to each row's occupied slots and an any, block by block of the
    stream."""
    m, window = bucket.shape[0], dense.shape[1]
    found = torch.empty((m,), dtype=torch.bool, device=bucket.device)
    cols = torch.arange(window, device=bucket.device)
    for s in range(0, m, PLAIN_BLOCK):
        sl = slice(s, s + PLAIN_BLOCK)
        b = bucket[sl].long()
        d = disc[sl]
        n = row_len[b].long()
        occupied = cols < n[:, None]
        found[sl] = (((dense[b] == d[:, None]) & occupied).any(dim=1)
                     | ((d == FILL) & (n < window)))
    return found


def _check_row_len(dense, row_len) -> None:
    if row_len is None:
        raise ValueError("the probe needs the table's row lengths")
    want = row_len_dtype(dense.shape[1])
    if row_len.dtype != want or row_len.shape != dense.shape[:1]:
        raise ValueError(f"row_len must be {want} of shape "
                         f"{tuple(dense.shape[:1])}, got {row_len.dtype} "
                         f"{tuple(row_len.shape)}")
    if row_len.device != dense.device:
        raise ValueError(f"row_len on {row_len.device}, dense on "
                         f"{dense.device}")


def check_probe_args(bucket, disc, dense, row_len) -> None:
    """What the kernel takes: (m,) int32 bucket and disc, a contiguous
    (rows, window) int32 dense with window a multiple of 4 slots and rows
    16-byte aligned (a lane reads one 16-byte uint4), its contiguous
    (rows,) row_len of row_len_dtype(window), all on one device. Anything
    else raises ValueError."""
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
    _check_row_len(dense, row_len)
    if bucket.shape[0] >= 1 << 31:
        raise ValueError(f"stream of {bucket.shape[0]} probes is too long")
    window = dense.shape[1]
    if window < 4 or window % 4:
        raise ValueError(f"window {window} is not a multiple of 4 slots")
    if not (bucket.is_contiguous() and disc.is_contiguous()
            and dense.is_contiguous() and row_len.is_contiguous()):
        raise ValueError("kernel inputs must be contiguous")
    if dense.data_ptr() % 16:
        raise ValueError("dense rows are not 16-byte aligned")


def launch_probe_rows(bucket, disc, dense, row_len, found) -> None:
    """One launch of the kernel into ``found`` (m,) bool, unchecked and
    uncounted: probe_rows' launch, and chip_smoke.py's probe study."""
    _cuda.launch("bsgs_probe_rows", bucket, disc, dense, row_len, found,
                 bucket.shape[0], dense.shape[1] // 4, row_len.element_size())


def probe_rows(bucket, disc, dense, row_len):
    """found (m,) bool: whether the occupied slots of row bucket[i] of
    dense hold disc[i] (an 0xFFFFFFFF disc also matches a row with an
    empty slot)."""
    dev = dense.device
    if dev.type == "cpu":
        if bucket.device != dev or disc.device != dev:
            raise ValueError(f"tensors on {bucket.device}, {disc.device} "
                             f"and {dev}")
        _check_row_len(dense, row_len)
        return probe_rows_plain(bucket, disc, dense, row_len)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    check_probe_args(bucket, disc, dense, row_len)
    m = bucket.shape[0]
    found = torch.empty((m,), dtype=torch.bool, device=dev)
    if m == 0:
        return found
    launch_probe_rows(bucket, disc, dense, row_len, found)
    _cuda.LAUNCHES["probe_rows"] += 1
    return found
