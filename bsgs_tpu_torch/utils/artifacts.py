"""Precomputed-table persistence: build-if-missing artifacts.

Counterpart of ``bsgs_tpu/utils/artifacts.py``, with the same file name,
keys and kinds, so that each package loads the other's artifacts (the
reference's Save_HTpacked / LOAD_HT*packed, 1_9_7File.pb:3645-3895, and
its README.md:36-42 workflow of generating on one machine and reusing).
Arrays are saved as the JAX package holds them: the port's int32 bits as
``uint32``, its int16 hint plane as ``uint16`` (the JAX package filters
false positives with the hint only when it loads as ``uint16``). A loaded
table lies on the caller's device and is spot-checked with seeded random
oracles.
"""

from __future__ import annotations

import os
import tempfile

import numpy as np
import torch

from .. import convert, resolve_device
from ..models import table as tbl
from . import ecpy, native


def baby_table_path(cache_dir: str, w: int, htsz: int, window: int = 0) -> str:
    # window is not part of the key: host and device artifacts re-derive
    # any window on load.
    return os.path.join(cache_dir, f"baby_w{w}_h{htsz}_v3.npz")


def _atomic_savez(path: str, **arrays) -> None:
    """Atomic write (temp + rename), like the reference's checkpoint
    discipline (1_9_7File.pb:3897-3931)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def save_baby_table(table: tbl.BabyTable, path: str) -> None:
    """Persist any table flavour (the reference's Save_HTpacked role,
    1_9_7File.pb:3645-3760):

    - ``host`` (host pack, full 64-bit sorted prefixes): prefix stream and
      positions; any window and the CSR re-derive on load;
    - ``device`` (one-shot device build, htsz+32-bit keys): offsets and the
      sorted (disc, position) streams;
    - ``streamed`` (mirror positions): the dense matrix and the position
      plane verbatim;
    - ``streamed-rescan``: the dense matrix and the uint16 hint plane."""
    head = dict(w=table.w, htsz=table.htsz, window=table.window)
    if table.sorted_pre is not None:
        _atomic_savez(path, kind="host", **head,
                      sorted_pre=np.asarray(table.sorted_pre, np.uint64),
                      sorted_pos=convert.u32(table.pos_sorted))
    elif table.pos_dense is not None:
        _atomic_savez(path, kind="streamed", **head,
                      dense=convert.u32(table.dense),
                      pos_dense=convert.u32(table.pos_dense),
                      offsets=convert.u32(table.offsets))
    elif table.lookup_fn is not None:
        arrays = dict(dense=convert.u32(table.dense),
                      offsets=convert.u32(table.offsets))
        if table.pos_lo is not None:
            arrays["pos_lo"] = table.pos_lo.cpu().numpy().view(np.uint16)
        _atomic_savez(path, kind="streamed-rescan", **head, **arrays)
    else:
        _atomic_savez(path, kind="device", **head,
                      offsets=convert.u32(table.offsets),
                      disc_sorted=convert.u32(table.disc_sorted),
                      pos_sorted=convert.u32(table.pos_sorted))


def load_baby_table(path: str, spot_checks: int = 8, window: int = 0,
                    device=None) -> tbl.BabyTable:
    """Load onto ``device`` and verify with random oracles (the reference's
    checkHTpackFile, 1_9_7File.pb:3101-3134): seeded random r in [1, w],
    r*G recomputed exactly, its position required. ``window`` is the
    caller's minimum row width: host and device artifacts re-derive the
    dense matrix at it; a streamed artifact, which stores its matrix, is
    refused if it is narrower."""
    dev = resolve_device(device)
    z = np.load(path)
    w, htsz = int(z["w"]), int(z["htsz"])
    kind = str(z["kind"]) if "kind" in z else "host"
    if kind == "host":
        sorted_pre = z["sorted_pre"]
        offsets, disc, maxb = native.csr_pack(sorted_pre, htsz)
        window = tbl.fit_window(maxb, max(window, int(z["window"])))
        offsets_t = convert.from_u32(offsets, dev)
        disc_t = convert.from_u32(disc, dev)
        table = tbl.BabyTable(
            w=w, htsz=htsz, window=window, offsets=offsets_t,
            disc_sorted=disc_t, pos_sorted=convert.from_u32(z["sorted_pos"],
                                                            dev),
            dense=tbl.dense_from_csr(offsets_t, disc_t, window),
            sorted_pre=sorted_pre)
    elif kind in ("streamed", "streamed-rescan"):
        if window > int(z["window"]):
            raise ValueError(
                f"streamed artifact {path} has window={int(z['window'])} "
                f"< requested {window}; rebuild it (--gen-only) at the "
                f"wider window — streamed tables cannot re-derive rows")
        dense = convert.from_u32(z["dense"], dev)
        pos_lo = lookup = None
        if "pos_lo" in z:
            hint = z["pos_lo"]
            if hint.dtype != np.uint16:
                raise ValueError(f"{path}: hint plane is {hint.dtype}, "
                                 f"expected uint16")
            pos_lo = torch.from_numpy(hint.view(np.int16)).to(dev)
        if kind == "streamed-rescan":
            lookup = (tbl.make_strided_lookup(w, dense, pos_lo, htsz)
                      if pos_lo is not None
                      else tbl.make_rescan_lookup(w, device=dev))
        table = tbl.BabyTable(
            w=w, htsz=htsz, window=int(z["window"]),
            offsets=convert.from_u32(z["offsets"], dev), disc_sorted=None,
            pos_sorted=None, dense=dense,
            pos_dense=convert.from_u32(z["pos_dense"], dev)
            if kind == "streamed" else None,
            pos_lo=pos_lo, lookup_fn=lookup)
    elif kind == "device":
        offsets_t = convert.from_u32(z["offsets"], dev)
        disc_t = convert.from_u32(z["disc_sorted"], dev)
        counts = np.diff(z["offsets"].astype(np.int64))
        window = tbl.fit_window(int(counts.max()) if counts.size else 0,
                                max(window, int(z["window"])))
        table = tbl.BabyTable(
            w=w, htsz=htsz, window=window, offsets=offsets_t,
            disc_sorted=disc_t,
            pos_sorted=convert.from_u32(z["pos_sorted"], dev),
            dense=tbl.dense_from_csr(offsets_t, disc_t, window))
    else:
        raise ValueError(f"{path}: unknown artifact kind {kind!r}")
    rng = np.random.default_rng(0xB5B5)
    rs = [int(rng.integers(1, w + 1)) for _ in range(min(spot_checks, w))]
    pres = {r: ecpy.mul(r)[0] & ((1 << 64) - 1) for r in rs}
    # a rescan lookup regenerates stream per call: all spots in one batch
    found = table.lookup_positions_batch(list(pres.values()))
    for r in rs:
        if r not in found[pres[r]]:
            raise ValueError(f"baby table artifact corrupt at r={r}: {path}")
    return table


def get_baby_table(w: int, htsz: int, window: int = tbl.DEVICE_WINDOW,
                   cache_dir: str | None = None, tile: int = 1 << 18,
                   device=None, build=None) -> tbl.BabyTable:
    """Build-if-missing with on-disk caching: the artifact of (w, htsz) in
    cache_dir, loaded and spot-checked, or a new table from ``build()`` (by
    default the host pack), saved there and read back from the file, so
    that what the caller gets is what was saved and checked. Without a
    cache_dir the table is only built."""
    if build is None:
        def build():
            return tbl.build_baby_table(w, htsz, window=window, tile=tile,
                                        device=device)

    if cache_dir is None:
        return build()
    path = baby_table_path(cache_dir, w, htsz, window)
    if not os.path.exists(path):
        table = build()
        save_baby_table(table, path)
        del table
    return load_baby_table(path, window=window, device=device)
