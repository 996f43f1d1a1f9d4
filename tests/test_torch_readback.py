"""How the solve loop reads an epoch's hits back (solver.HitReadback): on
the CPU the record reads the count and hit buffer, of one card's epoch or
of each rank's row of a mesh's gather, as the draining read does
(``int(cnt)``, ``idxs.cpu()``), overflow included, and the collect
decodes each row with its own job base; and the depth of
the pipeline changes no result of a solve, fused, unfused or
cross-pipelined, on a plain table and on a rescan table with false
positives planted. The ``chip`` cases read the same buffers on the card,
through pinned memory behind the record's own event, with no
synchronising call (``python -m pytest tests/test_torch_readback.py -m
chip --noconftest`` on the card); tests/test_torch_tracing.py's hold the
solve loop's wait there. Imports torch and the port only."""

import dataclasses
import types
import warnings

import numpy as np
import pytest
import torch

from bsgs_tpu_torch.models import giant as G, solver as S, table as T
from bsgs_tpu_torch.utils import ecpy

torch.set_num_threads(2)

CAP = 16
GEOM = dict(w=256, htsz=6, n_offsets=8, jobs_per_epoch=2, window=16,
            chunk_c=2, lanes_w=4, epoch_phases=2, verify_defer_epochs=2)
PK = 1 << 21
MODES = {"fused": dict(fused=True), "unfused": dict(fused=False),
         "cross_pipelined": dict(cross_pipeline=True)}


def _draining_read(idxs, cnt):
    """The read the solve loop made before HitReadback."""
    cnt = int(cnt)
    if cnt > idxs.shape[-1]:
        raise S.HitOverflow(cnt)
    return cnt, idxs.cpu().numpy()


def _read(read, idxs, cnt):
    try:
        n, bits = read(idxs, cnt)
    except S.HitOverflow as ov:
        return "overflow", ov.count
    return n, G.hit_indices(bits).tolist()


SPIN_CYCLES = 1 << 29  # about a quarter of a second of an H100's clock


def _syncs(fn):
    """fn's result and the synchronising CUDA calls it made
    (set_sync_debug_mode warnings)."""
    with warnings.catch_warnings(record=True) as got:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing" in str(w.message) for w in got)


def _read_rows(rb):
    try:
        cnts, bufs = rb.read()
    except S.HitOverflow as ov:
        return "overflow", ov.count
    return [(int(n), G.hit_indices(b).tolist()) for n, b in zip(cnts, bufs)]


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.chip)])
@pytest.mark.parametrize("rows", [1, 4])
@pytest.mark.parametrize("hits", [0, 5, CAP + 3],
                         ids=["empty", "some", "overflow"])
def test_readback_reads_as_the_draining_read(hits, rows, device):
    """One row is an epoch's count and hit buffer; several are a mesh's
    gather, [count, hits...] a rank, whose last row here holds ``hits``
    and the others a few each. Each row reads as the draining read of its
    own buffer, one row over the cap raises HitOverflow, and _collect
    decodes row c with job base first_job + c*T. On the card the rows
    come through pinned memory behind the record's own event, copied
    while a spin kernel queued before the compaction still runs; read()
    waits for that event alone."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("no CUDA card: run on the chip")
    masks = []
    for r in range(rows):
        mask = torch.zeros(1000, dtype=torch.bool)
        gen = torch.Generator().manual_seed(hits + 100 * r)
        n = hits if r == rows - 1 else r + 1
        mask[torch.randperm(1000, generator=gen)[:n]] = True
        masks.append(mask)

    def readback(on):
        parts = [G._masks_to_hits([m], CAP) for m in on]
        if rows == 1:
            return parts, S.HitReadback(parts[0][1], parts[0][0])
        return parts, S.HitReadback(
            torch.stack([torch.cat((c, i)) for i, c in parts]))

    on = [m.to(device) for m in masks]
    if device == "cuda":  # load the kernels and pin a host block first:
        # loading either may wait for the whole card
        readback([torch.zeros_like(m) for m in on])[1].read()
        torch.cuda._sleep(SPIN_CYCLES)
    parts, rb = readback(on)
    assert (rb.event is None) == (device == "cpu")
    if device == "cuda":
        assert not rb.ready()  # behind the spin
        got, syncs = _syncs(lambda: _read_rows(rb))
        assert syncs == 0 and rb.ready()
    else:
        assert rb.ready()
        got = _read_rows(rb)
    want = [_read(_draining_read, i, c) for i, c in parts]
    if hits > CAP:
        assert got == want[-1] == ("overflow", hits)
        return
    assert got == want
    assert want[-1] == (hits, sorted(torch.nonzero(masks[-1])[:, 0].tolist()))
    t_jobs = GEOM["jobs_per_epoch"]
    loop = types.SimpleNamespace(
        _behind=(), device=torch.device(device),
        cfg=types.SimpleNamespace(jobs_per_epoch=t_jobs),
        _records=lambda pub, pk, base, bits: [
            (base, f) for f in G.hit_indices(bits).tolist()])
    first_job = 7 * rows * t_jobs
    batch, gs = S.Solver._collect(loop, None, 0, (7, first_job, rb, 99))
    assert gs == 99 and batch == [(first_job + c * t_jobs, f)
                                  for c, (_, flat) in enumerate(want)
                                  for f in flat]


def _plant(baby, cfg, q0, m):
    """A dense entry with the disc of giant index m's landing in the first
    free slot of its bucket, the row's length moved with it: a probe hit
    that verification rejects (on a rescan table its hint's high byte
    does not match, so it costs no residue scan)."""
    pre = ecpy.sub(q0, ecpy.mul(m * cfg.stride))[0] & ((1 << 64) - 1)
    bucket = pre >> (64 - cfg.htsz)
    slot = int(baby.row_len[bucket])
    disc = (pre >> (32 - cfg.htsz)) & 0xFFFFFFFF
    baby.dense[bucket, slot] = disc - (1 << 32) if disc >= 1 << 31 else disc
    if baby.pos_lo is not None:
        sh, mk = T._disc_lo_shift(cfg.htsz)
        hint = ((((pre >> sh) & mk) ^ 0x5A) << 8) | 7
        baby.pos_lo[bucket, slot] = T._u16_bits(torch.tensor(hint))
    baby.row_len[bucket] += 1


@pytest.fixture(scope="module", params=["plain", "rescan"])
def table(request):
    """A table (the one-shot build, or the streamed build with rescan
    positions) with false positives planted in epochs 0, 1 and 2 of a
    5-epoch range whose key lies in epoch 3."""
    cfg = S.SolverConfig(**GEOM, positions="rescan")
    with pytest.MonkeyPatch.context() as mp:
        if request.param == "rescan":
            mp.setattr(T, "STREAMED_W", 128)
        baby = S.build_table(cfg, device="cpu")
    assert (baby.lookup_fn is not None) == (request.param == "rescan")
    k = PK + 3 * cfg.keys_per_epoch + 1000
    q0 = ecpy.sub(ecpy.mul(k), ecpy.mul(PK))
    span = 2 * cfg.jobs_span  # giant indices an epoch
    for m in (3, span + 5, 2 * span + 12):
        _plant(baby, cfg, q0, m)
    return dict(baby=baby, cfg=cfg, key=k,
                pke=PK + 5 * cfg.keys_per_epoch - 1)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_pipeline_depth_changes_no_result(table, mode):
    got = {}
    for depth in (1, 3):
        cfg = dataclasses.replace(table["cfg"], pipeline=depth,
                                  **MODES[mode])
        s = S.Solver(cfg, baby=table["baby"], device="cpu")
        assert s.fused == (mode != "unfused")
        assert s._pipelined == (mode == "cross_pipelined")
        calls = []
        res = s.solve(ecpy.mul(table["key"]), PK, table["pke"],
                      on_epoch=lambda e, steps: calls.append((e, steps)))
        got[depth] = (res.key, res.giant_steps, res.epochs,
                      res.hits_checked, calls)
    assert got[1] == got[3]
    key, steps, epochs, checked, calls = got[3]
    assert key == table["key"] and epochs >= 4 and checked >= 4
    assert [e for e, _ in calls] == list(range(len(calls)))
    assert np.all(np.diff([st for _, st in calls]) > 0)
