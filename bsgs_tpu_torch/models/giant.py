"""Giant-step epoch: the device hot loop.

Counterpart of ``bsgs_tpu/models/giant.py``. An epoch of T jobs (centers
M_t) against the N device-resident offsets O_j = j*S*G computes every
landing x(M +- O_j), probes the table with their 64-bit prefixes and
compacts the hits without making the host wait for the device. Three
forms:

- the fused epoch (``fused_epoch_probes``): the epoch kernels
  (ops/epoch_kernel.epoch_landing_keys_packed) emit (bucket, disc) keys,
  and the probe kernel (ops/probe_kernel.probe_rows) answers them:
  nine probe launches per epoch at 4 phases, two landing streams per phase
  and the centers. It takes the centers and the offsets as packed planes
  (ops/planar.py: (8, T) and (8, N) int32 words), so a phase's centers
  are a column slice of the epoch's, copied nowhere. Its chain layout must
  divide N (solver.chain_layout);
- the unfused epoch (``epoch_probes``), for any N: the row-major field/ec
  surface over (T*N, 16) limbs with one batch inversion of every
  denominator (ec.batch_inv: the Montgomery and inversion kernels), and
  one probe launch for the whole stream of 2TN + T keys;
- cross-epoch pipelining (``pipelined_step``, ``probe_keys_flush``): the
  fused epoch's keys of epoch e are probed while epoch e + 1's are
  computed, on a second CUDA stream.

Hit record: a flat index into the epoch's probe space. With phases = 1:
  [0, TN)        + branch: t = i // N, j = i % N + 1  -> m = c_t - j
  [TN, 2TN)      - branch:                            -> m = c_t + j
  [2TN, 3TN)     exact landing (M == +-O_j)           -> m = c_t -+ j
  [3TN, 3TN+T)   center probe of M_t                  -> m = c_t
With phases > 1 the first three blocks repeat per phase (decode_flat_phased).
An index is a uint32, held as int32 bits on the device (hit_indices reads
it back); solver.SolverConfig keeps the probe space below FILL.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import _cuda, ec, epoch_kernel as EK, field as F
from ..utils import tracing
from . import table as T

# Unused hit slots (0xFFFFFFFF as int32 bits).
FILL = -1


def hit_indices(idxs: np.ndarray) -> np.ndarray:
    """A hit buffer's int32 bits read back -> its flat indices as uint32,
    the FILL slots dropped (bsgs_tpu's rule: every other value is a hit)."""
    flat = idxs.view(np.uint32)
    return flat[flat != np.uint32(FILL & 0xFFFFFFFF)]


def _masks_to_hits(mask_parts, hit_cap: int):
    """Compact the concatenated bool masks into the ascending indices of
    their first hit_cap hits, FILL-padded, and the total count as a (1,)
    int32 tensor — what jnp.nonzero(size=hit_cap) gives in bsgs_tpu, built
    from a cumsum and a sorted search so nothing syncs with the host."""
    m = torch.cat(list(mask_parts))
    csum = torch.cumsum(m, 0, dtype=torch.int32)
    cnt = csum[-1:]
    ranks = torch.arange(1, hit_cap + 1, dtype=torch.int32, device=m.device)
    # the index of the r-th hit is the first position where csum reaches r
    idx = torch.searchsorted(csum, ranks).to(torch.int32)
    idxs = torch.where(ranks <= cnt, idx, torch.full_like(idx, FILL))
    return idxs, cnt


def decode_flat(flat: int, t_jobs: int, n: int):
    """Host decode of a flat hit index -> (code, t, j).

    code 1: +branch (m = c_t - j); 2: -branch (m = c_t + j);
    4: exact landing (m = c_t -+ j); 5: center (j = 0).
    """
    tn = t_jobs * n
    if flat < tn:
        return 1, flat // n, flat % n + 1
    if flat < 2 * tn:
        f = flat - tn
        return 2, f // n, f % n + 1
    if flat < 3 * tn:
        f = flat - 2 * tn
        return 4, f // n, f % n + 1
    return 5, flat - 3 * tn, 0


def decode_flat_phased(flat: int, t_jobs: int, n: int, phases: int):
    """decode_flat for the phase-major layout of fused_epoch_probes:
    phases x [P+, P-, Pexact] blocks of (t_jobs/phases)*n each, then the
    T center probes."""
    if phases <= 1 or t_jobs % phases:
        return decode_flat(flat, t_jobs, n)
    per = t_jobs // phases
    block = per * n
    if flat >= phases * 3 * block:  # center probes
        return 5, flat - phases * 3 * block, 0
    p, rem = divmod(flat, 3 * block)
    code_i, rem = divmod(rem, block)
    t_local, j = divmod(rem, n)
    return (1, 2, 4)[code_i], p * per + t_local, j + 1


def make_probe(rows, *, htsz: int):
    """The (hi, lo) prefix probe of a table held whole on this device
    (table.probe: one probe kernel launch per stream). rows: its ProbeRows,
    or the BabyTable, whose planes are then read at each call."""
    return lambda hi, lo: T.probe(hi, lo, rows, htsz=htsz)


def epoch_probes(centers_x, centers_y, centers_inf, ox, oy, probe_fn, *,
                 hit_cap: int = 512):
    """The unfused epoch: T centers (T, 16) x N offsets (N, 16), row-major
    limbs, any N. All T*N denominators Ox - Mx share one batch inversion
    (a zero one, M == +-O_j, is an exact landing: code 4); the two landings
    of a pair share its inverse. ``probe_fn(hi, lo)`` answers the one
    stream of 2TN + T prefixes: make_probe, or parallel/sharded_table's
    collective probe. centers_inf (T,) bool marks centers at infinity,
    forced center hits.

    Returns (hit flat-indices (hit_cap,) int32 FILL-padded, (1,) count),
    in decode_flat's layout."""
    t_jobs, n = centers_x.shape[0], ox.shape[0]
    tn = t_jobs * n
    cxb, cyb = centers_x[:, None], centers_y[:, None]
    d = F.sub_mod(ox[None], cxb).reshape(tn, F.NLIMBS)
    exact = F.is_zero(d)
    d = F.select(exact, F.broadcast_const(1, device=d.device), d)
    inv_d = ec.batch_inv(d).reshape(t_jobs, n, F.NLIMBS)
    del d
    keys = []
    # x(M + O_j): lambda = (Oy - My) / (Ox - Mx); x(M - O_j) only needs the
    # square of (-Oy - My) / (Ox - Mx), so (Oy + My) serves. One landing
    # at a time, and each temporary freed: a plane of T*N int64 limbs is
    # 537 MB at T*N = 2^22.
    for num in (F.sub_mod, F.add_mod):
        lam = F.mul_mod(num(oy[None], cyb), inv_d)
        x = F.sub_mod(F.sub_mod(F.sqr_mod(lam), cxb), ox[None])
        del lam
        keys.append(F.x_prefix64(x.reshape(tn, F.NLIMBS)))
        del x
    del inv_d
    hc = F.x_prefix64(centers_x)
    found = probe_fn(torch.cat([keys[0][0], keys[1][0], hc[0]]),
                     torch.cat([keys[0][1], keys[1][1], hc[1]]))
    return _masks_to_hits(
        [found[:tn] & ~exact, found[tn:2 * tn] & ~exact, exact,
         found[2 * tn:] | centers_inf], hit_cap)


def dense_probe(rows):
    """The probe of a table held whole on this device: (bucket, disc)
    int32 streams -> found, one probe kernel launch (table.probe_keys).
    rows: its ProbeRows, or the BabyTable, whose planes are then read at
    each call."""
    return lambda bucket, disc: T.probe_keys(bucket, disc, rows)


def center_keys(cx, htsz: int):
    """The (bucket, disc) probe keys of packed centers (8, T): words 1 and 0
    are the hi and lo halves of x's low 64 bits."""
    return T.prefix_keys(cx[1], cx[0], htsz)


def fused_epoch_probes(cx, cy, centers_inf, ox, oy, probe, *, htsz: int,
                       chunk_c: int = EK.CHUNK_C, lanes_w: int = EK.LANES_W,
                       hit_cap: int = 512, phases: int = 1):
    """One epoch probed through ``probe`` (bucket, disc) -> found: a
    dense_probe, or parallel/sharded_table's collective probe of a table
    split over ranks (bsgs_tpu passes one closure per stream; in the port
    the three streams take the same one). Centers are packed (8, T) int32
    planes (rows of a wider plane may be passed as they are) and
    centers_inf (T,) bool; offsets are packed (8, N). Each landing stream
    of a phase is one probe.

    ``phases`` splits the T jobs into groups whose key planes are computed
    and probed one after another, so a phase's (8, T/phases*N) plane is
    the largest transient. The hit mask is
    phase-major: decode with decode_flat_phased.

    Returns (hit flat-indices (hit_cap,) int32 FILL-padded, (1,) count).
    """
    t_jobs = cx.shape[1]
    if t_jobs % phases:
        phases = 1
    per = t_jobs // phases
    parts = []
    for p in range(phases):
        sl = slice(p * per, (p + 1) * per)
        keys = EK.epoch_landing_keys_packed(
            cx[:, sl], cy[:, sl], ox, oy, htsz=htsz, chunk_c=chunk_c,
            lanes_w=lanes_w)
        exact = keys[4] != 0
        found_p = probe(keys[0], keys[1])
        found_m = probe(keys[2], keys[3])
        parts += [found_p & ~exact, found_m & ~exact, exact]
    found_c = probe(*center_keys(cx, htsz))
    return _masks_to_hits(parts + [found_c | centers_inf], hit_cap)


# ---------------------------------------------------------------------------
# Cross-epoch pipelining

_probe_streams: dict = {}


def probe_stream(device) -> torch.cuda.Stream:
    """The second stream of a card, on which pipelined_step probes."""
    device = torch.device(device)
    if device not in _probe_streams:
        _probe_streams[device] = torch.cuda.Stream(device)
    return _probe_streams[device]


def probe_keys_flush(keys, bc, dc, cinf, rows, *, hit_cap: int = 512):
    """Probe one epoch's key bundle (its (8, T*N) key plane from
    epoch_landing_keys_packed, with phases = 1, and its centers' keys)
    against a
    table's ProbeRows: the hits in decode_flat's layout and the count as a
    0-d tensor. Drains the last bundle of a pipelined scan."""
    exact = keys[4] != 0
    fp = T.probe_keys(keys[0], keys[1], rows)
    fm = T.probe_keys(keys[2], keys[3], rows)
    fc = T.probe_keys(bc, dc, rows)
    idxs, cnt = _masks_to_hits(
        [fp & ~exact, fm & ~exact, exact, fc | cinf], hit_cap)
    return idxs, cnt[0]


def _fork(dev):
    """(current stream, probe stream) of a card, where a pipelined step
    probes on a stream of its own; (None, None) on the CPU."""
    if dev.type != "cuda":
        return None, None
    return torch.cuda.current_stream(dev), probe_stream(dev)


def pipelined_step(prev_keys, prev_bc, prev_dc, prev_cinf, prev_valid,
                   cx, cy, ox, oy, rows, *, htsz: int,
                   chunk_c: int = EK.CHUNK_C, lanes_w: int = EK.LANES_W,
                   hit_cap: int = 512):
    """One step of a pipelined scan: the probe of the PREVIOUS epoch's key
    bundle (probe_keys_flush) and THIS epoch's keys
    (epoch_landing_keys_packed, phases = 1, on packed centers (8, T) and
    offsets (8, N), and its centers' keys). prev_valid False (the priming
    step) probes nothing and reports no hits.

    On the card the probe runs on a second stream (probe_stream), after
    the work already queued on the current one (which made the previous
    keys), while the epoch kernels run on the current stream; the current
    stream then waits for the probe, so whatever is queued on it later,
    the read of the hits included, sees them whole. On the CPU the two
    halves run one after the other.

    Recorded as ``probe`` (counts ``keys``, the 2TN + T probed, and
    ``launches``) and ``keys`` (counts ``T``), each with a device bracket
    on its own stream; where the probe forks, the open spans bracketed on
    the current stream count the fork and the join (tracing.fork_streams,
    join_streams).

    Returns (keys, bc, dc, idxs_prev, cnt_prev)."""
    dev = cx.device
    cur, side = _fork(dev)
    if not prev_valid:
        side = None  # nothing to probe
        idxs = torch.full((hit_cap,), FILL, dtype=torch.int32, device=dev)
        cnt = torch.zeros((), dtype=torch.int32, device=dev)
    else:
        if side is not None:
            side.wait_stream(cur)
            tracing.fork_streams(cur.device)
        # a no-op on the CPU (side None)
        with torch.cuda.stream(side), tracing.span("probe") as sp:
            if side is not None:
                sp.begin_device(side.device)
            sp.count("keys", 2 * prev_keys.shape[1] + prev_bc.shape[0])
            sp.delta("launches", _cuda.total_launches)
            idxs, cnt = probe_keys_flush(prev_keys, prev_bc, prev_dc,
                                         prev_cinf, rows, hit_cap=hit_cap)
        if side is not None:
            done = side.record_event()
            # the previous bundle is read on side: its memory must not go
            # back to the current stream's pool before side is done with
            # it
            for t in (prev_keys, prev_bc, prev_dc, prev_cinf):
                t.record_stream(side)
            # the hits are read on the current stream
            idxs.record_stream(cur)
            cnt.record_stream(cur)
    with tracing.span("keys") as sk:
        sk.begin_device(dev if cur is None else cur.device)
        sk.count("T", cx.shape[1])
        keys = EK.epoch_landing_keys_packed(cx, cy, ox, oy, htsz=htsz,
                                            chunk_c=chunk_c, lanes_w=lanes_w)
        bc, dc = center_keys(cx, htsz)
    if side is not None:
        cur.wait_event(done)
        tracing.join_streams(cur.device)
    return keys, bc, dc, idxs, cnt
