"""Giant-step epoch: the device hot loop.

Counterpart of the fused path of ``bsgs_tpu/models/giant.py``. An epoch of
T jobs (centers M_t) against the N device-resident offsets O_j = j*S*G runs
as the epoch kernels (ops/epoch_kernel.epoch_landing_keys), the table probe
(ops/probe_kernel.probe_rows: nine launches per epoch at 4 phases, two
landing streams per phase and the centers) and a hit compaction that never
makes the host wait for the device.

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

from ..ops import epoch_kernel as EK, planar as PL
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


def dense_probe(dense):
    """The probe of a table held whole on this device: (bucket, disc) int32
    streams -> found, one probe kernel launch (table.probe_keys)."""
    return lambda bucket, disc: T.probe_keys(bucket, disc, dense)


def fused_epoch_probes(centers_x, centers_y, centers_inf, ox_pl, oy_pl,
                       probe, *, htsz: int, chunk_c: int = EK.CHUNK_C,
                       lanes_w: int = EK.LANES_W, hit_cap: int = 512,
                       phases: int = 1):
    """One epoch probed through ``probe`` (bucket, disc) -> found: a
    dense_probe, or parallel/sharded_table's collective probe of a table
    split over ranks (bsgs_tpu passes one closure per stream; in the port
    the three streams take the same one). Centers are rows (T, 16) int32
    and centers_inf (T,) bool; offsets are planar (16, N). Each landing
    stream of a phase is one probe.

    ``phases`` splits the T jobs into groups whose key planes are computed
    and probed one after another, so a phase's (8, T/phases*N) plane is
    the largest transient. The hit mask is
    phase-major: decode with decode_flat_phased.

    Returns (hit flat-indices (hit_cap,) int32 FILL-padded, (1,) count).
    """
    t_jobs = centers_x.shape[0]
    if t_jobs % phases:
        phases = 1
    per = t_jobs // phases
    parts = []
    for p in range(phases):
        sl = slice(p * per, (p + 1) * per)
        keys = EK.epoch_landing_keys(
            centers_x[sl].T.contiguous(), centers_y[sl].T.contiguous(),
            ox_pl, oy_pl, htsz=htsz, chunk_c=chunk_c, lanes_w=lanes_w,
        )
        exact = keys[4] != 0
        found_p = probe(keys[0], keys[1])
        found_m = probe(keys[2], keys[3])
        parts += [found_p & ~exact, found_m & ~exact, exact]
    hc_hi, hc_lo = PL.x_prefix64(centers_x.T.long())
    bc, dc = T.bucket_disc(hc_hi[0], hc_lo[0], htsz)
    found_c = probe(PL.u32_bits(bc), PL.u32_bits(dc))
    return _masks_to_hits(parts + [found_c | centers_inf], hit_cap)


def run_epoch_fused(centers_x, centers_y, centers_inf, ox_pl, oy_pl, dense,
                    *, htsz: int, chunk_c: int = EK.CHUNK_C,
                    lanes_w: int = EK.LANES_W, hit_cap: int = 512,
                    phases: int = 1):
    """The single-device epoch: fused_epoch_probes' hits, with the count as
    a 0-d tensor, and giant_steps, the probed landings (2 per offset and
    center pair plus each center)."""
    idxs, cnt = fused_epoch_probes(
        centers_x, centers_y, centers_inf, ox_pl, oy_pl, dense_probe(dense),
        htsz=htsz, chunk_c=chunk_c, lanes_w=lanes_w, hit_cap=hit_cap,
        phases=phases)
    return idxs, cnt[0], (2 * ox_pl.shape[1] + 1) * centers_x.shape[0]
