"""Host-side exact verification of device hit records.

The device is never trusted: every hit record is re-derived from scratch with
exact Python-integer EC arithmetic and only accepted if k*G equals the
target pubkey — the same philosophy as the reference's async checkerThread
(1_9_7File.pb:3933-4296), whose hit-code candidate enumeration this module
re-derives for the epoch-scan job layout.
"""

from __future__ import annotations

import dataclasses

from ..utils import ecpy
from .table import BabyTable


@dataclasses.dataclass(frozen=True)
class HitContext:
    """Geometry needed to decode a (t, flat) device record.

    q: target pubkey point (affine ints); pk: range start; s: giant stride
    (2w); n: offsets per job; job_base: global index of job t=0 in this
    epoch (jobs cover giant indices m in [g*(2N+1), (g+1)*(2N+1)) with
    center c_g = g*(2N+1) + N).
    """

    q: tuple
    pk: int
    s: int
    n: int
    job_base: int


def job_center(ctx: HitContext, t: int) -> int:
    return (ctx.job_base + t) * (2 * ctx.n + 1) + ctx.n


def giant_indices(ctx: HitContext, code: int, t: int, j: int):
    """Giant indices m to examine for a decoded (code, t, j) hit."""
    c = job_center(ctx, t)
    if code == 1:
        return [c - j]  # + branch: M + O_j = Q0 - (c-j) S G
    if code == 2:
        return [c + j]  # - branch
    if code == 4:
        return [c - j, c + j]  # exact landing: M == +-O_j
    return [c]  # center probe


def verify_hits_batched(records, table: BabyTable):
    """Re-derive and exactly verify a BATCH of hit records in two passes.

    records: iterable of (ctx, code, t, j). Pass 1 recomputes every landing
    X; pass 2 resolves ALL position lookups at once through
    table.lookup_positions_batch, so a table whose lookups are costly
    (the JAX package's rescan-mode big-w tables regenerate the baby stream
    per lookup) pays once per batch instead of once per hit.

    Returns (verified_keys, checked) where verified_keys are every k with
    k*G == Q found across the batch (range filtering is the caller's) and
    checked counts the records examined.
    """
    recs = list(records)
    q0_cache: dict = {}
    # pass 1: (record, m, landing-prefix or None for direct m*S candidates)
    work = []
    need = []
    for ctx, code, t, j in recs:
        key = (ctx.q, ctx.pk)
        if key not in q0_cache:
            q0_cache[key] = ecpy.sub(ctx.q, ecpy.mul(ctx.pk))  # Q - pk*G
        q0 = q0_cache[key]
        for m in giant_indices(ctx, code, t, j):
            if m < 0:
                continue
            if code == 4:
                work.append((ctx, m, None))
                continue
            landing = ecpy.sub(q0, ecpy.mul(m * ctx.s))
            if landing is None:
                work.append((ctx, m, None))
            else:
                pre = landing[0]
                work.append((ctx, m, pre))
                need.append(pre)
    # pass 2: one batched position resolution for every landing at once
    positions = table.lookup_positions_batch(need) if need else {}
    keys = []
    for ctx, m, pre in work:
        if pre is None:
            candidates = [m * ctx.s]
        else:
            candidates = []
            for r in positions.get(pre & ((1 << 64) - 1), []):
                candidates.append(m * ctx.s + r)
                candidates.append(m * ctx.s - r)
        for k0 in candidates:
            k = (ctx.pk + k0) % ecpy.N
            if ecpy.mul(k) == ctx.q and k not in keys:
                keys.append(k)
    return keys, len(recs)


def verify_hit(ctx: HitContext, table: BabyTable, code: int, t: int, j: int):
    """Re-derive and exactly verify one hit record.

    Returns the private key k with k*G == Q if the hit is real, else None.
    Enumerates k0 = m*S +- r for every baby index r whose stored prefix
    matches the recomputed landing X (duplicate-walk like the reference,
    1_9_7File.pb:4266-4277), plus k0 = m*S for exact landings.
    """
    keys, _ = verify_hits_batched([(ctx, code, t, j)], table)
    return keys[0] if keys else None
