"""The plain reference of a baby-step/giant-step scan, and the judge.

It works out again, from the curve alone, what each piece of the timed
path had to produce, and counts where the program's outputs differ:

- the key each solve returned (or None where the key lies outside the
  range);
- the baby table: baby point r*G must sit in the row of its bucket, with
  its disc and, on a rescan table, its 16-bit hint; the rows together hold
  w entries;
- the epoch's landing keys: (bucket, disc) of x(M_g + O_j) and
  x(M_g - O_j), and the exact flag, of sampled lanes;
- the probe's hits: each hit index decoded here names a landing whose
  disc the table's row holds (or an exact landing, or a center). A row is
  probed whole, as the scan defines the probe: its empty slots hold
  0xFFFFFFFF, so a landing whose disc is 0xFFFFFFFF hits any row that has
  an empty slot (a false positive of P = 2^-32 a key, which the checker
  rejects).

Geometry, as the scan defines it (S = 2w, N offsets a job, T jobs an
epoch in ``phases`` groups): job g has center index c_g = g(2N+1) + N and
center M_g = Q0 - c_g*S*G, Q0 = Q - pk*G; offset O_j = j*S*G, j = 1..N.
A point's probe key is taken from the low 64 bits of its x: the top
``htsz`` bits are the bucket, the next 32 the disc. The hint's low byte is
r & 0xFF and its high byte the (up to) 8 bits below the disc.

Imports nothing but the standard library and this folder.
"""

from __future__ import annotations

import dataclasses

from . import secp256k1 as ec

MASK64 = (1 << 64) - 1
EMPTY = 0xFFFFFFFF  # an empty table slot


@dataclasses.dataclass(frozen=True)
class Geometry:
    w: int
    htsz: int
    n_offsets: int
    jobs_per_epoch: int
    epoch_phases: int

    @property
    def stride(self) -> int:
        return 2 * self.w

    @property
    def phases(self) -> int:
        p = max(1, self.epoch_phases)
        return p if self.jobs_per_epoch % p == 0 else 1


def probe_key(x: int, htsz: int) -> tuple[int, int]:
    pre = x & MASK64
    return pre >> (64 - htsz), (pre >> (32 - htsz)) & 0xFFFFFFFF


def hint(x: int, htsz: int, r: int) -> int:
    spare = 32 - htsz
    take = min(8, max(0, spare))
    extra = ((x & MASK64) >> (spare - take)) & ((1 << take) - 1)
    return (extra << 8) | (r & 0xFF)


def decode_flat(flat: int, geo: Geometry) -> tuple[int, int, int]:
    """A hit index -> (code, t, j): the epoch's probe space is, for each
    phase of T/phases jobs, three blocks of (T/phases)*N lanes (landing
    M + O_j, landing M - O_j, exact M == +-O_j), then the T centers. Codes:
    1, 2, 4 for the three blocks, 5 for a center (j = 0)."""
    n, per = geo.n_offsets, geo.jobs_per_epoch // geo.phases
    block = per * n
    if flat >= geo.phases * 3 * block:
        return 5, flat - geo.phases * 3 * block, 0
    p, rem = divmod(flat, 3 * block)
    code_i, rem = divmod(rem, block)
    t_local, j = divmod(rem, n)
    return (1, 2, 4)[code_i], p * per + t_local, j + 1


class Judge:
    def __init__(self, geo: Geometry):
        self.geo = geo
        self.comb = ec.CombG()
        self._q0: dict = {}
        self._offsets: dict = {}

    def q0(self, pub, pk: int):
        key = (pub, pk)
        if key not in self._q0:
            self._q0[key] = ec.sub(pub, self.comb.mul(pk))
        return self._q0[key]

    def giant(self, q0, m: int):
        """Q0 - m*S*G, the point whose x a giant index m lands on."""
        return ec.sub(q0, self.comb.mul(m * self.geo.stride))

    def center_index(self, job: int) -> int:
        n = self.geo.n_offsets
        return job * (2 * n + 1) + n

    def offset(self, j: int):
        if j not in self._offsets:
            self._offsets[j] = self.comb.mul(j * self.geo.stride)
        return self._offsets[j]

    # -- solves ----------------------------------------------------------
    @staticmethod
    def wrong_keys(answers) -> int:
        """answers: (returned key or None, expected key or None) pairs."""
        return sum(1 for got, want in answers if got != want)

    # -- table -----------------------------------------------------------
    def table_expectations(self, rs):
        """For baby indices rs: (bucket, disc, hint) each must be stored
        under."""
        out = []
        for r, pt in zip(rs, self.comb.mul_many(rs)):
            b, d = probe_key(pt[0], self.geo.htsz)
            out.append((b, d, hint(pt[0], self.geo.htsz, r)))
        return out

    @staticmethod
    def table_misses(expect, rows, lens, hints=None) -> int:
        """rows[i] (uint32 slots), lens[i] (entries) and hints[i] (uint16
        slots, rescan tables only) are the program's row of expect[i]'s
        bucket: count the baby points not stored among its first lens[i]
        slots, and the rows whose slots past them are not all empty
        (0xFFFFFFFF)."""
        miss = 0
        for i, (_, disc, hnt) in enumerate(expect):
            n = min(int(lens[i]), len(rows[i]))
            ok = any(int(rows[i][s]) == disc
                     and (hints is None or int(hints[i][s]) == hnt)
                     for s in range(n))
            empty = all(int(v) == EMPTY for v in rows[i][n:])
            miss += (not ok) + (not empty)
        return miss

    # -- epoch landing keys ----------------------------------------------
    def lane_keys(self, pub, pk: int, job: int, j: int):
        """(bucket+, disc+, bucket-, disc-, exact) of lane (job, j), or None
        where the job's center is the point at infinity."""
        m = self.giant(self.q0(pub, pk), self.center_index(job))
        if m is None:
            return None
        o = self.offset(j)
        if m[0] == o[0]:
            return (None, None, None, None, 1)
        xp = ec.add(m, o)[0]
        xm = ec.sub(m, o)[0]
        return probe_key(xp, self.geo.htsz) + probe_key(xm, self.geo.htsz) \
            + (0,)

    def landing_key_errors(self, pub, pk: int, jobs, js, got) -> int:
        """got[k] = the program's (bucket+, disc+, bucket-, disc-, exact)
        of lane (jobs[k], js[k]), as uint32 values. An exact lane is
        judged by its flag alone (its keys are not defined)."""
        errs = 0
        for job, j, row in zip(jobs, js, got):
            want = self.lane_keys(pub, pk, job, j)
            if want is None:
                continue
            if want[4]:
                errs += int(row[4]) == 0
            else:
                errs += tuple(int(v) for v in row) != want
        return errs

    # -- probe hits ------------------------------------------------------
    def hit_claims(self, pub, pk: int, job_base: int, flat: int):
        """What hit ``flat`` of the epoch whose first job is job_base
        claims: ('row', bucket, disc) for a landing or center the table's
        row must hold, ('exact', ok) for an exact landing, ('inf', True)
        for a center at infinity."""
        code, t, j = decode_flat(flat, self.geo)
        q0 = self.q0(pub, pk)
        c = self.center_index(job_base + t)
        if code == 4:
            m = self.giant(q0, c)
            return ("exact", m is not None and m[0] == self.offset(j)[0])
        idx = {1: c - j, 2: c + j, 5: c}[code]
        pt = self.giant(q0, idx)
        if pt is None:
            return ("inf", code == 5)
        return ("row",) + probe_key(pt[0], self.geo.htsz)

    @staticmethod
    def unjustified_hits(claims, rows) -> int:
        """claims from hit_claims; rows[i]: the program's whole table row
        (uint32 slots, empty ones included) for claim i, ignored unless
        the claim is a row."""
        bad = 0
        for claim, row in zip(claims, rows):
            if claim[0] != "row":
                bad += not claim[1]
            else:
                bad += not any(int(v) == claim[2] for v in row)
        return bad
