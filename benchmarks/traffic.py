"""The one traffic generator: pubkeys and ranges from a mix's parameters
and the run's seed.

A mix (``traffic/<name>.json``) gives:

- ``bits`` b: every range is the puzzle range [2^(b-1), 2^b - 1];
- ``out_of_range_share`` s: a share s of the pubkeys, at fixed places in
  the sequence (every 1/s-th one for s = 1/4; all for s = 1), have their
  key uniform in [2^b, 2^(b+1)), so their solve exhausts the range and
  finds nothing;
- ``prepare``: how many requests set-up makes before the window (the
  window makes more, from the same stream, should it use them all).

In-range keys are uniform in the range, but placed along a Weyl sequence
(start drawn from the seed, step 2^128 / golden ratio), so any run of
consecutive requests covers the range evenly: every seed gives nearly the
same set of solve lengths in another arrangement, and the work of a
window does not hang on the seed. The program receives only the pubkey
and the range; the keys stay here, for the judge.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from .reference import secp256k1 as ec

# floor(2^128 / golden ratio)
WEYL_STEP = 0x9E3779B97F4A7C15F39CC0605CEDC834


@dataclasses.dataclass(frozen=True)
class Request:
    pub: tuple
    pk: int
    pke: int
    key: int
    in_range: bool

    @property
    def expected(self):
        return self.key if self.in_range else None


def load(root: Path, name: str) -> dict:
    return json.loads((Path(root) / "benchmarks" / "traffic"
                       / f"{name}.json").read_text())


def rng_of(seed: int, stream: int) -> np.random.Generator:
    """Any whole seed (negative or above 64 bits too), one stream each."""
    s = int(seed)
    words = [(abs(s) >> (32 * i)) & 0xFFFFFFFF for i in range(4)]
    return np.random.default_rng([stream, int(s < 0)] + words)


def _u128(rng) -> int:
    return int.from_bytes(rng.bytes(16), "little")


class Generator:
    def __init__(self, params: dict, seed: int, comb=None):
        self.bits = int(params["bits"])
        self.share = float(params.get("out_of_range_share", 0.0))
        if not 1 <= self.bits <= 250 or not 0.0 <= self.share <= 1.0:
            raise ValueError(f"traffic parameters out of range: {params}")
        self.rng = rng_of(seed, 1)
        self.start = _u128(self.rng)
        self.comb = comb or ec.CombG()
        self.index = 0
        self.in_count = 0

    @property
    def pk(self) -> int:
        return 1 << (self.bits - 1)

    @property
    def pke(self) -> int:
        return (1 << self.bits) - 1

    def _out_of_range(self, i: int) -> bool:
        return int((i + 1) * self.share) > int(i * self.share)

    def _key(self, i: int) -> tuple[int, bool]:
        span = self.pk  # keys in [pk, pke]: 2^(b-1) of them
        if self._out_of_range(i):
            return (1 << self.bits) + _u128(self.rng) % (1 << self.bits), False
        u = (self.start + self.in_count * WEYL_STEP) % (1 << 128)
        self.in_count += 1
        fine = _u128(self.rng)
        return self.pk + (((u << 128) | fine) * span >> 256), True

    def take(self, count: int) -> list[Request]:
        keys = [self._key(self.index + i) for i in range(count)]
        self.index += count
        pubs = self.comb.mul_many([k for k, _ in keys])
        return [Request(pub, self.pk, self.pke, k, inside)
                for pub, (k, inside) in zip(pubs, keys)]

    def warmup(self, fraction: float = 0.001) -> Request:
        """A key early in the range (at ``fraction`` of it), drawn from its
        own stream: set-up solves it to warm every path a window takes
        (epochs, verification, a residue scan) without waiting for a whole
        range."""
        head = max(1, int(self.pk * fraction))
        k = self.pk + _u128(rng_of(self.bits, 2)) % head
        return Request(self.comb.mul(k), self.pk, self.pke, k, True)
