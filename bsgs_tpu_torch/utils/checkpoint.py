"""Checkpoint / resume of long range scans.

Counterpart of ``bsgs_tpu/utils/checkpoint.py``, with the same JSON keys
and fingerprint: periodically persist (pubkey-list position, pubkey,
progress counter, config fingerprint) atomically via temp+rename, refuse
to resume when the fingerprint of the solver geometry changed, and restart
from the first epoch not fully completed (the reference's currentwork.txt,
saveCurentCNT, 1_9_7File.pb:3897-3931; recovery :4634-4686).

Unlike the JAX package's, a checkpoint is bound to its pubkey: ``pubkey``
always names the entry of the pubkey stream at ``pub_index`` (the one the
resume starts at, mid-scan or at a boundary), by ``pubkey_id``, and
``Checkpoint.bind`` refuses a stream whose entry there is another one. A
checkpoint written past the stream's last entry names "" (no entry).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import tempfile
import time
from typing import Optional

from . import codecs


def config_fingerprint(**params) -> str:
    """Stable SHA1 over the geometry parameters, like the reference's SHA1
    over (t,b,p,w,pk,pke,htsz) (1_9_7File.pb:3915-3917)."""
    blob = json.dumps(params, sort_keys=True).encode()
    return hashlib.sha1(blob).hexdigest()


def pubkey_id(entry: Optional[str]) -> str:
    """How a checkpoint names an entry of the pubkey stream: the compressed
    hex of its point (any accepted form of one point gives one name), the
    stripped lowercase text of an entry that does not parse, "" for no
    entry."""
    if entry is None:
        return ""
    try:
        return codecs.format_pubkey(codecs.parse_pubkey(entry))
    except codecs.PubkeyError:
        return entry.strip().lower()


@dataclasses.dataclass
class Checkpoint:
    fingerprint: str
    pub_index: int  # position in the multi-pubkey input list
    pubkey: str  # pubkey_id of the stream's entry at pub_index
    next_epoch: int  # first epoch NOT fully completed
    giant_steps: int
    wall_s: float
    ts: float = 0.0

    def save(self, path: str) -> None:
        self.ts = time.time()
        d = os.path.dirname(path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(dataclasses.asdict(self), f)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    @classmethod
    def load(cls, path: str, fingerprint: Optional[str] = None):
        with open(path) as f:
            d = json.load(f)
        ck = cls(**d)
        if fingerprint is not None and ck.fingerprint != fingerprint:
            raise ValueError(
                "checkpoint fingerprint mismatch — solver geometry changed "
                f"({ck.fingerprint} != {fingerprint})"
            )
        return ck

    def bind(self, entry: Optional[str]) -> None:
        """Refuse to resume unless ``entry``, this run's pubkey stream at
        pub_index (None past its end), is the pubkey the checkpoint
        names."""
        got = pubkey_id(entry)
        if got != self.pubkey:
            raise ValueError(
                f"checkpoint pubkey mismatch at pubkey #{self.pub_index}: "
                f"it names {self.pubkey or 'no entry'!r}, this run's stream "
                f"has {got or 'no entry'!r}"
            )


class CheckpointWriter:
    """Rate-limited checkpoint emitter (reference -wt interval, floor 30 s
    relaxed here to any interval; default 180 s like the reference)."""

    def __init__(self, path: str, fingerprint: str, interval_s: float = 180.0):
        self.path = path
        self.fingerprint = fingerprint
        self.interval_s = interval_s
        self._last = 0.0
        self._t0 = time.time()

    def maybe_write(self, pub_index: int, pubkey: str, next_epoch: int,
                    giant_steps: int, force: bool = False) -> bool:
        now = time.time()
        if not force and now - self._last < self.interval_s:
            return False
        Checkpoint(
            fingerprint=self.fingerprint,
            pub_index=pub_index,
            pubkey=pubkey,
            next_epoch=next_epoch,
            giant_steps=giant_steps,
            wall_s=now - self._t0,
        ).save(self.path)
        self._last = now
        return True
