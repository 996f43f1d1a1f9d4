"""SEC1 public-key codecs and hex helpers (host-side): a copy of
``bsgs_tpu/utils/codecs.py``.

Equivalent of the reference's pubkey normalization paths
(commpressed2uncomressedPub / uncomressed2commpressedPub,
1_9_7File.pb:274-323, and the -infile normalizer at :4370-4386): accepts
compressed (02/03 + X), uncompressed (04 + X + Y), and bare 128-hex-char
X||Y forms.
"""

from __future__ import annotations

from . import ecpy


class PubkeyError(ValueError):
    pass


def parse_pubkey(s: str) -> tuple:
    """Hex pubkey string -> affine point (x, y). Raises PubkeyError."""
    s = s.strip().lower().removeprefix("0x")
    if not s or any(c not in "0123456789abcdef" for c in s):
        raise PubkeyError(f"not hex: {s[:40]!r}")
    if len(s) == 66 and s[:2] in ("02", "03"):
        x = int(s[2:], 16)
        y = ecpy.y_from_x(x, odd=(s[:2] == "03"))
        if y is None:
            raise PubkeyError("X not on curve")
        return (x, y)
    if len(s) == 130 and s[:2] == "04":
        s = s[2:]
    if len(s) == 128:
        x, y = int(s[:64], 16), int(s[64:], 16)
        pt = (x, y)
        if not ecpy.is_on_curve(pt):
            raise PubkeyError("point not on curve")
        return pt
    raise PubkeyError(f"unrecognized pubkey length {len(s)}")


def format_pubkey(pt: tuple, compressed: bool = True) -> str:
    x, y = pt
    if compressed:
        return ("03" if y & 1 else "02") + f"{x:064x}"
    return "04" + f"{x:064x}" + f"{y:064x}"


def parse_scalar(s: str) -> int:
    """Range bound: hex (with or without 0x). The reference reads -pk/-pke
    as hex (README.md:9-10)."""
    s = s.strip().lower().removeprefix("0x")
    return int(s, 16)


def parse_w(s: str) -> int:
    """-w accepts an exponent ('26' -> 2^26) or a decimal count with a
    dot-free heuristic like the reference (1_9_7File.pb:980-1002: values
    <= 64 are exponents, fractional exponents allowed)."""
    v = float(s)
    if v <= 64:
        return int(round(2 ** v))
    return int(v)
