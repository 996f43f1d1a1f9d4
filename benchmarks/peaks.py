"""The card's peaks and the work the algorithm needs, counted from shapes.

Nothing here is read from compiled code: the counts are the algorithm's,
so a kernel's share of its roofline reads the same work whatever
implements it.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet: HBM3 bandwidth.
HBM_BYTES_PER_S = 3.35e12
# The 32-bit multiplier pipe: 132 SMs x 64 lanes a clock x 1.98 GHz boost
# (published SM count and clock); a 32 x 32 -> 64-bit product is two of its
# issues (low and high halves).
MUL_PIPE_PER_S = 132 * 64 * 1.98e9

# A field element of secp256k1's p is 8 limbs of 32 bits, 32 bytes.
LIMBS = 8
ELEM_BYTES = 32
# Schoolbook product of two elements: LIMBS^2 wide products; a square
# LIMBS(LIMBS+1)/2. Reduction mod p = 2^256 - 2^32 - 977 folds the high
# half times 2^32 + 977: LIMBS wide products by 977 (the 2^32 is a shift),
# then one more for the word that carries out. Each wide product is two
# 32-bit products.
MUL_WIDE = LIMBS * LIMBS
SQR_WIDE = LIMBS * (LIMBS + 1) // 2
REDUCE_WIDE = LIMBS + 1
FIELD_MUL = 2 * (MUL_WIDE + REDUCE_WIDE)  # 146 32-bit products
FIELD_SQR = 2 * (SQR_WIDE + REDUCE_WIDE)  # 90

# Per (job, offset) pair of an epoch, the x of M + O and of M - O from one
# shared inverse of Ox - Mx (Montgomery's batch trick), the backward pass
# takes the pair's inverse and the running product's next value (2
# multiplies), the two slopes (2 multiplies) and their squares (2
# squares). The inversion of the chain totals is not counted.
BWD_PAIR_PRODUCTS = 4 * FIELD_MUL + 2 * FIELD_SQR


def bwd_bytes(jobs: int, n: int, chunk_c: int) -> int:
    """Bytes the backward pass must move for jobs x n pairs: the offsets'
    x and y, the centers' x and y, the forward prefixes (one an element)
    and the inverted chain totals (one a chain) read once at ELEM_BYTES an
    element, and the (8, jobs*n) int32 key plane written once."""
    tn = jobs * n
    return ELEM_BYTES * (2 * n + 2 * jobs + tn + tn // chunk_c) + 32 * tn


def bwd_seconds(jobs: int, n: int, chunk_c: int) -> float:
    """The least time the backward pass can take: the larger of its bytes
    over HBM and its 32-bit products over the multiplier pipe."""
    return max(bwd_bytes(jobs, n, chunk_c) / HBM_BYTES_PER_S,
               jobs * n * BWD_PAIR_PRODUCTS / MUL_PIPE_PER_S)


def probe_bytes_per_key(row_len_counts: dict, len_bytes: int) -> float:
    """Bytes one probe needs, averaged over a uniform bucket (a landing's
    x bits are uniform): its 8-byte key and its row's length read, one
    found byte written, and the 32-byte sectors of the row's occupied
    4-byte slots read. row_len_counts: {entries in a row: rows with that
    many}."""
    rows = sum(row_len_counts.values())
    sectors = sum(c * ((4 * n + 31) // 32) for n, c in row_len_counts.items())
    return 9 + len_bytes + 32 * sectors / rows
