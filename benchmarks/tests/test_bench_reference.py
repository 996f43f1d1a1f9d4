"""The reference curve and the judge."""

import random

import pytest

from benchmarks.reference import bsgs as ref
from benchmarks.reference import secp256k1 as ec

G2 = (0xC6047F9441ED7D6D3045406E95C07CD85C778E4B8CEF3CA7ABAC09B95C709EE5,
      0x1AE168FEA63DC339A3C58419466CEAEEF7F632653266D0E1236431A950CFE52A)
G3 = (0xF9308A019258C31049344F85F89D5229B531C845836F99B08601F113BCE036F9,
      0x388F7B0F632DE8140FE337E62A37F3566500A99934C2231B6CB9FD7584B8E672)
# bitcoin puzzle #64: its key and its compressed pubkey
PUZZLE64 = (0xF7051F27B09112D4,
            "03100611c54dfef604163b8358f7b7fac13ce478e02cb224ae16d45526b25d9d4d")


def test_known_vectors():
    comb = ec.CombG()
    assert ec.is_on_curve(ec.G)
    assert ec.dbl(ec.G) == G2 == comb.mul(2) == ec.mul(2)
    assert ec.add(G2, ec.G) == G3 == comb.mul(3)
    assert comb.mul(ec.N - 1) == ec.neg(ec.G)
    assert comb.mul(ec.N) is None and ec.add(ec.G, ec.neg(ec.G)) is None
    key, pub = PUZZLE64
    assert ec.encode_pubkey(comb.mul(key)) == pub
    assert ec.encode_pubkey(ec.mul(key)) == pub


@pytest.mark.parametrize("bits", [1, 8, 33, 70, 256])
def test_comb_matches_double_and_add(bits):
    rnd = random.Random(bits)
    comb = ec.CombG()
    ks = [rnd.getrandbits(bits) or 1 for _ in range(6)]
    assert comb.mul_many(ks) == [ec.mul(k) for k in ks]


def test_batch_affine_keeps_infinity():
    comb = ec.CombG()
    pts = [comb.mul_jacobian(k) for k in (5, ec.N, 7)]
    assert ec.to_affine_batch(pts) == [ec.mul(5), None, ec.mul(7)]


def test_host_control_runs():
    assert ec.host_additions(50) > 0


def test_probe_key_and_hint():
    x = 0x1234_5678_9ABC_DEF0_0FED_CBA9_8765_4321
    pre = 0x0FED_CBA9_8765_4321
    assert ref.probe_key(x, 24) == (pre >> 40, (pre >> 8) & 0xFFFFFFFF)
    assert ref.hint(x, 24, 0x1FF) == ((pre & 0xFF) << 8) | 0xFF
    # htsz 26: 6 spare bits below the disc, all of them in the hint
    assert ref.hint(x, 26, 3) == ((pre & 0x3F) << 8) | 3


def test_decode_flat_layout():
    geo = ref.Geometry(w=256, htsz=6, n_offsets=3, jobs_per_epoch=4,
                       epoch_phases=2)
    flats = {}
    per, n = 2, 3
    for p in range(2):
        for ci, code in enumerate((1, 2, 4)):
            for t in range(per):
                for j in range(1, n + 1):
                    flat = p * 3 * per * n + ci * per * n + t * n + j - 1
                    flats[flat] = (code, p * per + t, j)
    for t in range(4):
        flats[2 * 3 * per * n + t] = (5, t, 0)
    assert sorted(flats) == list(range(len(flats)))
    for flat, want in flats.items():
        assert ref.decode_flat(flat, geo) == want
    one = ref.Geometry(256, 6, 3, 4, 3)  # 3 does not divide 4: one phase
    assert one.phases == 1 and ref.decode_flat(12, one) == (2, 0, 1)


def _judge():
    return ref.Judge(ref.Geometry(w=256, htsz=6, n_offsets=8,
                                  jobs_per_epoch=4, epoch_phases=1))


def test_lane_keys_follow_the_definition():
    J = _judge()
    pub, pk = ec.mul(123457), 1 << 15
    q0 = ec.sub(pub, ec.mul(pk))
    job, j, s = 3, 5, 512
    c = job * 17 + 8
    m = ec.sub(q0, ec.mul(c * s))
    want = (ref.probe_key(ec.add(m, ec.mul(j * s))[0], 6)
            + ref.probe_key(ec.sub(m, ec.mul(j * s))[0], 6) + (0,))
    assert J.lane_keys(pub, pk, job, j) == want
    good = [list(want)]
    assert J.landing_key_errors(pub, pk, [job], [j], good) == 0
    bad = [list(want[:1]) + [want[1] ^ 1] + list(want[2:])]
    assert J.landing_key_errors(pub, pk, [job], [j], bad) == 1


def test_table_misses_and_hits():
    J = _judge()
    (b, d, h), = J.table_expectations([77])
    row = [d ^ 5, d, 0xFFFFFFFF]
    hints = [0, h, 0]
    assert J.table_misses([(b, d, h)], [row], [2], [hints]) == 0
    # stored past the row's length: missed, and the row not empty there
    assert J.table_misses([(b, d, h)], [row], [1], [hints]) == 2
    assert J.table_misses([(b, d, h)], [row], [2], [[0, h ^ 1, 0]]) == 1
    assert J.table_misses([(b, d, h)], [row], [2]) == 0
    # a slot past the row's length that is not empty
    assert J.table_misses([(b, d, h)], [row[:2] + [7]], [2]) == 1
    claims = [("row", b, d), ("row", b, d ^ 1), ("exact", True),
              ("exact", False), ("inf", True), ("row", b, 0xFFFFFFFF)]
    rows = [row, row, [], [], [], row]
    # the whole row is probed: an empty slot answers a 0xFFFFFFFF disc
    assert J.unjustified_hits(claims, rows) == 2
    assert J.unjustified_hits(claims[-1:], [row[:2]]) == 1


def test_hit_claims_name_the_landing():
    J = _judge()
    pub, pk = ec.mul(99999), 1 << 15
    q0 = ec.sub(pub, ec.mul(pk))
    # code 2 (M - O_j) of job 1, offset 3, in an epoch of one phase
    flat = 4 * 8 + 1 * 8 + 2
    c = (10 + 1) * 17 + 8
    pt = ec.sub(q0, ec.mul((c + 3) * 512))
    assert J.hit_claims(pub, pk, 10, flat) == ("row",) + ref.probe_key(
        pt[0], 6)
    assert J.wrong_keys([(5, 5), (None, None), (6, 5), (None, 5)]) == 2
