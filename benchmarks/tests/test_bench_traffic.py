"""The traffic generator: the same seed gives the same requests, and the
keys fall where their mix says."""

import pytest

from benchmarks import harness, traffic
from benchmarks.reference import secp256k1 as ec


def _gen(params, seed):
    return traffic.Generator(params, seed)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 5, 2**40 + 3, -12])
def test_same_seed_same_requests(seed):
    params = {"bits": 40, "out_of_range_share": 0.25}
    a = _gen(params, seed).take(12)
    b = _gen(params, seed).take(12)
    assert a == b
    assert _gen(params, seed + 1).take(12) != a


def test_keys_fall_where_the_mix_says():
    bits = 30
    reqs = _gen({"bits": bits, "out_of_range_share": 0.25}, 99).take(40)
    for i, r in enumerate(reqs):
        assert (r.pk, r.pke) == (1 << (bits - 1), (1 << bits) - 1)
        assert r.pub == ec.mul(r.key)
        if i % 4 == 3:
            assert not r.in_range and r.expected is None
            assert 1 << bits <= r.key < 1 << (bits + 1)
        else:
            assert r.in_range and r.expected == r.key
            assert r.pk <= r.key <= r.pke


def test_in_range_keys_cover_the_range_evenly():
    bits, n = 64, 32
    for seed in (1, 2, 3):
        reqs = _gen({"bits": bits}, seed).take(n)
        assert all(r.in_range for r in reqs)
        bins = [0] * n
        for r in reqs:
            bins[(r.key - r.pk) * n >> (bits - 1)] += 1
        assert max(bins) <= 2  # a Weyl sequence: no bin holds three


def test_stream_continues_past_prepare():
    params = {"bits": 20, "out_of_range_share": 0.25}
    g = _gen(params, 5)
    joined = g.take(5) + g.take(7)
    assert joined == _gen(params, 5).take(12)


def test_warmup_is_early_and_fixed():
    g = _gen({"bits": 68}, 1)
    w = g.warmup()
    assert w.in_range and w.key - w.pk <= (w.pk >> 10)
    assert _gen({"bits": 68}, 2).warmup() == w


@pytest.mark.parametrize("name", ["puzzle_b68", "puzzle_b64"])
def test_benchmark_traffic_files_generate(name):
    params = traffic.load(harness.ROOT, name)
    reqs = _gen(params, 3).take(4)
    assert all(r.pub == ec.CombG().mul(r.key) for r in reqs)


def test_every_key_out_of_range():
    reqs = _gen({"bits": 70, "out_of_range_share": 1.0}, 4).take(3)
    assert not any(r.in_range for r in reqs)


@pytest.mark.parametrize("bad", [{"bits": 0}, {"bits": 300},
                                 {"bits": 20, "out_of_range_share": 1.5}])
def test_bad_parameters_are_refused(bad):
    with pytest.raises(ValueError):
        _gen(bad, 1)
