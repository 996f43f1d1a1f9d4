"""The port's command line end to end on the CPU (``main(argv,
device="cpu")``, the kernels' plain versions) at tests/test_torch_solver.py's
tiny geometry: planted keys to the win file, --infile, --resume and its
refusals (the pubkey binding the JAX resume lacks, another card count),
--gen-only, --tune, any jobs per epoch, special hit codes; and the flag
surface against the JAX CLI's. Formats are compared through
the two packages' codecs and checkpoint modules: no JAX solve runs here.
Most runs take --jobs-per-epoch 2 and --pipeline 1 (one inversion an
epoch, no epoch queued past a found key): a CPU epoch costs a plain
a^(p-2) chain per phase."""

import json
import os
import subprocess
import sys

import pytest
import torch

from bsgs_tpu import cli as jcli
from bsgs_tpu.utils import artifacts as JA, codecs as jcodecs
from bsgs_tpu_torch import cli
from bsgs_tpu_torch.utils import checkpoint as ckpt, codecs, ecpy, tuner

torch.set_num_threads(2)

GEOM = ["--w", "8", "--htsz", "6", "--n-offsets", "8"]
QUICK = GEOM + ["--jobs-per-epoch", "2", "--pipeline", "1"]
STRIDE = 2 * 256
KPE = 2 * 17 * STRIDE  # keys per epoch at 2 jobs of 2N+1 = 17 landings
PK = 1 << 20
PKE = PK + 6 * KPE - 1  # 7 epochs


def pub(k, compressed=True):
    return codecs.format_pubkey(ecpy.mul(k), compressed)


@pytest.fixture
def run(tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)

    def _run(*argv):
        rc = cli.main(list(argv), device="cpu")
        out, err = capsys.readouterr()
        return rc, out, err

    return _run


def win_lines():
    with open("win.txt") as f:
        return f.read().splitlines()


def test_planted_key_goes_to_the_win_file(run):
    k = 0xCAFE5
    rc, out, _ = run("--pub", pub(k, compressed=False), "--pk", "c0000",
                     "--pke", "d0000", *GEOM)
    assert rc == 0 and "KEY FOUND: 0xcafe5" in out
    line = f"{k:064x} {pub(k)}"
    assert win_lines() == [line]
    assert line == f"{k:064x} {jcodecs.format_pubkey(ecpy.mul(k))}"
    ck = ckpt.Checkpoint.load("currentwork.json")
    assert (ck.pub_index, ck.pubkey, ck.next_epoch) == (1, "", 0)
    # a fresh start clears the win file; a miss leaves it empty
    rc, out, _ = run("--pub", pub(k), "--pk", "d0000", "--pke", "d1000",
                     *QUICK)
    assert rc == 0 and "exhausted range" in out and not os.path.exists(
        "win.txt")


def test_infile_skips_a_garbage_line(run, tmp_path):
    keys = (PK + 1000, PK + 3 * STRIDE + 7)
    (tmp_path / "pubs.txt").write_text(
        f"{pub(keys[0])}\nnot a pubkey\n\n{pub(keys[1], False)}\n")
    rc, out, err = run("--infile", "pubs.txt", "--pk", f"{PK:x}",
                       "--pke", f"{PKE:x}", *QUICK)
    assert rc == 0 and "skipping pubkey #1" in err
    assert win_lines() == [f"{k:064x} {pub(k)}" for k in keys]
    assert "done: 2/3 keys" in out


def test_resume_mid_scan_and_its_refusals(run):
    a, b = PK + 999, PK + 4 * KPE + 1234  # epochs 0 and 4
    rng = ["--pk", f"{PK:x}", "--pke", f"{PKE:x}", "--checkpoint-interval",
           "0"]
    rc, out, _ = run("--pub", pub(a), *rng, *QUICK)
    assert rc == 0 and "epoch 1/7" not in out  # found before a callback
    fp = ckpt.Checkpoint.load("currentwork.json").fingerprint

    def checkpoint(index, entry, epoch, path="cw.json"):
        ckpt.CheckpointWriter(path, fp, 0.0).maybe_write(
            index, ckpt.pubkey_id(entry), epoch, 0)
        return path

    # resumed at epoch 3, b's key (epoch 4) is found after one callback
    rc, out, _ = run("--pub", pub(b, False), "--resume",
                     checkpoint(0, pub(b), 3), *rng, *QUICK)
    assert rc == 0 and "resuming at pubkey #0, epoch 3" in out
    assert "epoch 4/7" in out and "epoch 3/7" not in out
    assert win_lines() == [f"{k:064x} {pub(k)}" for k in (a, b)]
    # resumed past it, the scan cannot find it
    rc, out, _ = run("--pub", pub(b), "--resume", checkpoint(0, pub(b), 5),
                     *rng, *QUICK)
    assert rc == 0 and "exhausted range" in out and "epoch 6/7" in out
    # another geometry, another pubkey: refused before any build
    for argv in (["--pub", pub(b)] + rng + QUICK[:1] + ["9"] + QUICK[2:],
                 ["--pub", pub(a)] + rng + QUICK):
        rc, out, err = run(*argv, "--resume", checkpoint(0, pub(b), 3))
        assert rc == 2 and "cannot resume" in err and "building" not in out
    assert "pubkey mismatch" in err


def test_resume_at_a_boundary(run, tmp_path):
    a, b, c = PK + 5, PK + KPE + 6, PK + 7
    rng = ["--pk", f"{PK:x}", "--pke", f"{PK + 2 * KPE - 1:x}"]
    (tmp_path / "ab.txt").write_text(f"{pub(a)}\n{pub(b)}\n")
    (tmp_path / "ac.txt").write_text(f"{pub(a)}\n{pub(c)}\n")
    rc, _, _ = run("--infile", "ab.txt", *rng, *QUICK, "--quiet")
    fp = ckpt.Checkpoint.load("currentwork.json").fingerprint
    w = ckpt.CheckpointWriter("cw.json", fp, 0.0)
    # the checkpoint after a's scan names the next entry, b
    w.maybe_write(1, ckpt.pubkey_id(pub(b)), 0, 0)
    os.unlink("win.txt")  # a resume appends to the win file
    rc, out, _ = run("--infile", "ab.txt", "--resume", "cw.json", *rng,
                     *QUICK)
    assert rc == 0 and "resuming at pubkey #1" in out
    assert win_lines() == [f"{b:064x} {pub(b)}"]  # a was not searched
    rc, _, err = run("--infile", "ac.txt", "--resume", "cw.json", *rng,
                     *QUICK)
    assert rc == 2 and "pubkey mismatch at pubkey #1" in err
    # the JAX CLI names no pubkey at a boundary: nothing to bind, refused
    w.maybe_write(1, "", 0, 0)
    rc, _, err = run("--infile", "ab.txt", "--resume", "cw.json", *rng,
                     *QUICK)
    assert rc == 2 and "no entry" in err


def test_gen_only_writes_and_verifies_the_artifact(run):
    argv = ["--gen-only", "--w", "8", "--htsz", "6", "--window", "16",
            "--cache-dir", "cache"]
    rc, out, _ = run(*argv)
    assert rc == 0 and "generating artifact" in out and "finished ok" in out
    path = JA.baby_table_path("cache", 256, 6)
    assert os.path.exists(path)
    rc, out, _ = run(*argv)
    assert rc == 0 and "verifying artifact" in out and "256 entries" in out
    jt = JA.load_baby_table(path)  # the JAX package reads it too
    assert jt.lookup_positions(ecpy.mul(99)[0]) == [99]


def test_tune_with_a_memory_size(run, monkeypatch):
    monkeypatch.setattr(tuner, "device_memory_bytes", lambda dev: 80 << 30)
    rc, out, _ = run("--tune")
    assert rc == 0 and out.startswith("device cpu")
    t = tuner.tune(mem_bytes=80 << 30)
    assert f"suggested: {t.flags()}\n" in out
    rc, out, _ = run("--tune", "--pk", "1", "--pke", "3ffffffff")
    assert "--w 131072 " in out


@pytest.mark.parametrize("flags", [["--devices", "2"], ["--shard-table"],
                                   ["--device-ids", "0,1"], ["-d", "1,2"]])
def test_flags_for_several_cards_exit_2(run, flags):
    """A scan checkpointed on one card is not resumed on several, nor with
    the table sharded: the card count and the sharding are in the
    fingerprint, as in the JAX CLI (bsgs_tpu/cli.py:193-197). The runs on
    several ranks are tests/test_torch_distributed_cli.py."""
    argv = ("--pub", pub(PK + 3), "--pk", f"{PK:x}", "--pke",
            f"{PK + 100:x}", *QUICK)
    assert run(*argv)[0] == 0
    rc, _, err = run(*argv, *flags, "--resume", "currentwork.json")
    assert rc == 2 and "cannot resume" in err and "fingerprint" in err


@pytest.mark.parametrize("flags, says", [
    (["-d", "0,0"], "repeat"), (["--device-ids", "1,2,1"], "repeat"),
    (["--devices", "2", "--shard-table", "--positions", "mirror"],
     "rescan positions only")])
def test_cards_that_cannot_be_given_exit_2(run, flags, says):
    """No card takes two ranks, and a table split over several cards holds
    no position plane: refused before any rank starts."""
    rc, _, err = run("--pub", pub(PK + 3), "--pk", f"{PK:x}", "--pke",
                     f"{PK + 100:x}", *QUICK, *flags)
    assert rc == 2 and says in err


def test_n_without_a_chain_layout_solves_unfused(run):
    """--n-offsets 65537 at 16 jobs (4 a phase) has no chain layout
    (solver.chain_layout): the command line solves it through the unfused
    epoch, as the JAX command line does."""
    rc, out, _ = run("--pub", pub(5), "--pk", "1", "--pke", "ffff", "--w",
                     "8", "--n-offsets", "65537")
    assert rc == 0 and "KEY FOUND: 0x5" in out
    assert win_lines() == [f"{5:064x} {pub(5)}"]


def test_offsets_that_are_no_power_of_two(run):
    """N=12 takes chains of 4 x 1 (solver.chain_layout)."""
    k = PK + 5 * 25 * STRIDE + 3  # job 5
    rc, out, _ = run("--pub", pub(k), "--pk", f"{PK:x}", "--pke",
                     f"{PK + 8 * 25 * STRIDE:x}", "--w", "8", "--htsz", "6",
                     "--n-offsets", "12", "--jobs-per-epoch", "3",
                     "--pipeline", "1")
    assert rc == 0 and win_lines() == [f"{k:064x} {pub(k)}"]


def test_128_jobs_per_epoch(run):
    k = PK + 100 * 17 * STRIDE + 321  # job 100 of epoch 0
    rc, out, _ = run("--pub", pub(k), "--pk", f"{PK:x}",
                     "--pke", f"{PK + (1 << 20):x}", *GEOM,
                     "--jobs-per-epoch", "128")
    assert rc == 0 and win_lines() == [f"{k:064x} {pub(k)}"]


def test_center_landing_and_range_edges(run, tmp_path):
    pke = PK + 20000
    keys = (PK + 8 * STRIDE, PK, pke)  # a job center (hit code 5), pk, pke
    (tmp_path / "p.txt").write_text("".join(f"{pub(k)}\n" for k in keys))
    rc, out, _ = run("--infile", "p.txt", "--pk", f"{PK:x}", "--pke",
                     f"{pke:x}", *QUICK)
    assert rc == 0 and win_lines() == [f"{k:064x} {pub(k)}" for k in keys]


def test_flags_match_the_jax_cli():
    def options(parser):
        return {s for a in parser._actions for s in a.option_strings}

    assert options(cli.build_parser()) == options(jcli.build_parser())
    assert cli.rate_exponent(2 ** 57.3 / 2 ** 31, 1 << 30) == \
        jcli.rate_exponent(2 ** 57.3 / 2 ** 31, 1 << 30) == 57
    defaults = cli.build_parser().parse_args([])
    assert defaults.jobs_per_epoch is None  # SolverConfig's 16 applies


def test_command_line_needs_a_card(tmp_path):
    env = dict(os.environ, PYTHONPATH=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    help_ = subprocess.run([sys.executable, "-m", "bsgs_tpu_torch.cli",
                            "--help"], capture_output=True, text=True,
                           cwd=tmp_path, env=env, timeout=120)
    assert help_.returncode == 0
    for flag in ("--n-split", "--verify-defer-epochs", "--positions",
                 "--resume", "--gen-only", "--tune", "--device-ids"):
        assert flag in help_.stdout
    if torch.cuda.is_available():
        return
    r = subprocess.run([sys.executable, "-m", "bsgs_tpu_torch.cli", "--pub",
                        pub(5), "--pk", "1", "--pke", "ff"],
                       capture_output=True, text=True, cwd=tmp_path, env=env,
                       timeout=120)
    assert r.returncode != 0 and "no CUDA device" in r.stderr
    logs = list(tmp_path.glob("*_error_log.txt"))
    assert len(logs) == 1 and "no CUDA device" in logs[0].read_text()


def test_crash_log_keeps_the_traceback(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)

    def boom(argv=None, device=None):
        raise OSError("disk gone")

    monkeypatch.setattr(cli, "main", boom)
    with pytest.raises(OSError):
        cli._main_with_crashlog([])
    (log,) = tmp_path.glob("*_error_log.txt")
    assert "disk gone" in log.read_text()


def test_checkpoint_json_is_the_jax_format(run):
    rc, _, _ = run("--pub", pub(PK + 3), "--pk", f"{PK:x}", "--pke",
                   f"{PK + 100:x}", *QUICK)
    with open("currentwork.json") as f:
        d = json.load(f)
    from bsgs_tpu.utils import checkpoint as jckpt

    assert set(d) == set(jckpt.Checkpoint.__dataclass_fields__)
