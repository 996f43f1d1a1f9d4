"""The port's command line with several ranks on the CPU, each rank a
process it spawns itself, joined by gloo: --devices 2 with a replicated and
a sharded table finds a planted key and rank 0 alone writes the win file;
a resume on another card count is refused before any rank starts; a rank
that fails fails the command. Each command runs in a session of its own,
killed whole after a join timeout."""

import json
import os
import signal
import subprocess
import sys

import pytest
import torch

from bsgs_tpu_torch.utils import codecs, ecpy

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JOIN_S = 300
STRIDE, SPAN = 512, 17  # 2w, 2N + 1 at --w 8 --n-offsets 8
PK = 1 << 21
JOBS_SUPER = 4  # 2 ranks x 2 jobs


def _cli(cwd, *argv):
    """cli.main(argv, device="cpu") in a process of its own: (exit code,
    output)."""
    code = ("import sys; from bsgs_tpu_torch import cli; "
            "sys.exit(cli.main(sys.argv[1:], device='cpu'))")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    p = subprocess.Popen([sys.executable, "-c", code, *argv], cwd=cwd,
                         env=env, text=True, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, start_new_session=True)
    try:
        out = p.communicate(timeout=JOIN_S)[0]
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, signal.SIGKILL)
        out = p.communicate()[0]
        pytest.fail(f"no exit in {JOIN_S} s:\n{out[-4000:]}")
    finally:
        if p.poll() is None:
            os.killpg(p.pid, signal.SIGKILL)
            p.wait()
    return p.returncode, out


QUICK = ["--w", "8", "--htsz", "6", "--n-offsets", "8",
         "--jobs-per-epoch", "2", "--pipeline", "1"]


@pytest.mark.parametrize("shard", [False, True])
def test_cli_devices_2_finds_a_planted_key(tmp_path, shard):
    k = PK + 5 * SPAN * STRIDE + 77  # job 5: rank 0 of super-epoch 1
    pub = codecs.format_pubkey(ecpy.mul(k))
    argv = ["--pub", pub, "--pk", f"{PK:x}", "--pke",
            f"{PK + 3 * JOBS_SUPER * SPAN * STRIDE:x}", *QUICK] + (
        ["--shard-table"] if shard else [])
    rc, out = _cli(tmp_path, *argv, "--devices", "2")
    assert rc == 0, out[-3000:]
    assert out.count(f"KEY FOUND: {k:#x}") == 1 and "(rank 0 of 2)" in out
    # rank 0 alone writes the win file
    assert (tmp_path / "win.txt").read_text().splitlines() == [
        f"{k:064x} {pub}"]
    ck = json.loads((tmp_path / "currentwork.json").read_text())
    assert ck["pub_index"] == 1
    # another card count refuses the checkpoint before any rank starts
    for other in (["--devices", "3"], ["--devices", "1"]):
        rc, out = _cli(tmp_path, *argv, *other, "--resume",
                       "currentwork.json")
        assert rc == 2 and "cannot resume" in out


def test_cli_a_failed_rank_fails_the_command(tmp_path):
    """Rank 0 cannot clear or write its win file (a directory): the
    command's exit code is not 0, whatever rank 1 does."""
    (tmp_path / "wins").mkdir()
    (tmp_path / "wins" / "x").write_text("")
    rc, out = _cli(tmp_path, "--pub", codecs.format_pubkey(ecpy.mul(PK + 9)),
                   "--pk", f"{PK:x}", "--pke", f"{PK + 4096:x}",
                   "--devices", "2", "--win-file", "wins", *QUICK)
    assert rc != 0 and "a rank failed" in out


def test_spawn_waits_on_ranks_that_exit_while_it_reads_them(monkeypatch):
    """Ranks that exit between _spawn's read of their exit codes and its
    wait: the wait returns at once on their sentinels, and the command
    returns 0 (a wait on no sentinel at all would block for ever)."""
    import threading
    import torch.multiprocessing

    from bsgs_tpu_torch import cli

    fds = []

    class Rank:
        """Running at the first read of its exit code, exited (0) at
        every later one."""

        def __init__(self, target, args):
            self.reads = 0
            r, w = os.pipe()
            os.write(w, b"x")
            fds.extend((r, w))
            self.sentinel = r

        def start(self):
            pass

        @property
        def exitcode(self):
            self.reads += 1
            return None if self.reads == 1 else 0

        def is_alive(self):
            return False

        def join(self):
            pass

    class Context:
        Process = Rank

    monkeypatch.setattr(torch.multiprocessing, "get_context",
                        lambda method: Context)
    got = []
    t = threading.Thread(target=lambda: got.append(
        cli._spawn(["--devices", "2"], 2, None, "cpu")), daemon=True)
    t.start()
    t.join(10)
    for fd in fds:
        os.close(fd)
    assert got == [0]
