"""The ranks of a multi-card run and the collectives between them.

Counterpart of ``bsgs_tpu/parallel/mesh.py``. The JAX package drives every
chip from one controller (``shard_map`` over a ``Mesh``); the port runs one
process per card, each a rank of a ``torch.distributed`` process group:
NCCL between cards, gloo between CPU processes. ``Mesh`` is this rank's
view of that group, and its methods are the only collectives the port
makes. A collective that fails raises; nothing falls back to one card.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import socket
from typing import Optional

import torch
import torch.distributed as dist

# How long a rank waits for the others, at the rendezvous and in every
# collective, before it raises.
TIMEOUT = datetime.timedelta(seconds=120)

# What a launcher such as torchrun sets for each rank.
LAUNCHER_VARS = ("MASTER_ADDR", "WORLD_SIZE", "RANK")

# The gather into one tensor: all_gather_single from PyTorch 2.13, which
# deprecates the older name for the same call.
_all_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def backend_for(device) -> str:
    """The process-group backend of a device: nccl for cuda, gloo for cpu."""
    return "nccl" if torch.device(device or "cuda").type == "cuda" else "gloo"


def free_address() -> str:
    """A rendezvous address on this host: tcp://127.0.0.1 and a free port."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"tcp://127.0.0.1:{s.getsockname()[1]}"


def launched() -> bool:
    """Whether this process is a rank of a group: one already joined, or
    one a launcher has set up."""
    return dist.is_initialized() or all(v in os.environ
                                        for v in LAUNCHER_VARS)


def world_size() -> int:
    """The size of the group this process is or will be a rank of (0 when
    it is none)."""
    if dist.is_initialized():
        return dist.get_world_size()
    return int(os.environ["WORLD_SIZE"]) if launched() else 0


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     timeout: datetime.timedelta = TIMEOUT) -> bool:
    """Join the process group (idempotent); returns whether this call
    created it, so that its caller can close it (close).

    With no arguments it reads the launcher's variables (MASTER_ADDR,
    MASTER_PORT, WORLD_SIZE, RANK, as torchrun sets them), and does
    nothing where there are none, as bsgs_tpu's does on a single host.
    Explicit arguments start a group by hand: coordinator_address is an
    init method such as "tcp://127.0.0.1:29500". backend defaults to
    nccl where there is a card, else gloo."""
    if dist.is_initialized():
        return False
    if (coordinator_address is None and num_processes is None
            and not launched()):
        return False
    kw = {}
    if coordinator_address is not None:
        kw["init_method"] = coordinator_address
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    dist.init_process_group(
        backend=backend or ("nccl" if torch.cuda.is_available() else "gloo"),
        timeout=timeout, **kw)
    return True


def close() -> None:
    """Leave the process group."""
    dist.destroy_process_group()


@dataclasses.dataclass
class Mesh:
    """This rank's view of the process group: its size, this rank's index
    and device, and the collectives, each over the whole group and in rank
    order. Every rank must call the same collectives in the same order."""

    world: int
    rank: int
    device: torch.device
    backend: str
    group: object = None  # None: the default group

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's t, concatenated along dim 0 in rank order (one
        output tensor: no list of parts to concatenate after)."""
        out = torch.empty((self.world * t.shape[0],) + tuple(t.shape[1:]),
                          dtype=t.dtype, device=t.device)
        _all_gather_single(out, t.contiguous(), group=self.group)
        return out

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """Segment ``rank`` of every rank's t, concatenated along dim 0 in
        rank order: dim 0 of t splits into world equal segments, segment j
        going to rank j (one output tensor). Every rank's t has the same
        shape. NCCL sends no bool: callers send masks as uint8."""
        t = t.contiguous()
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.group)
        return out

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max over every rank's t, in place."""
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.group)
        return t

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """Rank src's t, in place on every rank."""
        dist.broadcast(t, src, group=self.group)
        return t


def make_mesh(n_devices: Optional[int] = None, device_ids=None,
              device=None) -> Mesh:
    """This rank's Mesh over the process group it has joined
    (init_distributed). On ``cuda`` (the default) rank r binds
    cuda:device_ids[r], else cuda:LOCAL_RANK (the launcher's), else
    cuda:r, and makes it the current device; on ``cpu`` every rank runs on
    the CPU. Raises when there is no group, when n_devices or device_ids
    disagree with the world size, when the card does not exist, or when
    the backend does not suit the device: it never carries on with fewer
    ranks or with two ranks on one card."""
    if not dist.is_initialized():
        raise RuntimeError("no process group: call init_distributed first "
                           "(or launch the ranks with torchrun)")
    world, rank = dist.get_world_size(), dist.get_rank()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"{n_devices} cards asked for, but the process "
                         f"group has {world} ranks")
    if device_ids is not None and len(set(device_ids)) != len(device_ids):
        raise ValueError(f"card ids {list(device_ids)} repeat a card: each "
                         f"rank needs a card of its own")
    if device_ids is not None and len(device_ids) != world:
        raise ValueError(f"{len(device_ids)} card ids for a process group "
                         f"of {world} ranks")
    dev = torch.device("cuda" if device is None else device)
    backend = dist.get_backend()
    if backend != backend_for(dev):
        raise ValueError(f"a {backend} process group cannot join "
                         f"{dev.type} ranks; use {backend_for(dev)}")
    if dev.type == "cuda":
        if device_ids is not None:
            idx = int(device_ids[rank])
        else:
            idx = int(os.environ.get("LOCAL_RANK", rank))
        count = torch.cuda.device_count()
        if not 0 <= idx < count:
            raise RuntimeError(f"rank {rank} of {world} cannot bind "
                               f"cuda:{idx}: this host has {count} cards")
        dev = torch.device("cuda", idx)
        torch.cuda.set_device(dev)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {dev}")
    return Mesh(world=world, rank=rank, device=dev, backend=backend)
