"""Process groups: the port's ``jax.distributed`` and
``jax.experimental.multihost_utils`` as the reference uses them
(``mpi_tpu/cli.py:171-186``, ``mpi_tpu/utils/timing.py:83-103``,
``mpi_tpu/parallel/policy.py:195-207``).

:func:`initialize` starts one ``torch.distributed`` process group, the
reference's ``mpirun -np N``: with a coordinator ``HOST:PORT`` it joins
``tcp://HOST:PORT`` as rank ``process_id`` of ``num_processes``; without
one it reads ``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``
(``env://``), torch's form of the reference's "auto-detect from the
cluster environment".  A gloo group always carries the control traffic:
the placement below, broadcasts and the timing table.

Placement.  Each rank's index among the ranks on its host comes from an
``all_gather_object`` of host names, never from an environment knob; its
card is that index modulo ``torch.cuda.device_count()``.  With ``device
"cpu"`` every rank runs on the CPU.

Transport of the halos (:func:`exchange`), chosen from the placement
before any step and the same on every rank:

* ``gloo``: CPU shards, sent as they are;
* ``nccl``: every rank has a card of its own (the cards' UUIDs all
  differ); the shards' slabs travel card to card on an NCCL group, and an
  NCCL error raises;
* ``gloo-host-staged``: ranks share a card, which NCCL refuses, and gloo
  sends host tensors only: each slab is copied into a pinned host buffer
  (reused from pass to pass), the stream is synchronized, gloo carries it,
  and the receiver copies it to its card after the wait.

Every message of one exchange goes in one ``batch_isend_irecv``, each with
a tag its sender and receiver compute alike, posted in tag order (NCCL
matches a pair's messages in order; gloo by tag).
"""

from __future__ import annotations

import datetime
import os
import socket
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as tdist

from mpi_tpu_torch.config import ConfigError

# seconds any one collective or message of the group may wait for its
# peers before it raises (a rank that died closes its sockets sooner)
TIMEOUT_S = 300.0

ENV_KEYS = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


@dataclass
class Group:
    """This process's place in the group and the state of its halo
    transport."""

    rank: int
    size: int
    host: str
    local_index: int            # among the ranks on this host
    local_size: int
    device: torch.device        # this rank's device: the CPU or its card
    devices: Tuple[torch.device, ...]   # every rank's device, by rank
    transport: str              # "gloo", "gloo-host-staged" or "nccl"
    halo_group: object = None   # the group halos travel on (None: gloo's)
    pinned: Dict[tuple, torch.Tensor] = field(default_factory=dict)
    # the exchanges' counts, bytes, and µs spent synchronizing the stream
    # before a staged batch and waiting for a batch's messages
    stats: Dict[str, int] = field(default_factory=lambda: {
        "exchanges": 0, "messages": 0, "bytes_sent": 0,
        "bytes_received": 0, "bytes_staged": 0, "sync_us": 0,
        "wait_us": 0})

    def describe(self) -> str:
        return (f"process {self.rank}/{self.size} on {self.host} (local "
                f"{self.local_index} of {self.local_size}), device "
                f"{self.device}, halo transport {self.transport}")

    def buffer(self, key: tuple, shape, dtype) -> torch.Tensor:
        """The pinned host buffer kept for ``key`` (a message's direction,
        peer and tag), made again only when its shape or type changes."""
        buf = self.pinned.get(key)
        if buf is None or tuple(buf.shape) != tuple(shape) \
                or buf.dtype != dtype:
            buf = torch.empty(tuple(shape), dtype=dtype, pin_memory=True)
            self.pinned[key] = buf
        return buf


_GROUP: Optional[Group] = None


def group() -> Optional[Group]:
    """The group this process belongs to, or None."""
    return _GROUP


def is_initialized() -> bool:
    return _GROUP is not None


def process_index() -> int:
    return 0 if _GROUP is None else _GROUP.rank


def process_count() -> int:
    return 1 if _GROUP is None else _GROUP.size


def _require() -> Group:
    if _GROUP is None:
        raise RuntimeError("no process group: call dist.initialize first")
    return _GROUP


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               device: str = "cuda") -> Group:
    """Join the process group and place this rank (module docstring).
    Call it before any other CUDA call of the process."""
    global _GROUP
    if _GROUP is not None:
        raise RuntimeError("this process already belongs to a group")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, got {device!r}")
    timeout = datetime.timedelta(seconds=TIMEOUT_S)
    if coordinator:
        if num_processes is None or process_id is None:
            raise ConfigError("--coordinator needs --num-processes and "
                              "--process-id")
        if not 0 <= process_id < num_processes:
            raise ConfigError(f"--process-id {process_id} is outside the "
                              f"group of {num_processes}")
        tdist.init_process_group("gloo", init_method=f"tcp://{coordinator}",
                                 world_size=num_processes, rank=process_id,
                                 timeout=timeout)
    else:
        missing = [k for k in ENV_KEYS if k not in os.environ]
        if missing:
            raise ConfigError(
                f"--multihost without --coordinator reads the group from "
                f"the environment: {', '.join(missing)} not set")
        tdist.init_process_group("gloo", init_method="env://",
                                 timeout=timeout)
    try:
        _GROUP = _place(device)
    except BaseException:
        tdist.destroy_process_group()
        raise
    return _GROUP


def _place(device: str) -> Group:
    rank, size = tdist.get_rank(), tdist.get_world_size()
    host = socket.gethostname()
    hosts = [None] * size
    tdist.all_gather_object(hosts, host)
    local_index = sum(h == host for h in hosts[:rank])
    uuid = None
    if device == "cpu":
        dev = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available: a rank on --device cuda needs a "
                "GPU (--device cpu runs the group on the CPU)")
        card = local_index % torch.cuda.device_count()
        torch.cuda.set_device(card)
        dev = torch.device("cuda", card)
        # the card's identity: its UUID, or where this torch lacks it the
        # host and index (two ranks that share it then share the card)
        props = torch.cuda.get_device_properties(card)
        uuid = str(getattr(props, "uuid", None) or f"{host}:{card}")
    placed = [None] * size
    tdist.all_gather_object(placed, (str(dev), uuid))
    devices = tuple(torch.device(d) for d, _ in placed)
    if len({d.type for d in devices}) > 1:
        raise ConfigError(f"the ranks of a group run on one kind of device, "
                          f"got {sorted({str(d) for d in devices})}")
    halo_group = None
    if device == "cpu":
        transport = "gloo"
    elif len({u for _, u in placed}) == size:
        transport = "nccl"
        halo_group = tdist.new_group(backend="nccl")
        # every rank sets up the communicator together, before any step
        tdist.all_reduce(torch.zeros(1, device=dev), group=halo_group)
    else:
        transport = "gloo-host-staged"
    return Group(rank=rank, size=size, host=host, local_index=local_index,
                 local_size=hosts.count(host), device=dev, devices=devices,
                 transport=transport, halo_group=halo_group)


def shutdown() -> None:
    """Leave the group (every exit path calls it, so that a failed rank
    never leaves the others waiting)."""
    global _GROUP
    _GROUP = None
    if tdist.is_initialized():
        tdist.destroy_process_group()


def broadcast_one_to_all(value):
    """Process 0's ``value`` on every process (a picklable object)."""
    box = [value]
    tdist.broadcast_object_list(box, src=0)
    return box[0]


def process_allgather(arr) -> np.ndarray:
    """Every process's int64 array ``arr``, stacked by rank: shape (P,
    *arr.shape)."""
    t = torch.as_tensor(np.asarray(arr, dtype=np.int64))
    out = [torch.empty_like(t) for _ in range(process_count())]
    tdist.all_gather(out, t)
    return np.stack([o.numpy() for o in out])


Send = Tuple[int, int, torch.Tensor]                 # (peer, tag, tensor)
Recv = Tuple[int, int, Sequence[int], torch.dtype]   # (peer, tag, shape, dtype)


def exchange(sends: List[Send], recvs: List[Recv]) -> List[torch.Tensor]:
    """One batch of point-to-point messages on the halo transport: every
    send and receive in one ``batch_isend_irecv``, posted in tag order,
    waited for before it returns.  Returns the received tensors in the
    order of ``recvs``: on the rank's card under NCCL, on the host under
    gloo (pinned and reused by the next exchange when staged: copy them
    to the card, ``non_blocking``, before the next exchange)."""
    g = _require()
    if not sends and not recvs:
        return []
    staged = g.transport == "gloo-host-staged"
    ops, out = [], []
    for peer, tag, t in sends:
        if staged:
            buf = g.buffer(("send", peer, tag), t.shape, t.dtype)
            buf.copy_(t, non_blocking=True)
            g.stats["bytes_staged"] += buf.nbytes
        else:
            buf = t.contiguous()
        g.stats["bytes_sent"] += buf.nbytes
        ops.append((tag, 0, tdist.P2POp(tdist.isend, buf, peer,
                                        group=g.halo_group, tag=tag)))
    for peer, tag, shape, dtype in recvs:
        if staged:
            buf = g.buffer(("recv", peer, tag), shape, dtype)
            g.stats["bytes_staged"] += buf.nbytes
        else:
            buf = torch.empty(tuple(shape), dtype=dtype, device=g.device)
        g.stats["bytes_received"] += buf.nbytes
        out.append(buf)
        ops.append((tag, 1, tdist.P2POp(tdist.irecv, buf, peer,
                                        group=g.halo_group, tag=tag)))
    t0 = time.perf_counter()
    if staged:
        # the slabs are on the host, and the last exchange's received
        # buffers on the card, before gloo touches either
        torch.cuda.current_stream(g.device).synchronize()
    t1 = time.perf_counter()
    ops.sort(key=lambda o: o[:2])
    for req in tdist.batch_isend_irecv([op for _, _, op in ops]):
        req.wait()
    g.stats["sync_us"] += int((t1 - t0) * 1e6)
    g.stats["wait_us"] += int((time.perf_counter() - t1) * 1e6)
    g.stats["exchanges"] += 1
    g.stats["messages"] += len(ops)
    return out
