"""Process-group rendezvous over ``torch.distributed``.

Port of ``distributed_llm_training_benchmark_framework_tpu/runtime/distributed.py``.
The reference starts one process per GPU with
``dist.init_process_group(backend='nccl', init_method='tcp://MASTER_ADDR:MASTER_PORT')``;
so does the port. Unlike the JAX package, where one process drives every
chip of a host, here a process owns exactly one card: the process count is
the card count, and ``world_size`` counts both.

Env contract (torchrun's first, then the JAX package's):

    WORLD_SIZE, RANK, LOCAL_RANK, MASTER_ADDR, MASTER_PORT   (torchrun)
    NUM_PROCESSES                                            <-> WORLD_SIZE
    PROCESS_ID / TPU_WORKER_ID / RANK / JOB_COMPLETION_INDEX <-> RANK
    COORDINATOR_ADDRESS (host:port)                          <-> MASTER_ADDR:MASTER_PORT

NCCL on ``cuda:{LOCAL_RANK}``; gloo when the caller runs on the CPU. With no
world size from the caller or the environment no group is made, as the JAX
package makes none below two processes: every entry point then runs on one
device with no wrapper.

``setup_distributed`` also makes a ``torch.distributed.TCPStore`` (the
process group rendezvous over it), which carries the cross-rank
"preempt soon" and "rank wedged" flags and the preempt-step agreement
(the JAX package rides the coordination service's key-value store for
the same): a flag costs host round trips to the store and no device work.
On the streaming input path it also carries each step's "batch ready or
starved" verdicts (``agree_data_ready``), so a stall on one rank stops
every rank at the same boundary.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
import time
from typing import List, Mapping, Optional, Tuple

import torch
import torch.distributed as dist

#: Key namespaces on the store (same names as the JAX package).
_PREEMPT_FLAG_PREFIX = "benchpreempt/flag/"
_PREEMPT_ACK_PREFIX = "benchpreempt/ack/"
_HANG_FLAG_PREFIX = "benchhang/flag/"
_DATA_READY_PREFIX = "benchdata/ready/"

#: How long start-up and each collective wait for every rank.
RENDEZVOUS_TIMEOUT_SEC = 600.0

#: Overall deadline for every peer's preempt ack (see agree_preempt_step).
PREEMPT_ACK_TIMEOUT_SEC = float(os.environ.get("PREEMPT_ACK_TIMEOUT_SEC", 60))


@dataclasses.dataclass(frozen=True)
class DistEnv:
    """Where this process sits in the job, from the launcher or the caller."""

    world_size: int
    rank: int
    local_rank: int
    master_addr: str
    master_port: int


def read_env(env: Mapping[str, str] = os.environ, master_addr: Optional[str] = None,
             master_port: Optional[int] = None, num_processes: Optional[int] = None,
             process_id: Optional[int] = None) -> Optional[DistEnv]:
    """The job geometry named by the arguments (which win) or the
    environment, or None when neither names a world size (a plain
    single-process run). torchrun's variables, when ``WORLD_SIZE`` is set,
    else the JAX package's, in its order; the rendezvous defaults to
    127.0.0.1:29500."""
    torchrun = bool(env.get("WORLD_SIZE"))
    n = num_processes
    if n is None:
        var = "WORLD_SIZE" if torchrun else "NUM_PROCESSES"
        if not env.get(var):
            return None
        n = int(env[var])
    if n < 1:
        raise ValueError(f"world size must be >= 1, got {n}")
    rank = process_id
    if rank is None:
        names = ("RANK",) if torchrun else (
            "PROCESS_ID", "TPU_WORKER_ID", "RANK", "JOB_COMPLETION_INDEX")
        rank = next((int(env[v]) for v in names if env.get(v)), 0)
    if not 0 <= rank < n:
        raise ValueError(f"rank {rank} outside world size {n}")
    addr, port = env.get("MASTER_ADDR"), env.get("MASTER_PORT")
    if env.get("COORDINATOR_ADDRESS") and not torchrun:
        addr, _, port = env["COORDINATOR_ADDRESS"].rpartition(":")
    addr = master_addr or addr or "127.0.0.1"
    port = master_port if master_port is not None else int(port or 29500)
    return DistEnv(n, rank, int(env.get("LOCAL_RANK", rank)), addr, int(port))


class _Runtime:
    """The store this process made in ``setup_distributed``, its place in
    the job and the device type its tensors live on; None outside a group.
    ``run`` counts the runs begun in this process (``begin_run``): each
    run's flags live under its own number."""

    def __init__(self):
        self.store: Optional[dist.TCPStore] = None
        self.env: Optional[DistEnv] = None
        self.device_type: Optional[str] = None
        self.run = 0


_RT = _Runtime()


def setup_distributed(master_addr: Optional[str] = None, master_port: Optional[int] = None,
                      num_processes: Optional[int] = None, process_id: Optional[int] = None,
                      device: Optional[str] = None, backend: Optional[str] = None) -> bool:
    """Join the process group the launcher (or the arguments) describe.

    ``device`` "cpu" selects gloo; otherwise NCCL on ``cuda:{LOCAL_RANK}``,
    which is made the current device. ``backend="gloo"`` with a CUDA device
    keeps the tensors on the card and carries the collectives over gloo
    (several ranks on one card, where NCCL takes one rank per device: rank
    LOCAL_RANK takes card LOCAL_RANK mod the card count).
    Returns True if this call made a group, False when nothing names a
    world size (no group, as in JAX)."""
    env = read_env(os.environ, master_addr, master_port, num_processes, process_id)
    if env is None:
        return False
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized in this process")
    if backend not in (None, "gloo", "nccl"):
        raise ValueError(f"backend {backend!r} (expected 'gloo' or 'nccl')")
    on_cpu = device is not None and torch.device(device).type == "cpu"
    if not on_cpu:
        if not torch.cuda.is_available():
            raise RuntimeError("NCCL needs a CUDA device; pass device='cpu' for gloo")
        torch.cuda.set_device(env.local_rank % torch.cuda.device_count() if backend == "gloo"
                              else env.local_rank)
    timeout = datetime.timedelta(seconds=RENDEZVOUS_TIMEOUT_SEC)
    store = dist.TCPStore(env.master_addr, env.master_port, env.world_size,
                          is_master=env.rank == 0, timeout=timeout)
    gloo = on_cpu or backend == "gloo"
    dist.init_process_group(
        "gloo" if gloo else "nccl", store=store, rank=env.rank,
        world_size=env.world_size, timeout=timeout,
        **({} if gloo else {"device_id": torch.device("cuda", env.local_rank)}),
    )
    _RT.store, _RT.env = store, env
    _RT.device_type = "cpu" if on_cpu else "cuda"
    return True


def cleanup_distributed() -> None:
    """Destroy the group and drop the store (no-op without a group)."""
    if dist.is_initialized():
        dist.destroy_process_group()
    _RT.store, _RT.env, _RT.device_type = None, None, None


def group_device_type() -> str:
    """The device type of the group's tensors: the one ``setup_distributed``
    was given (gloo carries CUDA tensors too), else "cuda" under NCCL and
    "cpu" otherwise."""
    if _RT.device_type is not None:
        return _RT.device_type
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def get_world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def get_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    return get_rank() == 0


def barrier() -> None:
    """Every rank waits here for every other (no-op without a group)."""
    if not dist.is_initialized():
        return
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()


# ---------------------------------------------------------------------------
# Cross-rank "preempt soon" and "rank wedged" flags (the JAX package's
# protocol over the store): a rank publishes ``<prefix><run>/<rank> = <step>``;
# every rank polls the namespace at its fenced boundaries without blocking;
# on a visible preempt flag each rank acks its boundary step and the agreed
# stop step is the max of the acks. ``<run>`` keeps a later run in the same
# group (the bench runs several rows in one process) from reading an
# earlier run's flags, which the store keeps.
# ---------------------------------------------------------------------------


def begin_run() -> None:
    """Start a new flag namespace; every rank calls it once per run, in the
    same order, so their numbers agree."""
    _RT.run += 1


def _key(prefix: str, rank: int) -> str:
    return f"{prefix}{_RT.run}/{rank}"


def _publish_flag(prefix: str, step: int) -> bool:
    """Write ``<prefix><run>/<my rank> = <step>``; False when there is no
    store."""
    if _RT.store is None:
        return False
    _RT.store.set(_key(prefix, _RT.env.rank), str(int(step)))
    return True


def _flag_entries(prefix: str) -> List[Tuple[int, int]]:
    """Non-blocking poll of one namespace: [(rank, step), ...]."""
    if _RT.store is None:
        return []
    out = []
    for rank in range(_RT.env.world_size):
        key = _key(prefix, rank)
        if _RT.store.check([key]):
            out.append((rank, int(_RT.store.get(key))))
    return out


def publish_preempt_flag(step: int) -> bool:
    """Announce this rank's SIGTERM to every other rank."""
    return _publish_flag(_PREEMPT_FLAG_PREFIX, step)


def preempt_flag_entries() -> List[Tuple[int, int]]:
    return _flag_entries(_PREEMPT_FLAG_PREFIX)


def publish_hang_flag(step: int) -> bool:
    """Announce that this rank's hang watchdog fired."""
    return _publish_flag(_HANG_FLAG_PREFIX, step)


def hang_flag_entries() -> List[Tuple[int, int]]:
    return _flag_entries(_HANG_FLAG_PREFIX)


def agree_preempt_step(my_boundary_step: int,
                       timeout_sec: float = PREEMPT_ACK_TIMEOUT_SEC) -> Optional[int]:
    """Ack my boundary, gather every rank's ack, return the max (the step
    every rank stops at). ``timeout_sec`` is one deadline for all peers
    together; None when a peer never acks within it. Without a store the
    answer is my own boundary."""
    if _RT.store is None:
        return my_boundary_step
    me, store = _RT.env.rank, _RT.store
    store.set(_key(_PREEMPT_ACK_PREFIX, me), str(int(my_boundary_step)))
    deadline = time.monotonic() + timeout_sec
    acks = {me: int(my_boundary_step)}
    for rank in range(_RT.env.world_size):
        if rank in acks:
            continue
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return None
        key = _key(_PREEMPT_ACK_PREFIX, rank)
        try:
            store.wait([key], datetime.timedelta(seconds=remaining))
        except dist.DistStoreError:
            return None
        acks[rank] = int(store.get(key))
    return max(acks.values())


def agree_data_ready(step: int, stalled_sec: Optional[float], timeout_sec: float,
                     generation: int = 0) -> Optional[float]:
    """Before step ``step`` dispatches on the streaming input path: publish
    this rank's verdict (None: its batch is here; else the seconds it
    starved past the stall timeout) and read every rank's -> None when
    every rank has its batch, else the longest starvation, the same on
    every rank. A healthy rank waits here for a starving peer's verdict
    (up to ``timeout_sec``, the peer's own timeout plus slack) instead of
    entering the step's collectives without it. ``generation`` (the
    rollbacks so far) keeps a replayed step's verdicts apart from its first
    pass's. Without a store (one process) the answer is this rank's
    verdict."""
    if _RT.store is None or _RT.env.world_size <= 1:
        return stalled_sec
    me, store = _RT.env.rank, _RT.store
    prefix = f"{_DATA_READY_PREFIX}{int(generation)}/{int(step)}/"
    store.set(_key(prefix, me), "ok" if stalled_sec is None else repr(float(stalled_sec)))
    worst = stalled_sec
    for rank in range(_RT.env.world_size):
        if rank == me:
            continue
        key = _key(prefix, rank)
        store.wait([key], datetime.timedelta(seconds=timeout_sec))
        verdict = store.get(key).decode()
        if verdict != "ok":
            worst = max(worst or 0.0, float(verdict))
    # Every peer read this rank's verdict of step - 2 before publishing its
    # own of step - 1, which this rank has just read: it can go.
    store.delete_key(_key(f"{_DATA_READY_PREFIX}{int(generation)}/{int(step) - 2}/", me))
    return worst
