"""Pipeline parallelism over a ``pipe`` axis of the process group: JAX's
GPipe and lockstep 1F1B schedules, the messages between stages, and the
schedule's bookkeeping.

Port of ``distributed_llm_training_benchmark_framework_tpu/parallel/pipeline.py``
(``pipeline_loss_fn``, ``pipeline_loss_and_grads_1f1b``), of
``pipeline_schedule_meta`` (its ``train/step.py``) and of
``pipeline_bubble_bound`` (its ``analysis/static/hlo_audit.py``); the
interleaved schedule is ``parallel/interleaved.py``. These are JAX's
schedules tick for tick, not ``torch.distributed.pipelining``'s (whose 1F1B
is Megatron's non-lockstep form and whose interleaved order is not
``build_schedule``'s tables), so the bounds below describe what runs.

Each rank of a ``pipe`` group of width P holds one stage of the model
(``models/tinygpt.py``: its layers, and the embedding, final norm and head
on every stage). A step's M micro-batches (the gradient accumulation) are
the schedule's microbatches; the schedule calls the model one unit at a
time through the arm's wrapper (``StageUnit``):

- **gpipe**: T = M + P - 1 ticks; at tick t stage s forwards microbatch
  t - s, keeping its autograd graph; the last stage computes each loss.
  The backward runs the ticks in reverse, each stage receiving its output's
  gradient from stage s + 1 and sending its input's to s - 1 (every M
  residuals live, as JAX's autodiff of the loop keeps them).
- **1f1b** (JAX's lockstep form): T = M + 2(P - 1) ticks; at tick t stage
  s forwards microbatch t - s without a graph, keeping its input, and
  backwards microbatch t - 2(P - 1) + s by running its forward again on the
  kept input (the same masks: seeded per microbatch and global layer) and
  back-propagating the gradient stage s + 1 sent. The last stage computes
  the loss and its gradient in place, the tick it forwards. A microbatch's
  input dies 2(P - 1 - s) ticks after its forward: O(P) inputs live, for
  one extra stage forward per microbatch.

The loss of microbatch m enters as loss_m / M. With experts each stage sums
its layers' aux over the units it ran, and each backward unit seeds the
aux's gradient ``router_aux_coef / (n_layer * M)``: summed over ``pipe``
the loss is JAX's ``mean CE + coef * sum(aux) / (n_layer * M)``.

Only real messages travel (JAX's ppermutes of zeros on idle links are an
SPMD artefact): at the end of each tick a rank posts its sends and the
receives of its neighbours' sends of that tick in one
``batch_isend_irecv`` and waits for a receive when a unit needs it, with a
timeout. Per step and direction the pipeline sends M * (P - 1) messages
(gpipe, 1f1b) or M * (P * V - 1) (interleaved). gloo cannot send a CUDA
tensor (its TCP transport reads the pointer as host memory), so under gloo
a CUDA message goes through pinned host memory; under NCCL it goes as it
is.
"""

from __future__ import annotations

import dataclasses
import datetime
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

SCHEDULES = ("gpipe", "1f1b", "interleaved")
FWD, BWD = 0, 1  # message directions, also their tags
RECV_TIMEOUT_SEC = 300.0


@dataclasses.dataclass(frozen=True)
class StageUnit:
    """One call of a pipeline stage (``TinyGPT.run_unit``): embed the tokens
    first, run chunk ``chunk``'s blocks (None: none), end in the loss
    (``head``); ``mask_seeds`` seeds the dropout masks (the embedding's,
    then layer l's at 1 + l; None: no dropout)."""

    chunk: Optional[int] = 0
    embed: bool = False
    head: bool = False
    mask_seeds: Optional[Sequence[int]] = None


def check_schedule(pipeline_schedule: str) -> None:
    if pipeline_schedule not in SCHEDULES:
        raise ValueError(
            f"unknown pipeline schedule {pipeline_schedule!r} "
            "(expected 'gpipe', '1f1b' or 'interleaved')"
        )


def pipeline_schedule_meta(mesh, grad_accum: int, pipeline_schedule: str = "gpipe",
                           virtual_stages: int = 2) -> Optional[dict]:
    """The (schedule, stages, microbatches, virtual) the step's pipeline
    runs, or None without a ``pipe`` axis wider than 1: M is ``grad_accum``
    and only the interleaved schedule has V > 1 (JAX's)."""
    if mesh.size("pipe") <= 1:
        return None
    check_schedule(pipeline_schedule)
    return {
        "schedule": pipeline_schedule,
        "stages": int(mesh.size("pipe")),
        "microbatches": int(grad_accum),
        "virtual": int(virtual_stages) if pipeline_schedule == "interleaved" else 1,
    }


def pipeline_bubble_bound(schedule: str, stages: int, microbatches: int,
                          virtual: int = 1) -> float:
    """JAX's structural bound on the schedule's idle share: gpipe
    (S-1)/(M+S-1), lockstep 1f1b 2(S-1)/(M+2(S-1)), interleaved the idle
    share of ``build_schedule``'s unit grid."""
    S, M = stages, microbatches
    if schedule == "gpipe":
        return (S - 1) / (M + S - 1)
    if schedule == "1f1b":
        return 2 * (S - 1) / (M + 2 * (S - 1))
    if schedule == "interleaved":
        from .interleaved import build_schedule

        return float(build_schedule(S, virtual, M).bubble_fraction)
    raise ValueError(f"unknown pipeline schedule {schedule!r}")


def expected_messages(schedule: str, stages: int, microbatches: int, virtual: int = 1) -> int:
    """Messages one step sends in each direction over the whole pipeline."""
    positions = stages * (virtual if schedule == "interleaved" else 1)
    return microbatches * (positions - 1)


class _Inbound:
    """A posted receive: ``get`` waits for it (timed, with a timeout) and
    returns the message on the device."""

    def __init__(self, transport: "Transport", work, buf: torch.Tensor):
        self.transport, self.work, self.buf = transport, work, buf

    def get(self) -> torch.Tensor:
        t0 = time.perf_counter()
        self.work.wait(timeout=self.transport.timeout)
        out = self.buf
        if self.transport.staged:  # ordered on the stream; the pinned block outlives the copy
            # graftcheck: disable=GC109 (gloo's staging of a CUDA message, by design)
            out = out.to(self.transport.device, non_blocking=True)
        self.transport.wait_s += time.perf_counter() - t0
        return out


class Transport:
    """The messages of one stage with its neighbours on the ``pipe`` ring:
    the forward stream goes to the next stage, gradients to the previous
    one, over the mesh's ``pipe`` group (the peers are global ranks, which
    ``P2POp`` maps into it). Counts what it sends (per direction) and the
    time spent waiting for receives."""

    def __init__(self, mesh, device: torch.device, timeout: float = RECV_TIMEOUT_SEC):
        self.prev, self.next = mesh.pipe_neighbours
        self.group = mesh.pipe_group
        self.device = device
        self.staged = dist.get_backend(self.group) == "gloo" and device.type == "cuda"
        self.timeout = datetime.timedelta(seconds=timeout)
        self.sent = [0, 0]
        self.wait_s = 0.0
        self._sends: List[Tuple[object, torch.Tensor]] = []

    def post(self, sends: Sequence[Tuple[int, torch.Tensor]],
             recvs: Sequence[Tuple[int, Tuple[int, ...], torch.dtype]]) -> Dict[int, _Inbound]:
        """This tick's sends ((direction, tensor)) and receives ((direction,
        shape, dtype)), posted together -> {direction: the receive}."""
        ops, inbound = [], {}
        for direction, t in sends:
            t = t.detach()
            if self.staged:
                # graftcheck: disable=GC109 (gloo's staging of a CUDA message, by design)
                t = torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t)
            else:
                t = t.contiguous()
            peer = self.next if direction == FWD else self.prev
            ops.append(dist.P2POp(dist.isend, t, peer, self.group, tag=direction))
            self.sent[direction] += 1
        bufs = []
        for direction, shape, dtype in recvs:
            # graftcheck: disable=GC109 (gloo's staging of a CUDA message, by design)
            buf = torch.empty(shape, dtype=dtype, device="cpu" if self.staged else self.device,
                              pin_memory=self.staged)
            peer = self.prev if direction == FWD else self.next
            ops.append(dist.P2POp(dist.irecv, buf, peer, self.group, tag=direction))
            bufs.append((direction, buf))
        if not ops:
            return inbound
        works = dist.batch_isend_irecv(ops)
        if len(works) == 1:  # NCCL coalesces the batch into one work
            works = works * len(ops)
        for op, work in zip(ops[:len(sends)], works):
            self._sends.append((work, op.tensor))
        for (direction, buf), work in zip(bufs, works[len(sends):]):
            inbound[direction] = _Inbound(self, work, buf)
        return inbound

    def flush(self) -> None:
        """Wait for every send posted (their buffers live until then)."""
        for work, _ in self._sends:
            work.wait(timeout=self.timeout)
        self._sends.clear()


def _backward(outs: Sequence[Optional[torch.Tensor]],
              grads: Sequence[Optional[torch.Tensor]]) -> None:
    pairs = [(o, g) for o, g in zip(outs, grads) if o is not None]
    torch.autograd.backward([o for o, _ in pairs], [g for _, g in pairs])


class Pipeline:
    """One rank's schedule: the stage s of P, ``microbatches`` M per step,
    ``virtual_stages`` V chunks per stage under the interleaved schedule.
    ``run`` drives one step's forward and backward units."""

    def __init__(self, schedule: str, mesh, microbatches: int, device: torch.device,
                 virtual_stages: int = 2):
        check_schedule(schedule)
        self.schedule = schedule
        self.stage, self.stages = mesh.pipe_shard
        self.microbatches = microbatches
        self.virtual = virtual_stages if schedule == "interleaved" else 1
        self.group = mesh.pipe_group
        self.transport = Transport(mesh, device)
        self.tables = None
        if schedule == "interleaved":
            from .interleaved import build_schedule

            self.tables = build_schedule(self.stages, self.virtual, microbatches)

    def run(self, call: Callable, optimizer, batch: torch.Tensor, stream_dtype: torch.dtype,
            d_model: int, mask_seeds: Sequence[Optional[Sequence[int]]], aux_coef: float,
            n_blocks: int) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """One step over ``batch`` (M, mb, S) tokens (targets are the
        inputs): ``call(inp, targets, unit, micro)`` runs a unit of this
        stage through the arm's wrapper -> (output, aux or None).
        ``aux_coef`` is the aux's weight in the loss, ``router_aux_coef /
        n_layer`` (0 without experts); ``n_blocks`` the stage's blocks.
        Returns (this stage's sum of the microbatches' mean losses, zero but
        on the last stage; its summed aux, or None)."""
        runner = {"gpipe": Pipeline._gpipe, "1f1b": Pipeline._one_f_one_b}.get(self.schedule)
        if runner is None:
            from .interleaved import run_interleaved as runner
        shape = (batch.shape[1], batch.shape[2], d_model)
        with optimizer.sync_context(last=False):
            out = runner(self, call, optimizer, batch, (shape, stream_dtype), mask_seeds,
                         aux_coef / self.microbatches, n_blocks)
        self.transport.flush()
        return out

    @torch.no_grad()
    def forward_only(self, first: Callable[[], torch.Tensor], stage: Callable,
                     shape: Tuple[int, ...], dtype: torch.dtype) -> torch.Tensor:
        """One microbatch through contiguous stages in order, without a
        graph: ``first()`` is the first stage's input stream, ``stage(x) ->
        (x, aux)`` runs this stage's blocks; -> the aux summed over
        ``pipe``."""
        s, P = self.stage, self.stages
        x = first() if s == 0 else self.transport.post([], [(FWD, shape, dtype)])[FWD].get()
        x, aux = stage(x)
        if s < P - 1:
            self.transport.post([(FWD, x)], [])
            self.transport.flush()
        dist.all_reduce(aux, group=self.group)
        return aux

    # -- the two lockstep schedules -------------------------------------

    def _gpipe(self, call, optimizer, batch, stream, mask_seeds, aux_ct, n_blocks):
        s, P, M = self.stage, self.stages, self.microbatches
        last = s == P - 1
        dev = batch.device
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        aux_sum = None
        kept: Dict[int, tuple] = {}
        inbox: Dict[int, _Inbound] = {}
        for t in range(M + P - 1):
            m = t - s
            sends = []
            if 0 <= m < M:
                inp = batch[m] if s == 0 else inbox[FWD].get().requires_grad_()
                y, aux = call(inp, batch[m] if last else None,
                              StageUnit(0, s == 0, last, mask_seeds[m]), m)
                if aux is not None:
                    aux_sum = aux.detach() if aux_sum is None else aux_sum + aux.detach()
                if last:
                    loss_sum += y.detach()
                else:
                    sends.append((FWD, y))
                kept[m] = (inp, y, aux)
            recv = 0 <= t + 1 - s < M and s > 0
            inbox = self.transport.post(sends, [(FWD, *stream)] if recv else [])
        for t in reversed(range(M + P - 1)):
            m = t - s
            sends = []
            if 0 <= m < M:
                inp, y, aux = kept.pop(m)
                if m == 0:
                    optimizer.last_backward(f"blocks.{i}" for i in range(n_blocks))
                aux_g = None if aux is None else torch.full_like(aux, aux_ct)
                if last:
                    _backward([y, aux], [torch.full_like(y, 1.0 / M), aux_g])
                else:
                    _backward([y, aux], [inbox[BWD].get(), aux_g])
                if s > 0:
                    sends.append((BWD, inp.grad))
            recv = 0 <= t - 1 - s < M and not last
            inbox = self.transport.post(sends, [(BWD, *stream)] if recv else [])
        return loss_sum, aux_sum

    def _one_f_one_b(self, call, optimizer, batch, stream, mask_seeds, aux_ct, n_blocks):
        s, P, M = self.stage, self.stages, self.microbatches
        last = s == P - 1
        dev = batch.device
        loss_sum = torch.zeros((), dtype=torch.float32, device=dev)
        aux_sum = None
        saved: Dict[int, torch.Tensor] = {}  # microbatch -> the stage's input
        inbox: Dict[int, _Inbound] = {}
        for t in range(M + 2 * (P - 1)):
            sends, g_head = [], None
            m = t - s
            if 0 <= m < M:  # forward unit
                inp = batch[m] if s == 0 else inbox[FWD].get()
                saved[m] = inp
                with torch.no_grad():
                    y, aux = call(inp, None, StageUnit(0, s == 0, False, mask_seeds[m]), m)
                if aux is not None:
                    aux_sum = aux if aux_sum is None else aux_sum + aux
                if last:
                    # The loss and its gradient at the stage's output, in place.
                    y = y.requires_grad_()
                    loss, _ = call(y, batch[m], StageUnit(None, False, True), m)
                    loss_sum += loss.detach()
                    _backward([loss], [torch.full_like(loss, 1.0 / M)])
                    g_head = y.grad
                else:
                    sends.append((FWD, y))
            b = t - 2 * (P - 1) + s
            if 0 <= b < M:  # backward unit: recompute the stage, then back
                g = g_head if last else inbox[BWD].get()
                inp = saved.pop(b)
                if s > 0:
                    inp = inp.requires_grad_()
                if b == M - 1:
                    optimizer.last_backward(f"blocks.{i}" for i in range(n_blocks))
                y, aux = call(inp, None, StageUnit(0, s == 0, False, mask_seeds[b]), b)
                _backward([y, aux], [g, None if aux is None else torch.full_like(aux, aux_ct)])
                if s > 0:
                    sends.append((BWD, inp.grad))
            recvs = []
            if s > 0 and 0 <= t + 1 - s < M:
                recvs.append((FWD, *stream))
            if not last and 0 <= t + 1 - 2 * (P - 1) + s < M:
                recvs.append((BWD, *stream))
            inbox = self.transport.post(sends, recvs)
        return loss_sum, aux_sum


def check_pipeline(pipeline_parallel: int, pipeline_schedule: str, virtual_stages: int,
                   n_layer: int, tensor_parallel: int, expert_parallel: int,
                   tp_collective_matmul: bool) -> None:
    """The JAX loop's checks of the pipeline options, and the port's
    refusals of what is not ported."""
    if pipeline_parallel < 1:
        raise ValueError(f"pipeline_parallel must be >= 1, got {pipeline_parallel}")
    if pipeline_parallel == 1:
        return
    check_schedule(pipeline_schedule)
    if tp_collective_matmul:
        raise ValueError(
            "--tp-collective-matmul cannot compose with pipeline parallelism (the pipeline runs "
            "the residual stream manually over 'seq'; drop one of the two)"
        )
    if tensor_parallel > 1:
        raise ValueError(
            "pipeline parallelism beside tensor parallelism is not ported (under 'pipe' JAX "
            "keeps wte replicated over 'model', a second layout of the tp path; ROADMAP Queue 1 "
            "item 13)")
    if expert_parallel > 1:
        raise ValueError(
            "pipeline parallelism beside an 'expert' axis wider than 1 is not ported (JAX takes "
            "its GSPMD einsum fallback there; ROADMAP Queue 1 item 12)")
    if n_layer % pipeline_parallel:
        raise ValueError(f"n_layer={n_layer} not divisible by pipe={pipeline_parallel}")
    if pipeline_schedule == "interleaved":
        if virtual_stages < 1:
            raise ValueError(f"virtual_stages must be >= 1, got {virtual_stages}")
        if n_layer % (pipeline_parallel * virtual_stages):
            raise ValueError(f"n_layer={n_layer} not divisible by pipe*virtual="
                             f"{pipeline_parallel}*{virtual_stages}")
