"""Engine 1: the collective-budget audit, counted on a fake process group.

The counterpart of ``distributed_llm_training_benchmark_framework_tpu/
analysis/static/hlo_audit.py``. JAX lowers each arm's train step on the CPU
with abstract values and reads the collectives off the compiled HLO. Eager
PyTorch has no HLO, so the port counts what the step *issues*: one process
plays one rank of a ``fake`` process group of ``prod(mesh)`` ranks
(``torch.testing._internal.distributed.fake_pg``, no peers, no transport),
builds the arm on the CPU through ``train.loop.build_run`` (the port's own
mesh, layout, model and optimizer), runs one optimizer step, and a
``TorchDispatchMode`` sees every ``c10d.*`` op the step dispatches, with its
tensors and its group.

The mode counts first, then fills: a fake group writes nothing, and some
collective outputs steer control flow (the loss's all-reduce, the MoE
offsets' all-gather), so each collective gets a result that is locally
consistent, as if every rank held this rank's values: an all-gather repeats
its input, a reduce-scatter keeps this rank's block of it, an all-reduce or
an all-to-all returns its input, and a receive is zeros. It then hands back
a completed ``Work`` whose future holds the output (the fake group's own
has none, which DDP's reducer refuses).

What one arm's report pins (``ArmReport``):

- per class (all-gather, reduce-scatter, all-reduce, all-to-all, and the
  point-to-point ``send`` and ``recv`` that ``batch_isend_irecv`` posts: the
  counterpart of JAX's collective-permute), the count, the bytes and the
  group sizes of one step on this rank;
- ``replication_reshard_suspects``: a collective over a group the mesh did
  not make (one wider than the mesh's group for its axis), a collective
  moving more than a scalar over every rank where the arm's replicas are
  fewer (WORLD where ``data`` is narrower), an all-gather over ``model`` in
  an arm whose stream is not sequence-sharded over ``model`` (the plain
  Megatron layout keeps every ``model``-sharded leaf sharded: a gather
  means a replication), and point-to-point traffic in an arm with no ring
  or pipeline (JAX's own rule for collective-permutes);
- ``bf16_to_f32_converts``: casts from bf16 to fp32 seen at the dispatcher
  (``_to_copy`` and ``copy_``), the counterpart of HLO's converts.

JAX's donation keys (``donated_inputs`` / ``donatable_inputs``) have no
counterpart: eager PyTorch updates parameters and optimizer state in place,
there is no compiled program whose input buffers could be aliased to its
outputs, so there is nothing to count and the port's entries leave them out.

A pipeline arm is audited on every stage of one pipeline (one process group
per stage rank, in turn) and reports the pipeline's sums, so its ``send``
count is the pipeline's messages. The budgets live in
``configs/collective_budgets_torch.json`` (``backend: "torch"``, the torch
version and the world size of the roster stamped in): counts are a property
of the torch version and the port's code, so a torch upgrade may move them;
regenerate with ``--update-budgets`` and review the diff like a lockfile.

The audit never touches a GPU: every arm is built with ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import io
import json
import math
import os
import warnings
import weakref
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

REPO_ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "..", ".."))
DEFAULT_BUDGETS_PATH = os.path.join(REPO_ROOT, "configs", "collective_budgets_torch.json")

#: The collective classes the audit counts, in report order.
COLLECTIVE_OPS = (
    "all-gather",
    "reduce-scatter",
    "all-reduce",
    "send",
    "recv",
    "all-to-all",
)

#: ``c10d`` op name -> class (any other ``c10d`` op counts as "other").
_C10D_CLASS = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather", "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter", "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "send": "send", "recv_": "recv", "recv_any_source_": "recv",
}

_INJECTIONS = (
    "bad-kv-spec", "bad-fsdp-axis", "bad-pipeline-spec",
    "bad-forward-gather", "bad-cmm-ring",
)


@dataclasses.dataclass(frozen=True)
class ArmSpec:
    """One auditable arm: strategy x model family x mesh geometry.

    The fields are JAX's. ``config_overrides`` is a tuple of (key, value)
    pairs (hashable): ``attention_impl``, ``n_experts``,
    ``tp_collective_matmul``, ``dropout``, ``n_layer``, and ``scan_layers``
    False (the port's layer loop is the unrolled one; True is refused).
    ``inject`` turns on one of the seed bugs the audit must flag
    (:func:`_injected`). ``pipeline_schedule`` / ``virtual_stages`` matter
    only with a ``pipe`` axis wider than 1.
    """

    name: str
    strategy: str
    mesh_shape: Tuple[int, ...]
    axes: Tuple[str, ...]
    global_batch: int
    model_family: str = "tinygpt"
    tier: str = "S"
    seq_len: int = 64
    grad_accum: int = 1
    config_overrides: Tuple[Tuple[str, Any], ...] = ()
    inject: Optional[str] = None
    pipeline_schedule: str = "gpipe"
    virtual_stages: int = 1

    def width(self, axis: str) -> int:
        return dict(zip(self.axes, self.mesh_shape)).get(axis, 1)

    @property
    def world(self) -> int:
        return math.prod(self.mesh_shape)


@dataclasses.dataclass(frozen=True)
class ArmReport:
    """Structured audit result for one arm: everything the budget pins."""

    arm: str
    collectives: Mapping[str, int]
    collective_bytes: Mapping[str, int]
    # class -> {group size (str): count}
    group_sizes: Mapping[str, Mapping[str, int]]
    replication_reshard_suspects: int
    bf16_to_f32_converts: int
    # Pipeline arms: the pipeline's sends per direction ("fwd", "bwd").
    messages: Optional[Mapping[str, int]] = None

    def to_budget_entry(self) -> Dict[str, Any]:
        entry = {
            "collectives": dict(self.collectives),
            "collective_bytes": dict(self.collective_bytes),
            "group_sizes": {k: dict(v) for k, v in self.group_sizes.items()},
            "replication_reshard_suspects": self.replication_reshard_suspects,
            "bf16_to_f32_converts": self.bf16_to_f32_converts,
        }
        if self.messages is not None:
            entry["messages"] = dict(self.messages)
        return entry


@dataclasses.dataclass(frozen=True)
class MemoryReport:
    """One arm's resident state and step peak on rank 0: what GC110 pins.

    ``argument_bytes`` (JAX's name: the step's arguments) is the state the
    step carries, parameters, gradients and optimizer state, as the local
    shards' bytes (a DTensor's local tensor; distinct storages once).
    ``peak_bytes`` is that state plus the most bytes of tensors the step
    allocated that were alive at once, from a live-storage tracker in the
    dispatch mode; ``temp_bytes`` is the peak less the state. JAX's
    ``output_bytes`` and ``alias_bytes`` describe a compiled program's
    buffers, which eager PyTorch does not have. ``estimate_bytes`` is the
    port's memory model (``utils/memory.estimate_hbm``) for the same arm,
    recorded beside the measurement (not pinned).
    """

    arm: str
    argument_bytes: int
    temp_bytes: int
    peak_bytes: int
    estimate_bytes: int = 0

    @property
    def estimate_drift_frac(self) -> Optional[float]:
        if not self.peak_bytes:
            return None
        return round((self.estimate_bytes - self.peak_bytes) / self.peak_bytes, 4)

    def to_budget_entry(self) -> Dict[str, Any]:
        return {
            "argument_bytes": self.argument_bytes,
            "temp_bytes": self.temp_bytes,
            "peak_bytes": self.peak_bytes,
            "estimate_bytes": self.estimate_bytes,
            "estimate_drift_frac": self.estimate_drift_frac,
        }


#: The audit roster: JAX's (``hlo_audit.ROSTER``), arm for arm, at tier S /
#: seq 64 over 8 ranks, but ``llama-fsdp-dp4-tp2-scan``: the port has no
#: scan layer loop (ROADMAP Queue 1 item 0, ``--layer-loop``).
ROSTER: Dict[str, ArmSpec] = {
    spec.name: spec
    for spec in (
        # The pure-strategy matrix at dp=8.
        ArmSpec("ddp-dp8", "ddp", (8,), ("data",), global_batch=16),
        ArmSpec("fsdp-dp8", "fsdp", (8,), ("data",), global_batch=16),
        ArmSpec("zero2-dp8", "zero2", (8,), ("data",), global_batch=16),
        ArmSpec("zero3-dp8", "zero3", (8,), ("data",), global_batch=16),
        # llama x tensor parallel, the GQA arm: tier S llama has one kv head,
        # which 'model' width 2 does not split, so wkv stays replicated and
        # its gradient is summed over 'model' (no gather: `--inject
        # bad-kv-spec` brings the misaligned split's gather back).
        ArmSpec(
            "llama-tp2-gqa", "ddp", (1, 1, 2), ("data", "seq", "model"),
            global_batch=2, model_family="llama",
        ),
        # llama x fsdp x tp: FSDP2 over 'data' of each 'model' index
        # (`--inject bad-fsdp-axis` shards over the whole group instead).
        ArmSpec(
            "llama-fsdp-dp4-tp2", "fsdp", (4, 1, 2), ("data", "seq", "model"),
            global_batch=8, model_family="llama",
            config_overrides=(("scan_layers", False),),
        ),
        # llama x tp with the collective matmul: the ring's sends and
        # receives are the budgeted schedule (`--inject bad-cmm-ring` puts
        # the bulk all-gather / reduce-scatter back).
        ArmSpec(
            "llama-tp2-gqa-cmm", "ddp", (1, 1, 2), ("data", "seq", "model"),
            global_batch=2, model_family="llama",
            config_overrides=(("tp_collective_matmul", True),),
        ),
        # Sequence parallel: the ring's hops are the budgeted schedule.
        ArmSpec(
            "zero2-sp4-ring", "zero2", (1, 4, 1), ("data", "seq", "model"),
            global_batch=2,
            config_overrides=(("attention_impl", "ring"),),
        ),
        # Expert parallel: the MoE dispatch / combine all-to-alls.
        ArmSpec(
            "zero2-ep2-moe", "zero2", (4, 1, 1, 1, 2),
            ("data", "seq", "model", "pipe", "expert"),
            global_batch=16,
            config_overrides=(("n_experts", 4),),
        ),
    )
}

#: JAX roster arms the port does not audit, with the reason.
NOT_AUDITED = {
    "llama-fsdp-dp4-tp2-scan": "the port has no scan layer loop (ROADMAP Queue 1 item 0)",
}


# ---------------------------------------------------------------------------
# The fake group and the counting mode
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0) -> Iterator[None]:
    """A ``fake`` process group of ``world`` ranks in which this process is
    ``rank``, destroyed on exit (one default group per process at a time)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("the collective audit needs a process without a process group")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _group_of(args) -> Any:
    for a in args:
        if isinstance(a, torch.ScriptObject) and "ProcessGroup" in str(a._type()):
            return dist.ProcessGroup.unbox(a)
    return None


def _tensors(tree) -> List[Any]:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _local(t):
    return getattr(t, "_local_tensor", t)


def _storage_key(t) -> Tuple[int, int]:
    st = _local(t).untyped_storage()
    return st.data_ptr(), st.nbytes()


def _fill(name: str, args, group_rank: int) -> None:
    """The locally consistent result of one collective (see the module
    docstring), written into its outputs."""

    def tile(out, inp):  # every rank held this rank's input
        out.view(-1).copy_(inp.reshape(-1).repeat(out.numel() // max(inp.numel(), 1)))

    def block(out, inp):  # this rank's block of its own input
        k = out.numel()
        out.view(-1).copy_(inp.reshape(-1)[group_rank * k:(group_rank + 1) * k])

    def same(out, inp):
        if out.numel() == inp.numel():
            out.view(-1).copy_(inp.reshape(-1))
        else:
            out.zero_()

    if name == "allgather_":
        for out_list, inp in zip(args[0], args[1]):
            for out in out_list:
                out.copy_(inp)
    elif name == "reduce_scatter_":
        for out, in_list in zip(args[0], args[1]):
            out.copy_(in_list[group_rank])
    elif name in ("_allgather_base_", "_reduce_scatter_base_", "alltoall_base_"):
        {"_allgather_base_": tile, "_reduce_scatter_base_": block,
         "alltoall_base_": same}[name](args[0], args[1])
    elif name in ("allgather_into_tensor_coalesced_", "reduce_scatter_tensor_coalesced_",
                  "alltoall_"):
        op = {"allgather_into_tensor_coalesced_": tile,
              "reduce_scatter_tensor_coalesced_": block, "alltoall_": same}[name]
        for out, inp in zip(args[0], args[1]):
            op(out, inp)
    elif name in ("recv_", "recv_any_source_"):
        for t in args[0]:
            t.zero_()


def _completed(result, args):
    """``result`` of a fake-group op with its ``Work`` replaced by a
    completed one whose future holds the op's output."""
    from torch._C._distributed_c10d import _create_work_from_future

    def work(value):
        fut = torch.futures.Future()
        fut.set_result(value)
        return _create_work_from_future(fut).boxed()

    if isinstance(result, tuple):
        return tuple(work(result[0]) if isinstance(x, torch.ScriptObject) else x
                     for x in result)
    if isinstance(result, torch.ScriptObject):
        return work(args[0] if isinstance(args[0], (list, torch.Tensor)) else [])
    return result


class _GroupClasses:
    """The rank sets the mesh made, by axis, to judge a collective's group,
    and what the arm's layout makes legitimate (``spec``: its collective
    matmul, its ring or pipeline)."""

    def __init__(self, mesh, spec: "ArmSpec"):

        def ranks(g):
            return None if g is None else frozenset(dist.get_process_group_ranks(g))

        self.world = frozenset(range(dist.get_world_size()))
        self.axes: Dict[frozenset, str] = {}
        for name, g in (("world", mesh.group), ("replica", mesh.arm_group),
                        ("batch", mesh.batch_group), ("expert", mesh.expert_group),
                        ("pipe", mesh.pipe_group), ("model", mesh.model_group),
                        ("seq", mesh.seq_group), ("data", mesh.data_group)):
            r = ranks(g)
            if r is not None:
                self.axes[r] = name  # the narrowest name wins for a shared set
        replica = ranks(mesh.arm_group)
        self.replicas_narrower = replica is not None and len(replica) < len(self.world)
        self.cmm = bool(dict(spec.config_overrides).get("tp_collective_matmul"))
        self.p2p_legit = spec.width("seq") > 1 or spec.width("pipe") > 1 or self.cmm

    def suspect(self, cls: str, group_ranks: frozenset, numel: int) -> bool:
        axis = self.axes.get(group_ranks)
        if axis is None:
            return True  # a group the mesh did not make
        if axis == "world" and self.replicas_narrower and numel > 1:
            return True  # the whole group where the arm's replicas are fewer
        if cls == "all-gather" and axis == "model" and not self.cmm:
            return True  # a model-sharded leaf or stream replicated
        if cls in ("send", "recv") and not self.p2p_legit:
            return True
        return False


class _AuditMode(TorchDispatchMode):
    """The dispatch mode of one step: counts each ``c10d`` op (``classes``
    judges its group; None: fill only, for the uncounted steps), fills its
    outputs and completes its work; counts bf16 -> fp32 casts; tracks the
    storages the step allocates (``live``, ``peak_new``, ``allocated``)."""

    _TO_COPY = torch.ops.aten._to_copy.default
    _COPY = torch.ops.aten.copy_.default

    def __init__(self, classes: Optional[_GroupClasses]):
        super().__init__()
        self.classes = classes
        self.counts = {op: 0 for op in COLLECTIVE_OPS}
        self.counts["other"] = 0
        self.bytes = {op: 0 for op in self.counts}
        self.sizes: Dict[str, Dict[str, int]] = {}
        self.suspects = 0
        self.converts = 0
        self.messages = {"fwd": 0, "bwd": 0}
        self.live: Dict[int, int] = {}
        self.live_bytes = 0
        self.peak_new = 0
        self.allocated: set = set()

    def _free(self, key: int) -> None:
        n = self.live.pop(key, None)
        if n is not None:
            self.live_bytes -= n

    def _track(self, out, args) -> None:
        """Register each output storage that is new (not an input's: a view
        or an in-place result allocates nothing)."""
        seen = {_storage_key(t)[0] for t in _tensors(args)}
        for t in _tensors(out):
            st = _local(t).untyped_storage()
            key = st.data_ptr()
            if key in seen or key in self.live or st.nbytes() == 0:
                continue
            self.live[key] = st.nbytes()
            self.allocated.add(key)
            self.live_bytes += st.nbytes()
            self.peak_new = max(self.peak_new, self.live_bytes)
            weakref.finalize(st, self._free, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func.namespace == "c10d":
            return self._collective(func, args, kwargs)
        if (func is self._TO_COPY and args[0].dtype == torch.bfloat16
                and kwargs.get("dtype") == torch.float32):
            self.converts += 1
        elif (func is self._COPY and args[0].dtype == torch.float32
              and args[1].dtype == torch.bfloat16):
            self.converts += 1
        out = func(*args, **kwargs)
        self._track(out, args)
        return out

    def _collective(self, func, args, kwargs):
        name = func._opname
        cls = _C10D_CLASS.get(name, "other")
        pg = _group_of(args)
        size = pg.size() if pg is not None else 1
        # The bytes an op moves: its inputs (an all-gather's and a
        # reduce-scatter's are the second argument, the rest's the first; a
        # barrier has none).
        moved = _tensors(args[1] if cls in ("all-gather", "reduce-scatter")
                         else args[0]) if args else []
        self.counts[cls] += 1
        self.bytes[cls] += sum(t.numel() * t.element_size() for t in moved)
        per = self.sizes.setdefault(cls, {})
        per[str(size)] = per.get(str(size), 0) + 1
        group_rank = 0
        if pg is not None:
            group_rank = dist.get_group_rank(pg, dist.get_rank())
            if self.classes is not None and self.classes.suspect(
                    cls, frozenset(dist.get_process_group_ranks(pg)),
                    sum(t.numel() for t in moved)):
                self.suspects += 1
        if cls == "send":
            # The pipeline tags a message with its direction.
            self.messages["bwd" if args[3] == 1 else "fwd"] += 1
        result = func(*args, **kwargs)
        _fill(name, args, group_rank)
        # The fake group's own work serves a point-to-point op (its waits
        # take a timeout); a collective's needs its output.
        return result if cls in ("send", "recv") else _completed(result, args)


# ---------------------------------------------------------------------------
# Building and stepping one arm
# ---------------------------------------------------------------------------

#: Uncounted steps before the audited one: the first runs the lazy
#: initialisations (FSDP2's, AdamW's state), the second DDP's one-off bucket
#: rebuild (a broadcast), so the third is the steady state.
WARM_STEPS = 2

_OVERRIDE_KEYS = ("attention_impl", "n_experts", "tp_collective_matmul", "dropout",
                  "n_layer", "scan_layers")


def _build_kwargs(spec: ArmSpec) -> Dict[str, Any]:
    """``train.loop.build_run``'s arguments for the arm."""
    over = dict(spec.config_overrides)
    unknown = sorted(set(over) - set(_OVERRIDE_KEYS))
    if unknown:
        raise ValueError(f"arm {spec.name!r}: config overrides {unknown} have no port "
                         f"counterpart (known: {list(_OVERRIDE_KEYS)})")
    if over.get("scan_layers"):
        raise ValueError(f"arm {spec.name!r}: the port has no scan layer loop "
                         "(ROADMAP Queue 1 item 0)")
    members = spec.width("data") * spec.width("expert")
    if spec.global_batch % members:
        raise ValueError(f"arm {spec.name!r}: global batch {spec.global_batch} does not "
                         f"split over data x expert = {members}")
    kw = dict(
        strategy=spec.strategy, tier=spec.tier, seq_len=spec.seq_len,
        model_family=spec.model_family, per_device_batch=spec.global_batch // members,
        grad_accum=spec.grad_accum, device="cpu", world_size=spec.world,
        # Dropout adds RNG ops and no collectives; the audit pins the
        # schedule, so arms run dropout-free unless they name a rate (JAX's).
        dropout=float(over.get("dropout", 0.0)),
        attention_impl=over.get("attention_impl", "flash"),
        sequence_parallel=spec.width("seq"), tensor_parallel=spec.width("model"),
        tp_collective_matmul=bool(over.get("tp_collective_matmul", False)),
        n_experts=int(over.get("n_experts", 0)), expert_parallel=spec.width("expert"),
        pipeline_parallel=spec.width("pipe"), pipeline_schedule=spec.pipeline_schedule,
        virtual_stages=spec.virtual_stages, dataset_size=64,
    )
    if "n_layer" in over:
        kw["n_layer"] = int(over["n_layer"])
    return kw


def _state_storages(run) -> Dict[int, int]:
    """Distinct storages (data_ptr -> bytes) of the parameters, gradients and
    optimizer state of rank 0's arm (local shards)."""
    out: Dict[int, int] = {}

    def add(t):
        if isinstance(t, torch.Tensor):
            key, n = _storage_key(t)
            if n:
                out[key] = n

    opt = run.step_fn.optimizer
    # The model's leaves and the optimizer's (zero2's are shards of flat
    # buffers the model's leaves are views into).
    for p in list(run.model.parameters()) + list(opt.params):
        add(p)
        add(p.grad)
    if opt.adamw is not None:
        for st in opt.adamw.state.values():
            for v in st.values():
                add(v)
    return out


@dataclasses.dataclass
class _RankResult:
    counts: Dict[str, int]
    bytes: Dict[str, int]
    sizes: Dict[str, Dict[str, int]]
    suspects: int
    converts: int
    messages: Dict[str, int]
    memory: Optional[MemoryReport]


def _audit_rank(spec: ArmSpec, rank: int) -> _RankResult:
    """Build the arm as ``rank`` of a fake group, run ``WARM_STEPS``
    uncounted steps and count the next one."""
    from ...train.loop import build_run

    with fake_group(spec.world, rank), _injected(spec), warnings.catch_warnings(), \
            contextlib.redirect_stdout(io.StringIO()):
        warnings.simplefilter("ignore")
        run = build_run(**_build_kwargs(spec))
        classes = _GroupClasses(run.mesh, spec)
        with _AuditMode(None):  # a fake group's collectives need the fills
            for step in range(WARM_STEPS):
                run.step_fn(run.table, step)
        before = _state_storages(run)
        mode = _AuditMode(classes)
        with mode:
            loss = run.step_fn(run.table, WARM_STEPS)
        if not torch.isfinite(loss).all():
            raise RuntimeError(f"arm {spec.name!r}: the audited step's loss is not finite")
        after = _state_storages(run)
        # Storages that hold state at the end but were neither allocated by
        # the step nor state at its start (DDP's grad buckets) were resident.
        base = dict(before)
        base.update({k: n for k, n in after.items() if k not in mode.allocated})
        argument = sum(after.values())
        peak = sum(base.values()) + mode.peak_new
        estimate = run.estimate.total if run.estimate is not None else 0
        memory = MemoryReport(spec.name, argument_bytes=argument,
                              temp_bytes=max(peak - argument, 0), peak_bytes=peak,
                              estimate_bytes=int(estimate))
        del run, loss
    return _RankResult(dict(mode.counts), dict(mode.bytes),
                       {k: dict(v) for k, v in mode.sizes.items()}, mode.suspects,
                       mode.converts, dict(mode.messages), memory)


def stage_ranks(spec: ArmSpec) -> Tuple[int, ...]:
    """The ranks the audit plays: rank 0, or, with a ``pipe`` axis wider
    than 1, the stages of rank 0's pipeline (``expert`` width apart, as
    ``parallel/mesh.py`` orders the ranks)."""
    pp = spec.width("pipe")
    return tuple(s * spec.width("expert") for s in range(pp)) if pp > 1 else (0,)


@functools.lru_cache(maxsize=64)
def _audit(spec: ArmSpec) -> Tuple[ArmReport, MemoryReport]:
    if spec.inject is not None and spec.inject not in _INJECTIONS:
        raise ValueError(f"arm {spec.name!r}: unknown injection {spec.inject!r} "
                         f"(expected one of {_INJECTIONS})")
    results = [_audit_rank(spec, r) for r in stage_ranks(spec)]
    keys = list(COLLECTIVE_OPS) + ["other"]
    sizes: Dict[str, Dict[str, int]] = {}
    for res in results:
        for cls, per in res.sizes.items():
            acc = sizes.setdefault(cls, {})
            for k, n in per.items():
                acc[k] = acc.get(k, 0) + n
    report = ArmReport(
        arm=spec.name,
        collectives={k: sum(r.counts[k] for r in results) for k in keys},
        collective_bytes={k: sum(r.bytes[k] for r in results) for k in keys},
        group_sizes={k: dict(sorted(v.items(), key=lambda kv: int(kv[0])))
                     for k, v in sorted(sizes.items())},
        replication_reshard_suspects=sum(r.suspects for r in results),
        bf16_to_f32_converts=sum(r.converts for r in results),
        messages=({d: sum(r.messages[d] for r in results) for d in ("fwd", "bwd")}
                  if spec.width("pipe") > 1 else None),
    )
    return report, results[0].memory


def audit_arm(spec: ArmSpec) -> ArmReport:
    """Build one arm on a fake group, step it, and return its collective
    report (a pipeline arm: summed over the stages of one pipeline)."""
    return _audit(spec)[0]


def audit_arm_memory(spec: ArmSpec) -> MemoryReport:
    """Rank 0's resident state and step peak of one arm (the same step
    :func:`audit_arm` counts; the two share one run)."""
    return _audit(spec)[1]


# ---------------------------------------------------------------------------
# The seed bugs (`--inject`): patches active only inside the audited arm
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def _patched(obj, name: str, value) -> Iterator[None]:
    real = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, real)


@contextlib.contextmanager
def _injected(spec: ArmSpec) -> Iterator[None]:
    """The arm's seed bug, if it names one; each is a structural regression
    with the same values, as JAX's ``_with_bad_*`` wrappers are:

    - ``bad-kv-spec``: llama's K/V projection under tensor parallelism split
      by columns over ``model`` (half a kv head per rank at tier S) and its
      output gathered over ``model`` to rebuild every head: the
      misaligned split's full-replicate reshard that the kv-head-aligned
      rule (``parallel/strategies.kv_aligned``) exists to avoid;
    - ``bad-fsdp-axis``: FSDP2 sharding over the whole group instead of
      ``data`` (``parallel/strategies.shard_data_mesh``);
    - ``bad-forward-gather``: fsdp / zero3 gathering every block once before
      the forward, on top of each block's own gather;
    - ``bad-cmm-ring``: the collective matmul's ring replaced by a bulk
      all-gather of the stream and a reduce to this rank's chunk;
    - ``bad-pipeline-spec``: one extra message per micro-batch from every
      stage but the last.
    """
    name = spec.inject
    if name is None:
        yield
    elif name == "bad-kv-spec":
        with _bad_kv_spec():
            yield
    elif name == "bad-fsdp-axis":
        with _bad_fsdp_axis():
            yield
    elif name == "bad-forward-gather":
        with _bad_forward_gather():
            yield
    elif name == "bad-cmm-ring":
        with _bad_cmm_ring():
            yield
    elif name == "bad-pipeline-spec":
        with _bad_pipeline_spec():
            yield
    else:
        raise ValueError(f"unknown injection {name!r} (expected one of {_INJECTIONS})")


def _bad_kv_spec():

    from ...models import tinygpt
    from ...parallel.tensor import all_gather_dim

    real = tinygpt.Block._col

    def col(self, h, w, b=None):
        wkv = getattr(self, "wkv", None)
        if (self.group is None or self.cmm or self.kv_sharded or wkv is None
                or w.data_ptr() != wkv.data_ptr()):
            return real(self, h, w, b)
        m, t = dist.get_rank(self.group), dist.get_world_size(self.group)
        cols = w.shape[-1] // t
        part = real(self, h, w[..., m * cols:(m + 1) * cols],
                    None if b is None else b[..., m * cols:(m + 1) * cols])
        return all_gather_dim(part, self.group, part.dim() - 1)

    return _patched(tinygpt.Block, "_col", col)


def _bad_fsdp_axis():
    from torch.distributed.device_mesh import init_device_mesh

    from ...parallel import strategies

    def whole_group(mesh):
        return init_device_mesh(mesh.device_mesh.device_type, (dist.get_world_size(),),
                                mesh_dim_names=("data",))

    return _patched(strategies, "shard_data_mesh", whole_group)


def _bad_forward_gather():
    from torch.distributed.fsdp import FSDPModule

    from ...models import tinygpt

    real = tinygpt.TinyGPT.forward

    def forward(self, *args, **kwargs):
        for block in self.blocks:
            if isinstance(block, FSDPModule):
                block.unshard()
                block.reshard()
        return real(self, *args, **kwargs)

    return _patched(tinygpt.TinyGPT, "forward", forward)


@contextlib.contextmanager
def _bad_cmm_ring():
    from ...models import tinygpt
    from ...ops.collective_matmul import proj_f32
    from ...parallel.tensor import all_gather_seq, reduce_scatter_seq

    def ag(x, w, group):
        return proj_f32(all_gather_seq(x, group), w).to(x.dtype)

    def rs(y, w, group):
        return reduce_scatter_seq(proj_f32(y, w), group).to(y.dtype)

    with _patched(tinygpt, "ag_proj_sharded", ag), _patched(tinygpt, "rs_proj_sharded", rs):
        yield


def _bad_pipeline_spec():
    from ...parallel import pipeline

    real = pipeline.Pipeline.run

    def run(self, call, optimizer, batch, *args, **kwargs):
        out = real(self, call, optimizer, batch, *args, **kwargs)
        if self.stage < self.stages - 1:
            extra = torch.zeros(1, device=batch.device)
            for _ in range(self.microbatches):
                self.transport.post([(pipeline.FWD, extra)], [])
            self.transport.flush()
        return out

    return _patched(pipeline.Pipeline, "run", run)


# ---------------------------------------------------------------------------
# Pipeline schedule audit: the message and bubble laws
# ---------------------------------------------------------------------------

#: Pipeline arms: JAX's (``hlo_audit.PIPELINE_ROSTER``), at dp=2 x pipe=2
#: with live dropout (0.1, as JAX's), the interleaved arm at V=2 over 4
#: layers. Each is audited at its M and at M * ``PIPELINE_GROWTH_M_FACTOR``.
PIPELINE_ROSTER: Dict[str, ArmSpec] = {
    spec.name: spec
    for spec in (
        ArmSpec(
            "pp2-gpipe", "ddp", (2, 1, 1, 2),
            ("data", "seq", "model", "pipe"),
            global_batch=4, grad_accum=4, pipeline_schedule="gpipe",
            config_overrides=(("dropout", 0.1),),
        ),
        ArmSpec(
            "pp2-1f1b", "ddp", (2, 1, 1, 2),
            ("data", "seq", "model", "pipe"),
            global_batch=4, grad_accum=4, pipeline_schedule="1f1b",
            config_overrides=(("dropout", 0.1),),
        ),
        ArmSpec(
            "pp2-interleaved-v2", "ddp", (2, 1, 1, 2),
            ("data", "seq", "model", "pipe"),
            global_batch=4, grad_accum=4, pipeline_schedule="interleaved",
            virtual_stages=2,
            config_overrides=(("dropout", 0.1), ("n_layer", 4)),
        ),
        ArmSpec(
            "llama-pp2-1f1b", "ddp", (2, 1, 1, 2),
            ("data", "seq", "model", "pipe"),
            global_batch=4, grad_accum=4, model_family="llama",
            pipeline_schedule="1f1b",
            config_overrides=(("dropout", 0.1),),
        ),
    )
}

#: Second microbatch count each pipeline arm is audited at: the growth
#: law needs two M points.
PIPELINE_GROWTH_M_FACTOR = 2


def _virtual(spec: ArmSpec) -> int:
    return spec.virtual_stages if spec.pipeline_schedule == "interleaved" else 1


def expected_pipeline_messages(schedule: str, stages: int, microbatches: int,
                               virtual: int = 1) -> int:
    """The pipeline's sends per step over both directions:
    ``2 * parallel.pipeline.expected_messages`` = 2·M·(P·V − 1).

    JAX's law (``expected_pipeline_permutes``) counts HLO instructions, each
    moving every stage's payload one hop: 2·(M+S−2) for gpipe and 1f1b, a
    flat 2 for the scanned interleaved executor. The port sends only real
    messages (``parallel/pipeline.py``), so it counts sends. At P = 2 gpipe
    and 1f1b agree (2M both); interleaved does not (2·M·(2V−1) here against
    JAX's 2), and neither law is bent to meet the other.
    """
    from ...parallel.pipeline import expected_messages

    return 2 * expected_messages(schedule, stages, microbatches, virtual)


def pipeline_message_slope(schedule: str, stages: int, virtual: int = 1) -> int:
    """d(the pipeline's sends)/dM: 2·(P·V − 1) for every schedule."""
    return expected_pipeline_messages(schedule, stages, 1, virtual)


def pipeline_bubble_bound(schedule: str, stages: int, microbatches: int,
                          virtual: int = 1) -> float:
    """The schedule's structural bubble bound: the port's
    ``parallel.pipeline.pipeline_bubble_bound`` (JAX's formulas; the
    interleaved bound from the port's copy of ``build_schedule``)."""
    from ...parallel.pipeline import pipeline_bubble_bound as bound

    return bound(schedule, stages, microbatches, virtual)


@dataclasses.dataclass(frozen=True)
class PipelineAuditResult:
    """One pipeline arm's audit: reports at two M values and the law inputs.

    ``compile_error`` (both reports None) when the arm failed to build or
    step: for a pipeline arm that is a finding (the schedule-compiles law),
    as in JAX."""

    arm: str
    schedule: str
    stages: int
    microbatches: int
    virtual: int
    grown_microbatches: int
    base: Optional[ArmReport] = None
    grown: Optional[ArmReport] = None
    compile_error: Optional[str] = None

    def to_budget_entry(self) -> Dict[str, Any]:
        assert self.base is not None and self.grown is not None
        return {
            "schedule": {
                "schedule": self.schedule,
                "stages": self.stages,
                "microbatches": self.microbatches,
                "virtual": self.virtual,
                "grown_microbatches": self.grown_microbatches,
                "expected_messages": expected_pipeline_messages(
                    self.schedule, self.stages, self.microbatches, self.virtual),
                "bubble_frac_bound": round(pipeline_bubble_bound(
                    self.schedule, self.stages, self.microbatches, self.virtual), 6),
            },
            "base": self.base.to_budget_entry(),
            "grown": self.grown.to_budget_entry(),
        }


def audit_pipeline_arm(spec: ArmSpec) -> PipelineAuditResult:
    """Audit one pipeline arm at its M and at M * growth factor. The law
    inputs are ``parallel.pipeline.pipeline_schedule_meta``'s: M is
    ``grad_accum`` and only the interleaved schedule has V > 1."""
    pipe = spec.width("pipe")
    if pipe <= 1:
        raise ValueError(f"arm {spec.name!r} has no >1 'pipe' axis — not a pipeline arm")
    m2 = spec.grad_accum * PIPELINE_GROWTH_M_FACTOR
    meta = {"schedule": spec.pipeline_schedule, "stages": pipe,
            "microbatches": spec.grad_accum, "virtual": _virtual(spec)}
    try:
        base = audit_arm(spec)
        grown = audit_arm(dataclasses.replace(spec, grad_accum=m2))
    except Exception as e:
        msg = f"{type(e).__name__}: {e}"
        return PipelineAuditResult(arm=spec.name, grown_microbatches=m2,
                                   compile_error=msg[:500], **meta)
    return PipelineAuditResult(arm=spec.name, grown_microbatches=m2, base=base, grown=grown,
                               **meta)


def pipeline_law_findings(result: PipelineAuditResult) -> List[str]:
    """The schedule laws, each named per arm and law when broken:

    - **schedule-compiles**: the arm must build and step at all;
    - **message-law**: the pipeline's sends in each direction must equal
      ``parallel.pipeline.expected_messages`` at both audited M values (an
      excess message is the pipeline counterpart of a reshard suspect);
    - **affine-growth**: the sends must grow affinely in M with slope
      2·(P·V − 1) per microbatch (a superlinear term means per-microbatch
      traffic the schedule does not have).
    """
    from ...parallel.pipeline import expected_messages

    arm, sched = result.arm, result.schedule
    if result.compile_error is not None:
        return [
            f"schedule-law: {arm} VIOLATES schedule-compiles "
            f"[{sched} S={result.stages} M={result.microbatches} "
            f"V={result.virtual}]: {result.compile_error}"
        ]
    findings: List[str] = []
    for label, rep, m in (("base", result.base, result.microbatches),
                          ("grown", result.grown, result.grown_microbatches)):
        want = expected_messages(sched, result.stages, m, result.virtual)
        for direction in ("fwd", "bwd"):
            got = (rep.messages or {}).get(direction, 0)
            if got != want:
                findings.append(
                    f"schedule-law: {arm} VIOLATES message-law at {label} M={m}: {got} "
                    f"{direction} messages != closed-form {want} for {sched}"
                    f"(S={result.stages}, V={result.virtual}) — {max(got - want, 0)} excess "
                    "message(s) are pipeline reshard suspects"
                )
    d_got = result.grown.collectives.get("send", 0) - result.base.collectives.get("send", 0)
    d_m = result.grown_microbatches - result.microbatches
    slope = pipeline_message_slope(sched, result.stages, result.virtual)
    if d_got != slope * d_m:
        findings.append(
            f"schedule-law: {arm} VIOLATES affine-growth: sends grew {d_got:+d} over "
            f"{d_m:+d} microbatches (expected slope {slope}/microbatch for {sched})"
        )
    return findings


def diff_pipeline_against_budget(result: PipelineAuditResult,
                                 budgets: Dict[str, Any]) -> List[str]:
    """Law findings plus exact-pin diffs of one pipeline arm, at both M."""
    findings = pipeline_law_findings(result)
    if result.compile_error is not None:
        return findings
    arm_budget = budgets.get("pipeline_schedules", {}).get("arms", {}).get(result.arm)
    if arm_budget is None:
        return findings + [
            f"{result.arm}: no frozen pipeline_schedules budget for this "
            "arm (run --update-budgets to freeze one)"
        ]
    frozen_meta = dict(arm_budget.get("schedule", {}))
    live_meta = result.to_budget_entry()["schedule"]
    if frozen_meta != live_meta:
        findings.append(
            f"{result.arm}: schedule metadata drifted from the frozen "
            f"budget ({frozen_meta} != {live_meta}) — regenerate with "
            "--update-budgets and review"
        )
    for label, rep in (("base", result.base), ("grown", result.grown)):
        scoped = {"arms": {result.arm: arm_budget.get(label, {})}}
        findings.extend(f"{label}: {d}" for d in diff_against_budget(rep, scoped))
    return findings


# ---------------------------------------------------------------------------
# GC110: the memory audit
# ---------------------------------------------------------------------------

#: Slack the per-rank temp bytes may grow along ``data`` before the GC110
#: temp-flat law fires (JAX's).
MEMORY_TEMP_FLAT_TOL = 0.10


def arm_shards_state_over_data(arm_name: str) -> bool:
    """True when the arm's strategy shards params or optimizer state over
    ``data`` (fsdp / zero): its per-rank state must shrink as ``data`` grows."""
    from ...parallel.strategies import get_strategy

    spec = ROSTER.get(arm_name) or PIPELINE_ROSTER.get(arm_name)
    if spec is None:
        raise KeyError(f"unknown arm {arm_name!r}")
    strategy = get_strategy(spec.strategy)
    return bool(strategy.shard_params or strategy.shard_opt_state)


def diff_memory_against_budget(report: MemoryReport, budgets: Dict[str, Any],
                               arms_override: Optional[Dict[str, Any]] = None) -> List[str]:
    """GC110 exact-pin deltas of one arm (JAX's wording): growth of state,
    temp or peak bytes regresses, shrinkage is an improvement to bank."""
    arms = (arms_override if arms_override is not None
            else budgets.get("memory_budgets", {}).get("arms", {}))
    entry = arms.get(report.arm)
    if entry is None:
        return [
            f"GC110: {report.arm}: no frozen memory budget for this arm "
            "(run --memory --update-budgets to freeze one)"
        ]
    deltas: List[str] = []

    def check(label: str, got: int, want: int):
        if got == want:
            return
        delta = got - want
        pct = 100.0 * delta / want if want else float("inf")
        if delta > 0:
            deltas.append(f"GC110: {report.arm}: {label} REGRESSED {want} -> {got} "
                          f"({delta:+d} bytes, {pct:+.1f}%)")
        else:
            deltas.append(f"GC110: {report.arm}: {label} improved {want} -> {got} "
                          f"({delta:+d} bytes) — bank it with --memory --update-budgets")

    check("argument bytes", report.argument_bytes, entry["argument_bytes"])
    check("temp bytes", report.temp_bytes, entry["temp_bytes"])
    check("live-storage peak bytes", report.peak_bytes, entry["peak_bytes"])
    return deltas


def memory_growth_law_findings(per_tier: Dict[str, Dict[str, Dict[str, Any]]]) -> List[str]:
    """GC110's cross-tier laws (JAX's): per-rank temp bytes flat along
    ``data`` within :data:`MEMORY_TEMP_FLAT_TOL`, and fsdp / zero state
    strictly shrinking as ``data`` grows."""
    findings: List[str] = []
    tiers = sorted((t for t in per_tier if t in TOPOLOGY_TIERS),
                   key=lambda t: TOPOLOGY_TIERS[t].device_count)
    arms = sorted({a for t in tiers for a in per_tier[t]})
    for arm in arms:
        present = [t for t in tiers if arm in per_tier[t]]
        try:
            shrinks = arm_shards_state_over_data(arm)
        except KeyError:
            shrinks = False
        for lo, hi in zip(present, present[1:]):
            e_lo, e_hi = per_tier[lo][arm], per_tier[hi][arm]
            t_lo, t_hi = int(e_lo.get("temp_bytes", 0)), int(e_hi.get("temp_bytes", 0))
            if t_lo > 0 and t_hi > t_lo * (1.0 + MEMORY_TEMP_FLAT_TOL):
                findings.append(
                    f"GC110 growth-law: {arm} per-chip temp bytes grew "
                    f"{100.0 * (t_hi - t_lo) / t_lo:+.1f}% along the data "
                    f"axis ({lo}: {t_lo} -> {hi}: {t_hi}; weak scaling "
                    "must keep per-chip temps flat within "
                    f"{100 * MEMORY_TEMP_FLAT_TOL:.0f}%)"
                )
            if shrinks:
                a_lo, a_hi = int(e_lo.get("argument_bytes", 0)), int(e_hi.get("argument_bytes", 0))
                if a_lo > 0 and a_hi >= a_lo:
                    findings.append(
                        f"GC110 growth-law: {arm} per-chip argument bytes "
                        f"did not shrink along the fsdp/zero shard axis "
                        f"({lo}: {a_lo} -> {hi}: {a_hi}) — sharded "
                        "param/optimizer state is replicating instead of "
                        "sharding"
                    )
    return findings


def write_memory_budgets(reports: List[MemoryReport], path: str = DEFAULT_BUDGETS_PATH,
                         tier_reports: Optional[Dict[str, List[MemoryReport]]] = None
                         ) -> Dict[str, Any]:
    """Freeze GC110 budgets into the ``memory_budgets`` section, merging over
    the file (the other sections pass through)."""
    doc = load_budgets(path) if os.path.exists(path) else _empty_doc()
    section = dict(doc.get("memory_budgets", {}))
    arms = dict(section.get("arms", {}))
    _refuse_partial_across_versions(section, arms, {r.arm for r in reports},
                                    "memory_budgets", bool(reports))
    if section.get("torch_version") not in (None, _torch_version()) and reports:
        arms = {}
    for r in reports:
        arms[r.arm] = r.to_budget_entry()
    tiers = dict(section.get("topology_tiers", {}))
    for tier_name, reps in (tier_reports or {}).items():
        tiers[tier_name] = _tier_block(tier_name, {r.arm: r.to_budget_entry() for r in reps})
    doc["memory_budgets"] = {
        "torch_version": (_torch_version() if reports
                          else section.get("torch_version", _torch_version())),
        "arms": arms,
        "topology_tiers": tiers,
    }
    _dump(doc, path)
    return doc


def commensurable_memory_tiers(budgets: Dict[str, Any], fresh_tiers: Tuple[str, ...] = (),
                               torch_version: Optional[str] = None
                               ) -> Tuple[Dict[str, Dict[str, Dict[str, Any]]], List[str]]:
    """(per-tier memory entries with tiers frozen on another torch dropped,
    the dropped tier names)."""
    torch_version = torch_version or _torch_version()
    blocks = budgets.get("memory_budgets", {}).get("topology_tiers", {})
    stale = sorted(t for t, b in blocks.items() if t not in fresh_tiers
                   and b.get("torch_version") not in (None, torch_version))
    return ({t: dict(b.get("arms", {})) for t, b in blocks.items() if t not in stale}, stale)


# ---------------------------------------------------------------------------
# World tiers: the roster's scalable subset on fake groups of 16, 64, 256
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class TopologyTier:
    """One world the audit plays rank 0 of: ``nodes`` hosts of 8 H100s.
    JAX audits TPU topologies it compiles against (v5e-16/64/256); the port
    plays the same device counts on a fake group, so no card is needed."""

    name: str
    device_count: int
    nodes: int


TOPOLOGY_TIERS: Dict[str, TopologyTier] = {
    t.name: t
    for t in (
        TopologyTier("world-16", 16, 2),
        TopologyTier("world-64", 64, 8),
        TopologyTier("world-256", 256, 32),
    )
}

#: Roster arms audited per tier (JAX's ``TOPOLOGY_ARMS``): each scales its
#: ``data`` axis, and its global batch with it, to fill the tier.
TOPOLOGY_ARMS = (
    "zero2-dp8", "fsdp-dp8", "llama-tp2-gqa", "pp2-gpipe",
    "llama-tp2-gqa-cmm",
)

#: Tiers ``--all`` audits, as JAX's two default tiers.
TOPOLOGY_DEFAULT_TIERS = ("world-16", "world-64")


def scale_spec_to_devices(spec: ArmSpec, n_devices: int) -> ArmSpec:
    """The arm at a tier's device count: only ``data`` grows, and the global
    batch with it (JAX's rule, its refusals included)."""
    if "data" not in spec.axes:
        raise ValueError(f"arm {spec.name!r} has no 'data' axis to scale")
    di = spec.axes.index("data")
    other = math.prod(d for i, d in enumerate(spec.mesh_shape) if i != di)
    if n_devices % other:
        raise ValueError(
            f"arm {spec.name!r}: non-data axes fill {other} devices, which "
            f"does not divide the tier's {n_devices}"
        )
    new_data = n_devices // other
    old_data = spec.mesh_shape[di]
    if new_data % old_data and old_data % new_data:
        raise ValueError(f"arm {spec.name!r}: data axis {old_data} does not scale "
                         f"evenly to {new_data}")
    shape = list(spec.mesh_shape)
    shape[di] = new_data
    return dataclasses.replace(spec, mesh_shape=tuple(shape),
                               global_batch=max(spec.global_batch * new_data // old_data, 1))


def _tier_specs(tier: TopologyTier, arm_names: Optional[Tuple[str, ...]],
                inject: Optional[str]) -> List[ArmSpec]:
    specs = []
    for name in arm_names or TOPOLOGY_ARMS:
        spec = ROSTER.get(name) or PIPELINE_ROSTER[name]
        scaled = scale_spec_to_devices(spec, tier.device_count)
        if inject:
            scaled = dataclasses.replace(scaled, inject=inject)
        specs.append(scaled)
    return specs


def audit_topology_tier(tier: TopologyTier, arm_names: Optional[Tuple[str, ...]] = None,
                        inject: Optional[str] = None) -> List[ArmReport]:
    """The scalable roster subset at one tier's world size."""
    return [audit_arm(s) for s in _tier_specs(tier, arm_names, inject)]


def audit_topology_tier_memory(tier: TopologyTier, arm_names: Optional[Tuple[str, ...]] = None,
                               inject: Optional[str] = None) -> List[MemoryReport]:
    """Memory reports of the scalable roster subset at one tier."""
    return [audit_arm_memory(s) for s in _tier_specs(tier, arm_names, inject)]


def _tier_block(tier_name: str, arms: Dict[str, Any]) -> Dict[str, Any]:
    tier = TOPOLOGY_TIERS[tier_name]
    return {"device_count": tier.device_count, "nodes": tier.nodes,
            "torch_version": _torch_version(), "arms": arms}


def write_topology_budgets(tier_reports: Dict[str, List[ArmReport]],
                           path: str = DEFAULT_BUDGETS_PATH) -> Dict[str, Any]:
    """Freeze per-tier budgets into the ``world_tiers`` section, merging
    over the file: regenerating one tier never drops another's."""
    doc = load_budgets(path) if os.path.exists(path) else _empty_doc()
    topo = dict(doc.get("world_tiers", {}))
    for tier_name, reports in tier_reports.items():
        topo[tier_name] = _tier_block(tier_name, {r.arm: r.to_budget_entry() for r in reports})
    doc["world_tiers"] = topo
    _dump(doc, path)
    return doc


def diff_topology_against_budget(tier_name: str, reports: List[ArmReport],
                                 budgets: Dict[str, Any]) -> List[str]:
    """Per-tier exact-pin diffs, as :func:`diff_against_budget`."""
    tier_budget = budgets.get("world_tiers", {}).get(tier_name)
    if tier_budget is None:
        return [f"{tier_name}: no frozen world-tier budgets for this tier "
                f"(run --topology {tier_name} --update-budgets)"]
    scoped = {"arms": tier_budget.get("arms", {})}
    out: List[str] = []
    for rep in reports:
        out.extend(f"{tier_name}/{d}" for d in diff_against_budget(rep, scoped))
    return out


def growth_law_findings(per_tier: Dict[str, Dict[str, Dict[str, Any]]]) -> List[str]:
    """JAX's cross-tier laws: reshard suspects stay 0 at every tier, and no
    class's count grows faster than the device ratio between two tiers (or
    appears from zero)."""
    findings: List[str] = []
    tiers = sorted((t for t in per_tier if t in TOPOLOGY_TIERS),
                   key=lambda t: TOPOLOGY_TIERS[t].device_count)
    arms = sorted({a for t in tiers for a in per_tier[t]})
    for arm in arms:
        present = [t for t in tiers if arm in per_tier[t]]
        for t in present:
            suspects = int(per_tier[t][arm].get("replication_reshard_suspects", 0))
            if suspects > 0:
                findings.append(
                    f"growth-law: {arm}@{t} has {suspects} full-replication "
                    "reshard suspect(s) — reshard suspects must stay 0 "
                    "across topology tiers (a reshard's cost grows with "
                    "the mesh)"
                )
        for lo, hi in zip(present, present[1:]):
            ratio = TOPOLOGY_TIERS[hi].device_count / TOPOLOGY_TIERS[lo].device_count
            lo_c = per_tier[lo][arm].get("collectives", {})
            hi_c = per_tier[hi][arm].get("collectives", {})
            for op in COLLECTIVE_OPS:
                n_lo, n_hi = int(lo_c.get(op, 0)), int(hi_c.get(op, 0))
                if n_lo == 0 and n_hi > 0:
                    findings.append(
                        f"growth-law: {arm} {op} appears from zero "
                        f"({lo}: 0 -> {hi}: {n_hi}) — a collective the "
                        "small mesh never needed is growing with the mesh"
                    )
                elif n_lo > 0 and n_hi > n_lo * ratio:
                    findings.append(
                        f"growth-law: {arm} {op} grows superlinearly in "
                        f"the data axis ({lo}: {n_lo} -> {hi}: {n_hi}; "
                        f"linear ceiling {int(n_lo * ratio)} at "
                        f"{ratio:g}x devices)"
                    )
    return findings


def commensurable_topology_tiers(budgets: Dict[str, Any], fresh_tiers: Tuple[str, ...] = (),
                                 torch_version: Optional[str] = None
                                 ) -> Tuple[Dict[str, Any], List[str]]:
    """(budgets view without the tiers frozen on another torch, those tiers)."""
    torch_version = torch_version or _torch_version()
    blocks = budgets.get("world_tiers", {})
    stale = sorted(t for t, b in blocks.items() if t not in fresh_tiers
                   and b.get("torch_version") not in (None, torch_version))
    if not stale:
        return budgets, []
    kept = {t: b for t, b in blocks.items() if t not in stale}
    return dict(budgets, world_tiers=kept), stale


def assemble_per_tier(budgets: Dict[str, Any], fresh: Optional[Dict[str, List[ArmReport]]] = None
                      ) -> Dict[str, Dict[str, Dict[str, Any]]]:
    """Frozen world-tier budgets overlaid with fresh reports, for the laws."""
    per_tier = {t: dict(block.get("arms", {}))
                for t, block in budgets.get("world_tiers", {}).items()}
    for tier_name, reports in (fresh or {}).items():
        per_tier.setdefault(tier_name, {}).update(
            {rep.arm: rep.to_budget_entry() for rep in reports})
    return per_tier


# ---------------------------------------------------------------------------
# Budget file I/O and diffing
# ---------------------------------------------------------------------------


def _torch_version() -> str:
    return torch.__version__


def _empty_doc() -> Dict[str, Any]:
    return {"arms": {}}


def _dump(doc: Dict[str, Any], path: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")


def _refuse_partial_across_versions(section: Dict[str, Any], arms: Dict[str, Any],
                                    regenerated: set, what: str, active: bool) -> None:
    frozen = section.get("torch_version")
    if active and frozen is not None and frozen != _torch_version():
        stale = set(arms) - regenerated
        if stale:
            raise ValueError(
                f"{what} were frozen on torch {frozen} but this is torch {_torch_version()}: "
                "a partial regeneration would mix incomparable counts — regenerate the full "
                f"roster (missing: {sorted(stale)})")


def load_budgets(path: str = DEFAULT_BUDGETS_PATH) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def write_budgets(reports: List[ArmReport], path: str = DEFAULT_BUDGETS_PATH,
                  existing: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Freeze ``reports`` into the ``arms`` section, merging over
    ``existing`` so a partial ``--arms`` regeneration keeps the other arms
    and every other section. Deterministic serialization (sorted keys)."""
    doc: Dict[str, Any] = {
        "_comment": (
            "Frozen per-arm collective and memory budgets of the PyTorch port — regenerate "
            "with `python -m distributed_llm_training_benchmark_framework_tpu_torch"
            ".analysis.static --update-budgets` (and --memory --update-budgets, "
            "--topology TIERS --update-budgets) and review the diff. Counted on a fake "
            "process group on the CPU; see analysis/static/collective_audit.py."
        ),
        "backend": "torch",
        "torch_version": _torch_version(),
        "world_size": 8,
        "arms": dict((existing or {}).get("arms", {})),
    }
    for section in ("pipeline_schedules", "memory_budgets", "world_tiers"):
        if existing is not None and existing.get(section):
            doc[section] = existing[section]
    if existing is not None:
        frozen = existing.get("torch_version")
        if frozen is not None and frozen != _torch_version():
            kept = set(existing.get("arms", {}))
            regenerated = {rep.arm for rep in reports}
            if kept - regenerated:
                raise ValueError(
                    f"budgets were frozen on torch {frozen} but this is torch "
                    f"{_torch_version()}: a partial --arms regeneration "
                    "would mix incomparable counts — regenerate the full "
                    f"roster (missing: {sorted(kept - regenerated)})"
                )
            doc["arms"] = {}
    for rep in reports:
        doc["arms"][rep.arm] = rep.to_budget_entry()
    _dump(doc, path)
    return doc


def write_pipeline_budgets(results: List[PipelineAuditResult], path: str = DEFAULT_BUDGETS_PATH,
                           existing: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    """Freeze pipeline-arm budgets into ``pipeline_schedules``, merging over
    the file."""
    failed = [r.arm for r in results if r.compile_error is not None]
    if failed:
        raise ValueError("refusing to freeze pipeline budgets with arms that failed "
                         f"to compile: {failed}")
    doc = (dict(existing) if existing is not None
           else (load_budgets(path) if os.path.exists(path) else _empty_doc()))
    section = dict(doc.get("pipeline_schedules", {}))
    arms = dict(section.get("arms", {}))
    _refuse_partial_across_versions(section, arms, {r.arm for r in results},
                                    "pipeline_schedules budgets", True)
    if section.get("torch_version") not in (None, _torch_version()):
        arms = {}
    for r in results:
        arms[r.arm] = r.to_budget_entry()
    doc["pipeline_schedules"] = {"torch_version": _torch_version(), "arms": arms}
    _dump(doc, path)
    return doc


def diff_against_budget(report: ArmReport, budgets: Dict[str, Any]) -> List[str]:
    """Human-readable deltas between a fresh report and the frozen budget
    (JAX's wording). Empty = within budget. Budgets are exact pins: an
    improvement also fails, asking to be banked, or the next regression
    hides inside the slack it left."""
    arm_budget = budgets.get("arms", {}).get(report.arm)
    if arm_budget is None:
        return [f"{report.arm}: no frozen budget for this arm "
                "(run --update-budgets to freeze one)"]
    deltas: List[str] = []

    def check(label: str, got: int, want: int, unit: str = "per step"):
        if got == want:
            return
        delta = got - want
        if delta > 0:
            deltas.append(f"{report.arm}: {label} REGRESSED {want} -> {got} ({delta:+d} {unit})")
        else:
            deltas.append(f"{report.arm}: {label} improved {want} -> {got} "
                          f"({delta:+d}) — bank it with --update-budgets")

    frozen_counts = arm_budget.get("collectives", {})
    frozen_bytes = arm_budget.get("collective_bytes", {})
    for op in list(COLLECTIVE_OPS) + ["other"]:
        check(op, report.collectives.get(op, 0), frozen_counts.get(op, 0))
        check(f"{op} bytes", report.collective_bytes.get(op, 0), frozen_bytes.get(op, 0),
              "bytes per step")
    frozen_sizes = arm_budget.get("group_sizes", {})
    if {k: dict(v) for k, v in report.group_sizes.items()} != frozen_sizes:
        deltas.append(f"{report.arm}: collective group sizes changed "
                      f"{frozen_sizes} -> {dict(report.group_sizes)}")
    check("full-replication reshard suspects", report.replication_reshard_suspects,
          arm_budget["replication_reshard_suspects"])
    check("bf16->f32 converts", report.bf16_to_f32_converts, arm_budget["bf16_to_f32_converts"])
    if report.messages is not None or "messages" in arm_budget:
        frozen_msgs = arm_budget.get("messages", {})
        for d in ("fwd", "bwd"):
            check(f"{d} messages", (report.messages or {}).get(d, 0), frozen_msgs.get(d, 0))
    return deltas
