"""Checkpoint / resume over ``torch.distributed.checkpoint`` (DCP), self-validating.

Port of ``distributed_llm_training_benchmark_framework_tpu/runtime/checkpoint.py``
(``BenchmarkCheckpointer``), with its sidecars and their JSON schemas:

- **Atomic sidecars.** Every metadata file (the layout tag ``layout.json``,
  ``digest_<step>.json``, ``geometry_<step>.json``, ``restarts.json``) is
  written tmp + fsync + rename.
- **Atomic steps.** A step is written into ``.<step>.tmp/`` and renamed to
  ``<step>/`` once every rank's files and DCP's ``.metadata`` are down (the
  commit); a process killed before it leaves no step behind.
- **Self-validating steps.** After the commit, ``digest_<step>.json``
  records a sha256 over the step directory's files. A restore hashes
  again first: a torn step is found here, by name, not deep inside DCP.
- **Quarantine and fallback.** A step that fails validation moves to
  ``quarantine/step_<N>/`` with a ``QUARANTINE.json`` note, and a restore
  falls back to the previous step; a directory that is all torn is a cold
  start.
- **Restart ledger.** ``note_restart`` counts resumes in ``restarts.json``
  for the row's ``resumed`` / ``n_restarts`` accounting.
- **Geometry sidecars** list the mesh the step was saved under and every
  leaf (path, global shape, dtype). A restore compares them with this
  run's: a tree that does not fit (another tier, family or ``seq_len``)
  is refused by name; another mesh restores (elastic resume) and sets
  ``last_resume_geometry_changed``.
- **Stream sidecars.** A run on the streaming input path (``--data-path``)
  saves the stream's exact-resume state (``data/stream.py``: the records
  delivered through the step, and the skip total) as ``stream_<step>.json``
  beside the step, so a resume consumes precisely the records the run had
  not consumed; the cursor is geometry-free, so it survives a resume onto
  another mesh.
- **Async saves** (``async_save``): a periodic save stages the state into
  host memory and returns while DCP's ``async_save`` writes it on a
  thread; the commit (rename, digest, geometry) is fenced at a later
  boundary (``finalize_pending``: the next save, an emergency stop or
  ``close``).

**The payload** (``TrainState``) holds everything that makes a resumed run
equal the straight one, each leaf under its JAX path (``bridge.leaf_key``:
``params/wte``, ``params/blocks/wqkv/<global layer>``) at its *global*
shape, whatever the geometry: so a step saved at one data width restores
at another. ``TrainState.state_dict`` gathers each rank's parts (a DTensor's
``data`` shards, ``model`` and ``expert`` shards: ``bridge.gather_leaf``;
zero2's flat buckets over ``data``) and ``load_state_dict`` cuts this
rank's parts back out. It holds:

- the parameters, and per leaf the AdamW moments ``opt/mu/...`` and
  ``opt/nu/...`` (optax's names), with the optimizer's update count
  ``opt/count`` (the lr schedule reads it; ``torch.optim.AdamW`` does not
  hold it) and AdamW's own step ``opt/adamw_step``;
- under ZeRO-Offload (``parallel/offload.HostOffload``) the host side: the
  fp32 masters ``opt/master/...`` and moments, the host's count and, in
  the delayed form, the pending gradient slot ``opt/pending/...`` with its
  clip scale;
- the step's dropout generator (``rng/seed_gen``, on the CPU; every
  dropout mask is seeded from its draws), which runs on from step to step.

zero2's buckets are gathered whole over ``data`` at save time (its shards
are slices of flat per-block buffers, not row blocks of a leaf), and a
pipeline stage saves the layers it holds. Keys held by several ranks
(replicated leaves) are written once (DCP deduplicates them).

A checkpointer made inside a process group makes two gloo groups of its
own (DCP's planning and ``async_save`` need a CPU backend): DCP's
collectives run on one, the checkpointer's barriers and broadcasts on the
other, so an async write still planning or reducing on its thread never
meets a barrier of the main thread on the same group. Every method that
says "collective" is called by every rank, and each commits an async save
in flight before its first collective. Rank 0 commits, hashes, quarantines
and writes the sidecars.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time
import warnings
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.distributed as dist
import torch.distributed.checkpoint as dcp
from torch.distributed.tensor import DTensor, distribute_tensor

from .. import bridge
from ..parallel.strategies import Optimizer, _Zero2Optimizer

#: Version of the digest-sidecar schema; a newer one is read as legacy.
DIGEST_SCHEMA_VERSION = 1
#: Version of the geometry-sidecar schema (same posture).
GEOMETRY_SCHEMA_VERSION = 1

QUARANTINE_DIRNAME = "quarantine"
RESTARTS_FILENAME = "restarts.json"


def _atomic_write_json(path: str, obj: Any) -> None:
    """tmp + fsync + rename: either the old file or the complete new one."""
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, indent=2, sort_keys=True)
        f.write("\n")
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def tree_compat_errors(saved: Optional[List[Dict[str, Any]]], target: List[Dict[str, Any]],
                       label: str) -> List[str]:
    """Violations between a saved tree's entries and this run's (global shape
    and dtype first, then the path sets; specs are layout, not identity)."""
    if not saved:
        return []
    errs: List[str] = []
    saved_by_path = {e["path"]: e for e in saved}
    target_by_path = {e["path"]: e for e in target}
    missing = [f"{label}{path}: saved leaf has no counterpart in this run"
               for path in sorted(set(saved_by_path) - set(target_by_path))]
    missing += [f"{label}{path}: this run's leaf is absent from the checkpoint"
                for path in sorted(set(target_by_path) - set(saved_by_path))]
    for path in sorted(set(saved_by_path) & set(target_by_path)):
        s, t = saved_by_path[path], target_by_path[path]
        if list(s.get("shape") or []) != list(t.get("shape") or []):
            errs.append(f"{label}{path}: saved shape {s.get('shape')} != this run's "
                        f"{t.get('shape')}")
        elif s.get("dtype") != t.get("dtype"):
            errs.append(f"{label}{path}: saved dtype {s.get('dtype')} != this run's "
                        f"{t.get('dtype')}")
    return errs + missing


def _entries(shapes: Dict[str, Tuple[List[int], str]]) -> Dict[str, List[Dict[str, Any]]]:
    """{key: (shape, dtype)} -> the geometry sidecar's ``params`` / ``opt_state``
    lists, sorted by path (every key but the ``params/`` ones is optimizer
    or step state)."""
    out: Dict[str, List[Dict[str, Any]]] = {"params": [], "opt_state": []}
    for key in sorted(shapes):
        shape, dtype = shapes[key]
        out["params" if key.startswith("params/") else "opt_state"].append(
            {"path": key, "shape": [int(d) for d in shape], "dtype": dtype, "spec": None})
    return out


def _unshard(p: torch.Tensor, local: torch.Tensor) -> torch.Tensor:
    """The whole tensor (over ``data``) of which ``local`` is this rank's shard
    laid out as parameter ``p`` (a DTensor), or ``local`` itself."""
    if not isinstance(p, DTensor):
        return local
    return DTensor.from_local(local.to(p.device), p.device_mesh, p.placements,
                              run_check=False, shape=p.shape, stride=p.stride()).full_tensor()


def _shard(p: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """This rank's shard of ``whole`` laid out as parameter ``p`` (no
    communication: every rank holds ``whole``), or ``whole`` itself."""
    if not isinstance(p, DTensor):
        return whole
    return distribute_tensor(whole.to(p.device), p.device_mesh, p.placements,
                             src_data_rank=None).to_local()


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if isinstance(t, DTensor) else t


class TrainState:
    """One rank's live training state as the checkpoint sees it: the model as
    the arm returns it, its ``parallel.strategies.Optimizer`` and the
    step's generators (``train.step.TrainStep``; None: no generators)."""

    def __init__(self, model: torch.nn.Module, optimizer: Optimizer, step_fn=None):
        self.inner = getattr(model, "module", model)
        self.optimizer = optimizer
        self.step_fn = step_fn
        # (key, port name, tensor) for every leaf of every layer this rank
        # holds (under the scan loop a layer's slice of a stacked leaf).
        self.leaves = [(bridge.leaf_key(path), name, p)
                       for path, name, p in bridge.leaves(self.inner)]
        by_name = {name: key for key, name, _ in self.leaves}
        # Per optimizer tensor: the leaves it holds, with where each sits in
        # it (zero2: a bucket's leaves laid end to end, by offset; a stacked
        # leaf: its layers, by row), else its own leaf.
        self.zero2 = isinstance(optimizer, _Zero2Optimizer)
        if self.zero2:
            self.units = []
            for b in optimizer.buckets:
                items, offset = [], 0
                for name, p in zip(b.names, b.params):
                    items.append((by_name[name], name, p, offset))
                    offset += p.numel()
                self.units.append(items)
        else:
            rows: Dict[int, List[Tuple[str, str, torch.Tensor, Optional[int]]]] = {}
            for key, name, p in self.leaves:
                base = p._base if p._base is not None else p
                row = None if p._base is None else len(rows.get(id(base), []))
                rows.setdefault(id(base), []).append((key, name, p, row))
            self.units = [rows[id(p)] for p in optimizer.params]

    # -- the optimizer's per-tensor state ------------------------------------

    def _adamw_state(self, p: torch.Tensor) -> Dict[str, torch.Tensor]:
        """AdamW's state of ``p``, made (zeros) when no step has run yet."""
        state = self.optimizer.adamw.state
        if p not in state:
            state[p] = {"step": torch.tensor(0.0),
                        "exp_avg": torch.zeros_like(p, memory_format=torch.preserve_format),
                        "exp_avg_sq": torch.zeros_like(p, memory_format=torch.preserve_format)}
        return state[p]

    def _companions(self) -> Dict[str, List[torch.Tensor]]:
        """{kind: [per optimizer tensor, a tensor laid out as its local part]}:
        the moments on the device, or the host side under offload (views
        into its flat buffers)."""
        opt = self.optimizer
        if opt.host is None:
            states = [self._adamw_state(p) for p in opt.params]
            return {"mu": [_local(s["exp_avg"]) for s in states],
                    "nu": [_local(s["exp_avg_sq"]) for s in states]}
        host = opt.host
        shapes = [t.shape for t in host.tensors]
        sizes = [t.numel() for t in host.tensors]
        moments = host.adamw.state[host.master]

        def views(flat):
            return [v.view(shape) for v, shape in zip(torch.split(flat, sizes), shapes)]

        return {"master": host.master_views, "mu": views(moments["exp_avg"]),
                "nu": views(moments["exp_avg_sq"]), "pending": views(host.stage)}

    def _adamw_step(self) -> torch.Tensor:
        opt = self.optimizer
        if opt.host is not None:
            return opt.host.adamw.state[opt.host.master]["step"]
        return self._adamw_state(opt.params[0])["step"]

    def _generators(self) -> Dict[str, torch.Generator]:
        if self.step_fn is None:
            return {}
        return {"rng/seed_gen": self.step_fn.seed_gen}

    # -- shapes ----------------------------------------------------------------

    def shapes(self) -> Dict[str, Tuple[List[int], str]]:
        """{key: (global shape, dtype)} of every entry this rank saves and
        loads (no communication)."""
        out: Dict[str, Tuple[List[int], str]] = {}
        for key, name, p in self.leaves:
            out[f"params/{key}"] = (bridge.global_shape(self.inner, name, p), _dtype_name(p.dtype))
        for kind, comps in self._companions().items():
            for comp, unit in zip(comps, self.units):
                for key, name, p, _ in unit:
                    out[f"opt/{kind}/{key}"] = (bridge.global_shape(self.inner, name, p),
                                                _dtype_name(comp.dtype))
        for key in self._scalars():
            out[key] = ([1], "int64" if key != "opt/pending_scale" else "float32")
        for key, gen in self._generators().items():
            out[key] = (list(gen.get_state().shape), "uint8")
        return out

    def _scalars(self) -> Dict[str, torch.Tensor]:
        opt = self.optimizer
        out = {"opt/count": torch.tensor([opt.count]),
               "opt/adamw_step": torch.tensor([int(self._adamw_step().item())])}
        if opt.host is not None:
            out["opt/host_count"] = torch.tensor([opt.host.count])
            out["opt/pending_scale"] = opt.host.scale.detach().reshape(1).float().cpu().clone()
        return out

    # -- save / load -----------------------------------------------------------

    def _unit_leaves(self, i: int, comp: torch.Tensor):
        """(key, name, this rank's part of the leaf) for optimizer tensor i's
        companion ``comp`` (collective under zero2 over ``data``)."""
        unit = self.units[i]
        if not self.zero2:
            for key, name, p, row in unit:
                yield key, name, _unshard(p, comp if row is None else comp[row])
            return
        group = self.optimizer.group
        flat = comp.to(unit[0][2].device)
        whole = torch.empty(flat.numel() * dist.get_world_size(group), dtype=flat.dtype,
                            device=flat.device)
        dist.all_gather_into_tensor(whole, flat.contiguous(), group=group)
        for key, name, p, offset in unit:
            yield key, name, whole[offset:offset + p.numel()].view(p.shape)

    @torch.no_grad()
    def state_dict(self) -> Dict[str, torch.Tensor]:
        """Every entry at its global shape (collective: the gathers)."""
        sd: Dict[str, torch.Tensor] = {}
        for key, name, p in self.leaves:
            sd[f"params/{key}"] = bridge.gather_leaf(self.inner, name, p.detach())
        for kind, comps in self._companions().items():
            for i, comp in enumerate(comps):
                for key, name, part in self._unit_leaves(i, comp):
                    if bridge.shard_axes(self.inner, name):
                        part = part.to(self.leaves[0][2].device)
                    sd[f"opt/{kind}/{key}"] = bridge.gather_leaf(self.inner, name, part)
        sd.update(self._scalars())
        for key, gen in self._generators().items():
            sd[key] = gen.get_state()
        return sd

    @torch.no_grad()
    def load_state_dict(self, sd: Dict[str, torch.Tensor]) -> None:
        """Copy this rank's parts of the global entries ``sd`` into the live
        state (no communication)."""
        for key, name, p in self.leaves:
            _local(p).copy_(_shard(p, bridge.local_leaf(self.inner, name, sd[f"params/{key}"])))
        rank = dist.get_rank(self.optimizer.group) if self.zero2 else 0
        for kind, comps in self._companions().items():
            for comp, unit in zip(comps, self.units):
                if not self.zero2:
                    for key, name, p, row in unit:
                        part = bridge.local_leaf(self.inner, name, sd[f"opt/{kind}/{key}"])
                        (comp if row is None else comp[row]).copy_(_shard(p, part))
                    continue
                whole = torch.zeros(comp.numel() * dist.get_world_size(self.optimizer.group),
                                    dtype=comp.dtype)
                for key, name, p, offset in unit:
                    part = bridge.local_leaf(self.inner, name, sd[f"opt/{kind}/{key}"])
                    whole[offset:offset + p.numel()].copy_(part.reshape(-1))
                comp.copy_(whole[rank * comp.numel():(rank + 1) * comp.numel()])
        if self.zero2:
            self.optimizer.reload_shards()
        opt = self.optimizer
        opt.count = int(sd["opt/count"][0])
        step = float(sd["opt/adamw_step"][0])
        if opt.host is not None:
            opt.host.count = int(sd["opt/host_count"][0])
            opt.host.scale.copy_(sd["opt/pending_scale"].reshape(()))
            opt.host.adamw.state[opt.host.master]["step"].fill_(step)
        else:
            for p in opt.params:
                self._adamw_state(p)["step"].fill_(step)
        for key, gen in self._generators().items():
            gen.set_state(sd[key])


class BenchmarkCheckpointer:
    """Steps of a ``TrainState`` under ``directory`` (see the module docstring).

    ``layout`` is the ``layer_layout`` tag (``interleaved:pp=P:v=V`` or
    ``contiguous``): a restore across tags is refused, as JAX refuses it.
    ``geometry`` is this run's ``{"mesh_axes": {...}, "world_size": N}``
    ({}: geometry-unaware, no sidecar). Construction is collective in a
    process group (it makes the checkpoint's gloo groups)."""

    def __init__(self, directory: str, max_to_keep: int = 3, save_every: int = 0,
                 layout: Optional[Dict[str, Any]] = None,
                 geometry: Optional[Dict[str, Any]] = None, async_save: bool = False):
        self.directory = os.path.abspath(directory)
        self.save_every = save_every
        self.max_to_keep = max_to_keep
        self.layout = dict(layout or {"layer_layout": "contiguous"})
        self.geometry = dict(geometry or {})
        self.async_save = bool(async_save)
        self.distributed = dist.is_available() and dist.is_initialized()
        self.group = dist.new_group(backend="gloo") if self.distributed else None
        self._dcp_group = dist.new_group(backend="gloo") if self.distributed else None
        if not self.distributed:
            # DCP warns on every call without a group, as it should here.
            warnings.filterwarnings("ignore", message="torch.distributed is disabled",
                                    category=UserWarning)
        self.rank = dist.get_rank() if self.distributed else 0
        #: (step, meta, future, dispatch stats, stream state) of an async save
        #: not yet committed.
        self._pending_async: Optional[Tuple[int, Dict[str, Any], Any, Dict[str, Any],
                                            Optional[Dict[str, Any]]]] = None
        #: Committed saves since the last ``drain_commits`` (timings, bytes).
        self._commits: List[Dict[str, Any]] = []
        #: Set by restore(): whether the step was saved under another mesh,
        #: that mesh, and the restore's timings.
        self.last_resume_geometry_changed = False
        self.last_resume_source_geometry: Optional[Dict[str, Any]] = None
        self.last_restore: Dict[str, Any] = {}
        if self.rank == 0:
            os.makedirs(self.directory, exist_ok=True)
        self._barrier()

    # -- plumbing --------------------------------------------------------------

    def _barrier(self) -> None:
        if self.distributed:
            dist.barrier(group=self.group)

    def _broadcast(self, obj: Any) -> Any:
        """Rank 0's ``obj`` on every rank."""
        if not self.distributed:
            return obj
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.group)
        return box[0]

    def _dcp_kwargs(self) -> Dict[str, Any]:
        return {"process_group": self._dcp_group} if self.distributed else {"no_dist": True}

    @property
    def _layout_path(self) -> str:
        return os.path.join(self.directory, "layout.json")

    def step_dir(self, step: int) -> str:
        """The on-disk directory of one committed step."""
        return os.path.join(self.directory, str(step))

    def _tmp_dir(self, step: int) -> str:
        return os.path.join(self.directory, f".{step}.tmp")

    def _digest_path(self, step: int) -> str:
        return os.path.join(self.directory, f"digest_{step}.json")

    def _geometry_path(self, step: int) -> str:
        return os.path.join(self.directory, f"geometry_{step}.json")

    def _stream_path(self, step: int) -> str:
        return os.path.join(self.directory, f"stream_{step}.json")

    @property
    def quarantine_dir(self) -> str:
        return os.path.join(self.directory, QUARANTINE_DIRNAME)

    @property
    def _restarts_path(self) -> str:
        return os.path.join(self.directory, RESTARTS_FILENAME)

    def should_save(self, step: int) -> bool:
        return self.save_every > 0 and step > 0 and step % self.save_every == 0

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def all_steps(self) -> List[int]:
        """Committed steps, ascending."""
        try:
            names = os.listdir(self.directory)
        except OSError:
            return []
        return sorted(int(n) for n in names
                      if n.isdigit() and os.path.isdir(os.path.join(self.directory, n)))

    # -- digests ---------------------------------------------------------------

    def compute_digest(self, step: int) -> Tuple[str, int]:
        """sha256 over the step directory's files; (digest, n_files). Per-file
        hashes keyed by relative path, combined in sorted order: renames,
        truncation, bit-rot and missing files all change it."""
        root = self.step_dir(step)
        entries: List[str] = []
        for dirpath, _dirnames, filenames in os.walk(root):
            for fn in sorted(filenames):
                path = os.path.join(dirpath, fn)
                h = hashlib.sha256()
                with open(path, "rb") as f:
                    for chunk in iter(lambda: f.read(1 << 20), b""):
                        h.update(chunk)
                entries.append(f"{os.path.relpath(path, root)}:{h.hexdigest()}")
        return hashlib.sha256("\n".join(sorted(entries)).encode()).hexdigest(), len(entries)

    def _write_digest(self, step: int, meta: Optional[Dict[str, Any]] = None) -> None:
        digest, n_files = self.compute_digest(step)
        _atomic_write_json(self._digest_path(step), {
            "schema_version": DIGEST_SCHEMA_VERSION, "step": step, "algo": "sha256",
            "digest": digest, "n_files": n_files, "meta": dict(meta or {}),
        })

    def _read_digest(self, step: int) -> Optional[Dict[str, Any]]:
        path = self._digest_path(step)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                raw = json.load(f)
        except (ValueError, OSError):
            return {"unreadable": True}
        ver = raw.get("schema_version")
        if not isinstance(ver, int) or ver > DIGEST_SCHEMA_VERSION:
            return None  # a newer writer's sidecar: legacy-valid
        return raw

    def step_meta(self, step: int) -> Dict[str, Any]:
        """The ``meta`` stored with the step's digest ({} if none): the loop
        stores the last window's loss, the resumed row's baseline."""
        raw = self._read_digest(step)
        if not raw or raw.get("unreadable"):
            return {}
        meta = raw.get("meta")
        return dict(meta) if isinstance(meta, dict) else {}

    def validate_step(self, step: int) -> Tuple[str, str]:
        """('ok'|'legacy'|'mismatch'|'unreadable'|'missing', detail)."""
        if not os.path.isdir(self.step_dir(step)):
            return "missing", f"no step directory {self.step_dir(step)}"
        raw = self._read_digest(step)
        if raw is None:
            return "legacy", "no digest sidecar (pre-digest checkpoint)"
        if raw.get("unreadable"):
            return "unreadable", f"digest sidecar {self._digest_path(step)} unparseable"
        actual, _n = self.compute_digest(step)
        if actual != raw.get("digest"):
            return "mismatch", f"expected {raw.get('digest')}, recomputed {actual}"
        return "ok", "digest verified"

    # -- geometry --------------------------------------------------------------

    def _write_geometry(self, step: int) -> None:
        """The geometry sidecar of a committed step, from DCP's metadata (it
        lists every rank's entries)."""
        if not self.geometry:
            return
        md = dcp.FileSystemReader(self.step_dir(step)).read_metadata()
        shapes = {key: (list(m.size), _dtype_name(m.properties.dtype))
                  for key, m in md.state_dict_metadata.items() if hasattr(m, "size")}
        try:
            _atomic_write_json(self._geometry_path(step), {
                "schema_version": GEOMETRY_SCHEMA_VERSION, "step": step,
                "mesh_axes": dict(self.geometry.get("mesh_axes") or {}),
                "world_size": self.geometry.get("world_size"), **_entries(shapes),
            })
        except OSError as e:
            print(f"WARNING: checkpoint geometry for step {step} not written ({e}); step "
                  "will only restore onto an identical mesh")

    def read_geometry(self, step: int) -> Optional[Dict[str, Any]]:
        """The step's geometry sidecar, or None (absent, unreadable, newer)."""
        path = self._geometry_path(step)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                raw = json.load(f)
        except (ValueError, OSError):
            return None
        ver = raw.get("schema_version")
        if not isinstance(ver, int) or ver > GEOMETRY_SCHEMA_VERSION:
            return None
        return raw

    def _write_stream_state(self, step: int, state: Optional[Dict[str, Any]]) -> None:
        """The step's stream sidecar (rank 0); a failed write warns, and the
        resume falls back to the closed-form cursor."""
        if state is None:
            return
        try:
            _atomic_write_json(self._stream_path(step), dict(state))
        except OSError as e:
            print(f"WARNING: stream-state sidecar for step {step} not written ({e}); resume "
                  "will use the closed-form cursor")

    def read_stream_state(self, step: int) -> Optional[Dict[str, Any]]:
        """The step's stream sidecar, or None (a synthetic-path checkpoint,
        an unreadable sidecar, or a newer schema)."""
        from ..data.stream import STREAM_STATE_SCHEMA_VERSION

        path = self._stream_path(step)
        if not os.path.exists(path):
            return None
        try:
            with open(path) as f:
                raw = json.load(f)
        except (ValueError, OSError):
            return None
        ver = raw.get("schema_version")
        if not isinstance(ver, int) or ver > STREAM_STATE_SCHEMA_VERSION:
            return None
        return raw

    def _geometry_differs(self, saved_geom: Optional[Dict[str, Any]]) -> bool:
        """The sidecar's mesh differs from this run's (width-1 axes ignored)."""
        if not saved_geom or not self.geometry:
            return False

        def live(axes):
            return {k: v for k, v in (axes or {}).items() if int(v) != 1}

        return live(saved_geom.get("mesh_axes")) != live(self.geometry.get("mesh_axes"))

    # -- quarantine and fallback -----------------------------------------------

    def quarantine_step(self, step: int, reason: str) -> str:
        """Move a failed step and its sidecars under quarantine/ (nothing is
        deleted) with a ``QUARANTINE.json`` note; returns the destination."""
        os.makedirs(self.quarantine_dir, exist_ok=True)
        dest = os.path.join(self.quarantine_dir, f"step_{step}")
        suffix = 0
        while os.path.exists(dest):
            suffix += 1
            dest = os.path.join(self.quarantine_dir, f"step_{step}.{suffix}")
        os.makedirs(dest)
        expected = self._read_digest(step) or {}
        if os.path.isdir(self.step_dir(step)):
            shutil.move(self.step_dir(step), os.path.join(dest, str(step)))
        for path in (self._digest_path(step), self._geometry_path(step), self._stream_path(step)):
            if os.path.exists(path):
                shutil.move(path, os.path.join(dest, os.path.basename(path)))
        _atomic_write_json(os.path.join(dest, "QUARANTINE.json"), {
            "schema_version": DIGEST_SCHEMA_VERSION, "step": step, "reason": reason,
            "expected_digest": expected.get("digest"),
        })
        return dest

    def latest_valid_step(self) -> Optional[int]:
        """Newest step whose digest verifies, quarantining each failure on the
        way (rank 0's view; ``restore`` shares it)."""
        for step in sorted(self.all_steps(), reverse=True):
            status, detail = self.validate_step(step)
            if status in ("ok", "legacy"):
                return step
            dest = self.quarantine_step(step, f"{status}: {detail}")
            print(f"WARNING: checkpoint step {step} failed validation ({status}: {detail}) — "
                  f"quarantined to {dest}, falling back to the previous committed step")
        return None

    # -- restart ledger ----------------------------------------------------------

    def _read_ledger(self) -> Dict[str, Any]:
        try:
            with open(self._restarts_path) as f:
                raw = json.load(f)
            return raw if isinstance(raw, dict) else {}
        except (OSError, ValueError):
            return {}

    def n_restarts(self) -> int:
        try:
            return int(self._read_ledger().get("n_restarts", 0))
        except (ValueError, TypeError):
            return 0

    def n_geometry_changes(self) -> int:
        try:
            return int(self._read_ledger().get("n_geometry_changes", 0))
        except (ValueError, TypeError):
            return 0

    def note_restart(self, geometry_changed: bool = False) -> int:
        """Record one resume (rank 0 writes; collective); the new total."""
        n = None
        if self.rank == 0:
            ledger = self._read_ledger()

            def count(key: str) -> int:
                try:
                    return int(ledger.get(key, 0))
                except (ValueError, TypeError):
                    return 0

            n = count("n_restarts") + 1
            ledger["n_restarts"] = n
            if geometry_changed:
                ledger["n_geometry_changes"] = count("n_geometry_changes") + 1
                src = self.last_resume_source_geometry or {}
                ledger["last_geometry_change"] = {
                    "from_mesh_axes": src.get("mesh_axes"),
                    "to_mesh_axes": dict(self.geometry.get("mesh_axes") or {}),
                }
            _atomic_write_json(self._restarts_path, ledger)
        return self._broadcast(n)

    # -- layout tag --------------------------------------------------------------

    def _read_layout(self) -> Optional[Dict[str, Any]]:
        """The directory's layout tag; None if absent (or unparseable over an
        empty directory)."""
        if not os.path.exists(self._layout_path):
            return None
        try:
            with open(self._layout_path) as f:
                return json.load(f)
        except ValueError:
            if not self.all_steps():
                return None
            raise ValueError(
                f"unparseable layout tag {self._layout_path} over a directory that holds "
                "checkpoints; cannot determine their parameter layout. Restore the tag (e.g. "
                '{"layer_layout": "contiguous"}) or move the checkpoints aside.')

    def _check_layout_for_save(self) -> bool:
        """Refuse to mix layouts in one directory; True when the tag needs
        stamping."""
        existing = self._read_layout()
        needs_stamp = existing is None
        has_steps = bool(self.all_steps())
        if existing is None and has_steps:
            existing = {"layer_layout": "contiguous"}
        if existing is not None and existing != self.layout:
            if not has_steps:
                raise ValueError(
                    f"checkpoint directory {self.directory} carries a layout tag {existing} "
                    "but holds no checkpoints; if no other run is writing there, the tag is a "
                    f"stale leftover of an interrupted first save — delete {self._layout_path} "
                    "to reclaim the directory, or use a fresh --checkpoint-dir.")
            raise ValueError(
                f"checkpoint directory {self.directory} holds checkpoints with parameter "
                f"layout {existing}, but this run writes {self.layout}; refusing to mix "
                "layouts in one directory — use a fresh --checkpoint-dir.")
        return needs_stamp

    # -- save --------------------------------------------------------------------

    def pending_async_step(self) -> Optional[int]:
        """The step of an async save not yet committed, or None."""
        return self._pending_async[0] if self._pending_async else None

    def drain_commits(self) -> List[Dict[str, Any]]:
        """The committed saves since the last call: step, async, ms of each
        part, bytes written."""
        out, self._commits = self._commits, []
        return out

    def _commit(self, step: int, meta: Dict[str, Any], stats: Dict[str, Any],
                stream_state: Optional[Dict[str, Any]] = None) -> None:
        """Every rank's files are down: rank 0 renames the step into place,
        hashes it and writes the sidecars (collective)."""
        self._barrier()
        if self.rank == 0:
            if os.path.isdir(self.step_dir(step)):
                shutil.rmtree(self.step_dir(step))
            os.replace(self._tmp_dir(step), self.step_dir(step))
            t0 = time.perf_counter()
            try:
                self._write_digest(step, meta=meta)
            except OSError as e:
                print(f"WARNING: checkpoint digest for step {step} not written ({e}); step "
                      "will restore as legacy-valid")
            stats["digest_ms"] = 1e3 * (time.perf_counter() - t0)
            self._write_geometry(step)
            self._write_stream_state(step, stream_state)
            stats["bytes"] = sum(os.path.getsize(os.path.join(d, f))
                                 for d, _, fs in os.walk(self.step_dir(step)) for f in fs)
            self._gc()
        self._barrier()
        self._commits.append({"step": step, **stats})

    def finalize_pending(self) -> Optional[int]:
        """Wait for an in-flight async save and commit it (collective); the
        committed step, or None when nothing was pending."""
        if self._pending_async is None:
            return None
        step, meta, future, stats, stream_state = self._pending_async
        self._pending_async = None
        t0 = time.perf_counter()
        future.result()
        stats["write_wait_ms"] = 1e3 * (time.perf_counter() - t0)
        self._commit(step, meta, stats, stream_state)
        return step

    def save(self, step: int, state: TrainState, force: bool = False,
             meta: Optional[Dict[str, Any]] = None,
             stream_state: Optional[Dict[str, Any]] = None) -> bool:
        """Save ``state`` as ``step`` (collective), with the stream sidecar
        ``stream_state`` when given. A periodic save (not ``force``) with
        ``async_save`` returns once the state is staged in host memory; its
        commit waits for ``finalize_pending``."""
        self.finalize_pending()
        needs_stamp = self._check_layout_for_save()
        self._barrier()
        if needs_stamp and self.rank == 0:
            # Stamp before the save commits: a crash between the two leaves a
            # tag over an empty directory, which is reclaimable.
            _atomic_write_json(self._layout_path, self.layout)
        if self.rank == 0 and os.path.isdir(self._tmp_dir(step)):
            shutil.rmtree(self._tmp_dir(step))  # a killed earlier attempt's leftovers
        self._barrier()
        t0 = time.perf_counter()
        sd = state.state_dict()
        t1 = time.perf_counter()
        stats = {"async": self.async_save and not force, "gather_ms": 1e3 * (t1 - t0)}
        if self.async_save and not force:
            future = dcp.async_save(sd, checkpoint_id=self._tmp_dir(step), **self._dcp_kwargs())
            stats["dispatch_ms"] = 1e3 * (time.perf_counter() - t0)
            self._pending_async = (step, dict(meta or {}), future, stats, stream_state)
            return True
        dcp.save(sd, checkpoint_id=self._tmp_dir(step), **self._dcp_kwargs())
        stats["write_ms"] = 1e3 * (time.perf_counter() - t1)
        stats["dispatch_ms"] = 1e3 * (time.perf_counter() - t0)
        self._commit(step, dict(meta or {}), stats, stream_state)
        return True

    def _gc(self) -> None:
        """Keep the newest ``max_to_keep`` steps; drop the sidecars of steps
        that are gone (rank 0)."""
        steps = self.all_steps()
        for step in steps[:-self.max_to_keep] if self.max_to_keep > 0 else []:
            shutil.rmtree(self.step_dir(step), ignore_errors=True)
        live = set(self.all_steps())
        for name in os.listdir(self.directory):
            prefix = next((p for p in ("digest_", "geometry_", "stream_") if name.startswith(p)),
                          None)
            if prefix is None or not name.endswith(".json"):
                continue
            try:
                step = int(name[len(prefix):-len(".json")])
            except ValueError:
                continue
            if step not in live:
                try:
                    os.remove(os.path.join(self.directory, name))
                except OSError:
                    pass

    # -- restore -----------------------------------------------------------------

    def _choose_step(self, step: Optional[int]) -> Tuple[Optional[int], Optional[str], str]:
        """Rank 0's choice: (step, error kind, message)."""
        if step is None:
            chosen = self.latest_valid_step()
            if chosen is None:
                return None, "missing", f"no valid checkpoints under {self.directory}"
            return chosen, None, ""
        status, detail = self.validate_step(step)
        if status == "missing":
            return None, "missing", (f"no checkpoint step {step} under {self.directory} "
                                     f"(committed steps: {self.all_steps()})")
        if status not in ("ok", "legacy"):
            dest = self.quarantine_step(step, f"{status}: {detail}")
            return None, "invalid", (
                f"checkpoint step {step} failed validation ({status}: {detail}); quarantined "
                f"to {dest}. Restore without an explicit step to fall back automatically.")
        return step, None, ""

    def restore(self, state: TrainState, step: Optional[int] = None) -> int:
        """Restore ``state`` from ``step`` (None: the newest step whose digest
        verifies, quarantining torn steps on the way); collective. Raises
        FileNotFoundError when there is none, ValueError on a step that
        fails validation, another layout or a tree that does not fit."""
        self.finalize_pending()
        t0 = time.perf_counter()
        chosen = self._broadcast(self._choose_step(step) if self.rank == 0 else None)
        step, error, message = chosen
        if error == "missing":
            raise FileNotFoundError(message)
        if error is not None:
            raise ValueError(message)
        t_valid = time.perf_counter()
        saved_layout = self._read_layout() or {"layer_layout": "contiguous"}
        if saved_layout != self.layout:
            raise ValueError(
                f"checkpoint at {self.directory} was saved with parameter layout "
                f"{saved_layout}, but this run uses {self.layout} — the interleaved schedule "
                "permutes the layers, so resuming across layouts would load layers at the "
                "wrong depth. Re-run with the original --pipeline-schedule/--virtual-stages "
                "or start fresh.")
        self.last_resume_geometry_changed = False
        self.last_resume_source_geometry = None
        saved_geom = self.read_geometry(step)
        shapes = state.shapes()
        union = dict(shapes)
        if self.distributed:
            parts: List[Any] = [None] * dist.get_world_size(self.group)
            dist.all_gather_object(parts, shapes, group=self.group)
            for part in parts:
                union.update(part)
        if saved_geom:
            target = _entries(union)
            errs = (tree_compat_errors(saved_geom.get("params"), target["params"], "")
                    + tree_compat_errors(saved_geom.get("opt_state"), target["opt_state"], ""))
            if errs:
                shown = "\n  ".join(errs[:8])
                more = f"\n  ... and {len(errs) - 8} more" if len(errs) > 8 else ""
                raise ValueError(
                    f"checkpoint at {self.directory} step {step} (saved under mesh "
                    f"{saved_geom.get('mesh_axes')}) does not fit this run's state (mesh "
                    f"{self.geometry.get('mesh_axes')}): the trees are incompatible (another "
                    f"tier, family or seq_len, not just another parallel layout):\n  "
                    f"{shown}{more}\nResume with the original model configuration, or start "
                    "fresh with a new --checkpoint-dir.")
        if self._geometry_differs(saved_geom):
            self.last_resume_geometry_changed = True
            self.last_resume_source_geometry = {
                "mesh_axes": dict(saved_geom.get("mesh_axes") or {}),
                "world_size": saved_geom.get("world_size")}
            if self.rank == 0:
                print(f"Elastic resume: checkpoint step {step} was saved under mesh "
                      f"{saved_geom.get('mesh_axes')} (world_size="
                      f"{saved_geom.get('world_size')}); resharding onto this run's mesh "
                      f"{self.geometry.get('mesh_axes')} (world_size="
                      f"{self.geometry.get('world_size')})")
        dest = {key: torch.empty(shape, dtype=getattr(torch, dtype))
                for key, (shape, dtype) in shapes.items()}
        dcp.load(dest, checkpoint_id=self.step_dir(step), **self._dcp_kwargs())
        t_load = time.perf_counter()
        state.load_state_dict(dest)
        self.last_restore = {
            "step": step, "validate_ms": 1e3 * (t_valid - t0),
            "load_ms": 1e3 * (t_load - t_valid),
            "apply_ms": 1e3 * (time.perf_counter() - t_load),
            "bytes": sum(t.numel() * t.element_size() for t in dest.values()),
        }
        return step

    def restore_latest(self, state: TrainState) -> Optional[int]:
        """The resume path: the newest valid step, or None (an empty or
        all-torn directory is a cold start)."""
        try:
            return self.restore(state, step=None)
        except FileNotFoundError:
            return None

    def close(self) -> None:
        """Commit an in-flight async save (collective)."""
        self.finalize_pending()
