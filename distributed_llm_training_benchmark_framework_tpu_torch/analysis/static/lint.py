"""Engine 2: repo-specific AST lint rules over the port's source.

The counterpart of ``distributed_llm_training_benchmark_framework_tpu/
analysis/static/lint.py``: the same ids, the same ``# graftcheck:
disable=RULE`` suppression (comma-separated ids, or ``all``, on the line or
the line above) and the same ``run_lint(root, rules, files)`` contract, over
``PACKAGE``, the port. Each rule is re-aimed at what it means in eager
PyTorch on a CUDA card; the framework-neutral ones are JAX's checks as they
are:

- GC101  (no PyTorch meaning) JAX's ``jax.jit`` donation discipline: the
         port has no jit; eager PyTorch updates its state in place, so
         there is nothing to donate. Kept so the ids line up; never fires.
- GC102  host syncs (``.item()``, ``.tolist()``, ``.cpu()``,
         ``float(t)`` / ``int(t)``, ``torch.cuda.synchronize()``) inside the
         timed ``for step`` loop of ``train/loop.py``, outside its
         ``sync_window`` helper: each fences the card per step and corrupts
         the published step timing.
- GC103  an axis name passed to the mesh (``make_mesh``,
         ``init_device_mesh`` / ``DeviceMesh``'s ``mesh_dim_names``, a mesh's
         ``size`` / ``get_group`` / ``get_local_rank`` or a ``*mesh[...]``
         slice) that is not one of its five (``MeshAxes`` in
         ``parallel/mesh.py``).
- GC104  ``time.time()`` in ``train/``, ``models/`` or ``ops/``: host timing
         uses ``time.perf_counter``; device timing is the profiler's.
- GC105  telemetry / file IO / print in the timed loop with no
         ``sync_window`` fence earlier in its block (JAX's check).
- GC106  signal handlers anywhere, or unfenced fsync-class IO, in the timed
         loop (JAX's check).
- GC107  ``torch.tensor`` / ``ones`` / ``zeros`` / ``empty`` / ``full`` /
         ``arange`` without ``dtype=`` in ``models/`` or ``ops/``: the
         default dtype (float32, or int64 from integer data) is implicit,
         and a float32 constant promotes the bf16 arithmetic around it (the
         ``bf16_to_f32_converts`` the audit pins).
- GC108  a ``torch.distributed`` collective in ``parallel/``, ``models/`` or
         ``ops/`` with no ``group=`` (it would run over the default group,
         whatever the mesh), or with a group the mesh did not make
         (``None``, ``group.WORLD``, an inline ``new_group``).
- GC109  a host sync or a re-placement (``.to(...)``, ``.cuda()``, pinned
         memory) inside the per-micro-batch loops of
         ``parallel/pipeline.py`` and ``parallel/interleaved.py`` (their
         ``range`` loops, and the transport's per-message path those loops
         call): each runs once per micro-batch and fences or copies in the
         schedule.
- GC111  blocking input IO / ``next()`` pulls / ``time.sleep`` in a timed
         loop in ``data/`` or ``train/`` outside the prefetch fence (JAX's
         check).
- GC112  exit-code literals outside the ``EXIT_*`` registry (the port's is
         ``exit_codes.py``; JAX's check).
- GC201  ``docker/entrypoint.sh`` against the port harness's flags (JAX's
         check; the port's ``--device`` is exempt).

GC110 is the memory audit (``collective_audit``'s ``--memory``), not a
lint rule, as in JAX.
"""

from __future__ import annotations

import ast
import dataclasses
import os
import re
from typing import Callable, Dict, Iterator, List, Optional, Tuple

from .collective_audit import REPO_ROOT

PACKAGE = "distributed_llm_training_benchmark_framework_tpu_torch"

#: Harness flags deliberately NOT reachable from the container env, with the
#: reason each is exempt from GC201 (JAX's, and one of the port's):
#:   --local-rank        accepted for reference-CLI parity only
#:   --deepspeed-config  alias of --strategy-config, which the entrypoint
#:   --fsdp-config       already sets for the ZeRO arms
#:   --device            the port's CPU escape hatch for tests and CPU runs;
#:                       a container always trains on its accelerator
ENTRYPOINT_EXEMPT_FLAGS = frozenset(
    {"--local-rank", "--deepspeed-config", "--fsdp-config", "--device"}
)

#: Flags the entrypoint passes to scripts/with_retries.sh (the retry
#: wrapper it execs in retry mode) — wrapper surface, not harness surface,
#: so they are neither "stale" nor expected in build_parser().
ENTRYPOINT_WRAPPER_FLAGS = frozenset(
    {"--drop-on-retry", "--resume-flag"}
)


@dataclasses.dataclass(frozen=True)
class Rule:
    id: str
    name: str
    description: str
    fix_hint: str


@dataclasses.dataclass(frozen=True)
class Violation:
    rule_id: str
    path: str  # repo-relative
    line: int
    message: str
    fix_hint: str

    def __str__(self) -> str:
        return (
            f"{self.path}:{self.line}: {self.rule_id} {self.message}\n"
            f"    fix: {self.fix_hint}"
        )


RULES: Dict[str, Rule] = {}
_CHECKS: List[Tuple[Rule, Callable]] = []


def _rule(id: str, name: str, description: str, fix_hint: str):
    def register(fn):
        rule = Rule(id=id, name=name, description=description, fix_hint=fix_hint)
        RULES[id] = rule
        _CHECKS.append((rule, fn))
        return fn

    return register


# ---------------------------------------------------------------------------
# Shared source helpers
# ---------------------------------------------------------------------------


class _Tree:
    def __init__(self, path: str, rel: str):
        with open(path) as f:
            self.source = f.read()
        self.rel = rel
        self.lines = self.source.splitlines()
        self.ast = ast.parse(self.source, filename=rel)


#: Parsed files by (path, mtime, size): the rules walk the package several
#: times per run, and a file is parsed once.
_PARSED: Dict[Tuple[str, int, int], _Tree] = {}


def _parsed(path: str, rel: str) -> _Tree:
    st = os.stat(path)
    key = (os.path.abspath(path), st.st_mtime_ns, st.st_size)
    tree = _PARSED.get(key)
    if tree is None or tree.rel != rel:
        tree = _PARSED[key] = _Tree(path, rel)
    return tree


def _package_files(root: str, subdirs: Tuple[str, ...]) -> Iterator[_Tree]:
    for sub in subdirs:
        base = os.path.join(root, PACKAGE, sub)
        if not os.path.isdir(base):
            continue
        for dirpath, _dirnames, filenames in os.walk(base):
            for fn in sorted(filenames):
                if not fn.endswith(".py"):
                    continue
                path = os.path.join(dirpath, fn)
                yield _parsed(path, os.path.relpath(path, root))


def _dotted(node: ast.AST) -> Optional[str]:
    """'jax.jit' for Attribute/Name chains, else None."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


_SUPPRESS = re.compile(r"#\s*graftcheck:\s*disable=([A-Za-z0-9_,\s]+)")


def _timed_loops(tree_ast: ast.AST) -> Iterator[ast.For]:
    """Every `for step in ...` loop — the timed-loop shape GC102/105/106
    police in train/loop.py."""
    for n in ast.walk(tree_ast):
        if (
            isinstance(n, ast.For)
            and isinstance(n.target, ast.Name)
            and n.target.id == "step"
        ):
            yield n


def _contains_sync(node: ast.AST) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call) and _dotted(n.func) in (
            "sync_window", "self.sync_window"
        ):
            return True
    return False


def _stmt_calls(stmt: ast.AST) -> Iterator[ast.Call]:
    """Calls directly in ``stmt``, excluding nested function defs
    (sync_window-style boundary helpers are the sanctioned fenced
    context themselves)."""
    stack = [stmt]
    while stack:
        n = stack.pop()
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(n, ast.Call):
            yield n
        stack.extend(ast.iter_child_nodes(n))


def _iter_timed_loop_calls(tree: "_Tree") -> Iterator[Tuple[ast.Call, bool]]:
    """(call, fenced) for every call inside the file's timed loops.

    The ONE fence walk GC105 and GC106 share (a fix to its semantics must
    never be applied twice): statement-ordered traversal where a
    statement whose subtree calls ``sync_window`` fences everything AFTER
    it in the same block (and in blocks nested under those later
    statements); compound statements pass the current flag down to their
    bodies, and their test/iter/with-item expressions are scanned
    directly (``with open(...)`` is IO too). Conservative in the right
    direction: a fence from a previous loop iteration never carries over.
    Rules decide what the flag means — GC105 ignores fenced calls
    entirely, GC106 flags signal installs through fences.
    """

    def walk_block(stmts, fenced: bool):
        for stmt in stmts:
            if isinstance(stmt, (ast.If, ast.With, ast.Try, ast.For,
                                 ast.While)):
                for field in ("body", "orelse", "finalbody"):
                    sub = getattr(stmt, field, None)
                    if sub:
                        yield from walk_block(sub, fenced)
                for handler in getattr(stmt, "handlers", []):
                    yield from walk_block(handler.body, fenced)
                scan_nodes = [getattr(stmt, "test", None),
                              getattr(stmt, "iter", None)]
                scan_nodes += [
                    item.context_expr for item in getattr(stmt, "items", [])
                ]
                calls = [
                    c for n in scan_nodes if n is not None
                    for c in _stmt_calls(n)
                ]
            else:
                calls = list(_stmt_calls(stmt))
            for call in calls:
                yield call, fenced
            if _contains_sync(stmt):
                fenced = True

    for loop in _timed_loops(tree.ast):
        yield from walk_block(loop.body, False)


def _suppressed(tree: _Tree, line: int, rule_id: str) -> bool:
    for ln in (line, line - 1):
        if 1 <= ln <= len(tree.lines):
            m = _SUPPRESS.search(tree.lines[ln - 1])
            if m:
                ids = {t.strip() for t in m.group(1).split(",")}
                if rule_id in ids or "all" in ids:
                    return True
    return False



# ---------------------------------------------------------------------------
# GC101: no PyTorch meaning
# ---------------------------------------------------------------------------


@_rule(
    "GC101",
    "jit-missing-donation-or-out-shardings",
    "no PyTorch meaning: JAX's jax.jit donation / out_shardings discipline; "
    "the port has no jit and updates its state in place, so there is no "
    "buffer to donate (kept so the ids line up with JAX's catalog; never "
    "fires)",
    "nothing to fix in the port",
)
def _check_jit_discipline(root: str) -> Iterator[Violation]:
    return
    yield


# ---------------------------------------------------------------------------
# GC102: host syncs inside the timed loop
# ---------------------------------------------------------------------------

#: Attribute calls that copy a device value to the host (a fence).
_GC102_SYNC_ATTRS = frozenset({"item", "tolist", "cpu"})
#: Dotted calls that fence the card.
_GC102_SYNC_NAMES = frozenset({"torch.cuda.synchronize", "cuda.synchronize"})


@_rule(
    "GC102",
    "host-sync-in-timed-loop",
    "host-synchronizing call (.item()/.tolist()/.cpu()/float()/int()/"
    "torch.cuda.synchronize()) inside the timed `for step` loop of "
    "train/loop.py, outside its sync_window helper",
    "move the sync to a sync_window boundary (the loop already batches "
    "syncs every --sync-every steps); never fetch per-step values mid-window",
)
def _check_timed_loop_syncs(root: str) -> Iterator[Violation]:
    path = os.path.join(root, PACKAGE, "train", "loop.py")
    if not os.path.exists(path):
        return
    tree = _parsed(path, os.path.relpath(path, root))
    for loop in _timed_loops(tree.ast):
        # Lexical scope only: the fenced syncs live inside the sync_window
        # helper, a nested def that _stmt_calls skips.
        for stmt in loop.body:
            for call in _stmt_calls(stmt):
                name = _dotted(call.func)
                kind = None
                if name in ("float", "int") and call.args:
                    kind = ".item()-class host sync"
                elif name in _GC102_SYNC_NAMES:
                    kind = "device fence"
                elif isinstance(call.func, ast.Attribute) and call.func.attr in _GC102_SYNC_ATTRS:
                    kind = f".{call.func.attr}() host sync"
                if kind and not _suppressed(tree, call.lineno, "GC102"):
                    yield Violation(
                        "GC102", tree.rel, call.lineno,
                        f"{name or call.func.attr}(...) is a {kind} inside the "
                        "timed step loop",
                        RULES["GC102"].fix_hint,
                    )


# ---------------------------------------------------------------------------
# GC105: unfenced telemetry / file IO / prints in the timed loop
# ---------------------------------------------------------------------------


def _is_telemetry_io_call(call: ast.Call) -> Optional[str]:
    """Classify a call as loop-hostile IO, or None.

    Targets: ``print``/``open``/``os.write``/``json.dump``, any
    ``*.write()``/``.writelines()``/``.flush()`` method, and any call on a
    receiver whose name mentions ``recorder``/``telemetry`` (the flight
    recorder's surface). Device work and pure bookkeeping stay out of
    scope — the rule polices host IO cadence, not computation.
    """
    name = _dotted(call.func)
    if name in ("print", "open", "os.write", "json.dump", "json.dumps"):
        # json.dumps is not IO itself, but in the timed loop it only ever
        # exists to feed a write — flag the serialization too.
        return f"{name}() host IO"
    if isinstance(call.func, ast.Attribute):
        if call.func.attr in ("write", "writelines", "flush"):
            return f".{call.func.attr}() file IO"
        recv = _dotted(call.func.value) or ""
        if "recorder" in recv.lower() or "telemetry" in recv.lower():
            return f"telemetry call {recv}.{call.func.attr}()"
    return None


@_rule(
    "GC105",
    "unfenced-telemetry-io-in-timed-loop",
    "telemetry/file-IO/print call inside the timed `for step` loop of "
    "train/loop.py with no sync_window fence earlier in its block — host "
    "IO mid-window skews the very step times the loop publishes",
    "emit telemetry from inside sync_window (the sanctioned boundary), or "
    "place the call after a sync_window(...) fence in the same block; "
    "suppress deliberate exceptions with '# graftcheck: disable=GC105'",
)
def _check_timed_loop_telemetry_io(root: str) -> Iterator[Violation]:
    path = os.path.join(root, PACKAGE, "train", "loop.py")
    if not os.path.exists(path):
        return
    tree = _parsed(path, os.path.relpath(path, root))
    for call, fenced in _iter_timed_loop_calls(tree):
        if fenced:
            continue
        kind = _is_telemetry_io_call(call)
        if kind and not _suppressed(tree, call.lineno, "GC105"):
            yield Violation(
                "GC105", tree.rel, call.lineno,
                f"{kind} inside the timed step loop with no "
                "sync_window fence earlier in its block",
                RULES["GC105"].fix_hint,
            )


# ---------------------------------------------------------------------------
# GC106: signal handlers / blocking file IO in the timed loop
# ---------------------------------------------------------------------------

#: Handler-installation calls: flagged ANYWHERE inside the timed loop,
#: fenced or not — a handler swap has no business at any step cadence
#: (install once, outside; faults/preemption.py is the sanctioned home).
_SIGNAL_CALLS = frozenset({
    "signal.signal", "signal.setitimer", "signal.siginterrupt",
    "signal.pthread_sigmask", "signal.sigwait", "signal.sigtimedwait",
})
#: Blocking file IO: flagged unless fenced by a sync_window earlier in
#: the block (same fence rule as GC105's telemetry IO).
_BLOCKING_IO_CALLS = frozenset({
    "os.fsync", "os.fdatasync", "os.sync",
    "shutil.copy", "shutil.copy2", "shutil.copytree", "shutil.move",
})


@_rule(
    "GC106",
    "signal-handler-or-blocking-io-in-timed-loop",
    "signal-handler installation (anywhere) or unfenced blocking file IO "
    "(fsync-class) inside the timed `for step` loop of train/loop.py — "
    "the SIGTERM handler must live outside the loop (faults.PreemptionGuard "
    "installs it before the first dispatch), and fsync blocks the host "
    "thread inside published step times",
    "install signal handlers once, before the loop (faults/preemption.py); "
    "move fsync-class IO behind a sync_window fence (runtime/checkpoint.py "
    "owns durable writes at checkpoint boundaries); suppress deliberate "
    "exceptions with '# graftcheck: disable=GC106'",
)
def _check_timed_loop_signal_and_blocking_io(root: str) -> Iterator[Violation]:
    path = os.path.join(root, PACKAGE, "train", "loop.py")
    if not os.path.exists(path):
        return
    tree = _parsed(path, os.path.relpath(path, root))
    # Same fence walk as GC105 (shared _iter_timed_loop_calls); the rules
    # differ only in classification — signal installs ignore the fence.
    for call, fenced in _iter_timed_loop_calls(tree):
        name = _dotted(call.func)
        if name in _SIGNAL_CALLS:
            if not _suppressed(tree, call.lineno, "GC106"):
                yield Violation(
                    "GC106", tree.rel, call.lineno,
                    f"{name}(...) installs/changes a signal handler "
                    "inside the timed step loop",
                    RULES["GC106"].fix_hint,
                )
        elif (
            name in _BLOCKING_IO_CALLS and not fenced
            and not _suppressed(tree, call.lineno, "GC106")
        ):
            yield Violation(
                "GC106", tree.rel, call.lineno,
                f"{name}(...) is blocking file IO inside the timed "
                "step loop with no sync_window fence earlier in its "
                "block",
                RULES["GC106"].fix_hint,
            )


# ---------------------------------------------------------------------------
# GC111: blocking input IO / host-iterator pulls in the timed loop
# ---------------------------------------------------------------------------

#: Dotted-name calls GC111 classifies as blocking input IO. ``next`` is
#: the host-iterator pull (a DataLoader-style ``next(it)`` inside the
#: loop is exactly the serialization the prefetcher exists to remove);
#: ``time.sleep`` is an explicit stall.
_GC111_IO_NAMES = frozenset({
    "open", "io.open", "os.read", "os.pread", "time.sleep",
})
#: Attribute calls (``f.read()``/``f.seek()``-class) GC111 flags unless
#: the receiver is the sanctioned prefetch surface.
_GC111_ATTR_IO = frozenset({
    "read", "readline", "readlines", "readinto", "seek",
})


def _is_blocking_data_io(call: ast.Call) -> Optional[str]:
    """Classify a call as loop-hostile input IO, or None.

    The prefetch fence: any call whose receiver name mentions
    ``prefetch`` is the sanctioned blocking pull (data/prefetch.py
    ``HostPrefetcher.get`` — it measures its own wait into
    ``data_stall_frac``) and is never flagged.
    """
    name = _dotted(call.func)
    if name in _GC111_IO_NAMES:
        return f"{name}() blocking host IO"
    if name == "next" and call.args:
        return "next() host-iterator pull"
    if isinstance(call.func, ast.Attribute):
        recv = _dotted(call.func.value) or ""
        if "prefetch" in recv.lower():
            return None  # the sanctioned fence itself
        if call.func.attr in _GC111_ATTR_IO:
            return f".{call.func.attr}() blocking file IO"
    return None


@_rule(
    "GC111",
    "blocking-input-io-in-timed-loop",
    "blocking file IO / host-iterator next() / time.sleep inside a timed "
    "`for step` loop in data/ or train/ with no sync_window fence earlier "
    "in its block and outside the prefetch fence — input IO serialized "
    "into the timed loop lands inside the very step times the loop "
    "publishes (the starvation data_stall_frac exists to MEASURE)",
    "pull batches through the host prefetcher (data/prefetch.py "
    "HostPrefetcher.get — the sanctioned, wait-measured fence), or move "
    "the IO behind a sync_window fence; suppress deliberate exceptions "
    "with '# graftcheck: disable=GC111'",
)
def _check_timed_loop_blocking_input_io(root: str) -> Iterator[Violation]:
    for tree in _package_files(root, ("data", "train")):
        # Same fence walk as GC105/GC106 (shared _iter_timed_loop_calls):
        # a sync_window earlier in the block fences what follows; files
        # without a sync_window helper simply never fence.
        for call, fenced in _iter_timed_loop_calls(tree):
            if fenced:
                continue
            kind = _is_blocking_data_io(call)
            if kind and not _suppressed(tree, call.lineno, "GC111"):
                yield Violation(
                    "GC111", tree.rel, call.lineno,
                    f"{kind} inside the timed step loop with no "
                    "sync_window fence earlier in its block (and outside "
                    "the prefetch fence)",
                    RULES["GC111"].fix_hint,
                )



# ---------------------------------------------------------------------------
# GC103: unknown mesh axes
# ---------------------------------------------------------------------------


def known_mesh_axes(root: str) -> frozenset:
    """The mesh's axis names: the ``MeshAxes`` canon in parallel/mesh.py."""
    axes = set()
    mesh_py = os.path.join(root, PACKAGE, "parallel", "mesh.py")
    if os.path.exists(mesh_py):
        tree = _Tree(mesh_py, "parallel/mesh.py")
        for node in ast.walk(tree.ast):
            if isinstance(node, ast.ClassDef) and node.name == "MeshAxes":
                for stmt in node.body:
                    if (
                        isinstance(stmt, ast.AnnAssign)
                        and isinstance(stmt.value, ast.Constant)
                        and isinstance(stmt.value.value, str)
                    ):
                        axes.add(stmt.value.value)
    return frozenset(axes)


#: Mesh constructors -> (positional index, keyword) of their axis names.
_GC103_CONSTRUCTORS = {
    "make_mesh": (1, "axis_names"),
    "init_device_mesh": (None, "mesh_dim_names"),
    "DeviceMesh": (None, "mesh_dim_names"),
}
#: Mesh methods whose first argument is an axis name.
_GC103_METHODS = frozenset({"size", "get_group", "get_local_rank"})


def _gc103_axis_nodes(node: ast.AST) -> List[ast.AST]:
    """The argument nodes of one call or subscript that name mesh axes."""
    if isinstance(node, ast.Call):
        name = (_dotted(node.func) or "").rsplit(".", 1)[-1]
        if name in _GC103_CONSTRUCTORS:
            pos, kw = _GC103_CONSTRUCTORS[name]
            out = [k.value for k in node.keywords if k.arg == kw]
            if pos is not None and len(node.args) > pos:
                out.append(node.args[pos])
            return out
        if (isinstance(node.func, ast.Attribute) and node.func.attr in _GC103_METHODS
                and node.args and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)):
            return [node.args[0]]
    if isinstance(node, ast.Subscript):
        recv = _dotted(node.value) or ""
        if "mesh" in recv.lower():
            return [node.slice]
    return []


@_rule(
    "GC103",
    "unknown-mesh-axis",
    "an axis name passed to the mesh (make_mesh, DeviceMesh / "
    "init_device_mesh mesh_dim_names, a mesh's size/get_group/"
    "get_local_rank, a mesh[...] slice) that is not one of its five",
    "use an axis of parallel/mesh.py's MeshAxes (data, seq, model, pipe, "
    "expert), or add the new axis there first",
)
def _check_mesh_axes(root: str) -> Iterator[Violation]:
    known = known_mesh_axes(root)
    if not known:
        return
    for tree in _package_files(root, ("",)):
        for node in ast.walk(tree.ast):
            for arg in _gc103_axis_nodes(node):
                for axis, line in _literal_axis_names(arg):
                    if axis in known or _suppressed(tree, line, "GC103"):
                        continue
                    yield Violation(
                        "GC103", tree.rel, line,
                        f"mesh axis {axis!r}; known mesh axes are {sorted(known)}",
                        RULES["GC103"].fix_hint,
                    )


def _literal_axis_names(node: ast.AST) -> List[Tuple[str, int]]:
    """(axis, lineno) for every string literal in an axis-bearing arg: a
    bare 'data', ('pipe', 'seq') tuples, lists."""
    out: List[Tuple[str, int]] = []
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        out.append((node.value, node.lineno))
    elif isinstance(node, (ast.Tuple, ast.List)):
        for el in node.elts:
            if isinstance(el, ast.Constant) and isinstance(el.value, str):
                out.append((el.value, el.lineno))
    return out


# ---------------------------------------------------------------------------
# GC104: wall-clock reads in the hot-path modules
# ---------------------------------------------------------------------------


@_rule(
    "GC104",
    "time-time-in-hot-path",
    "time.time() in train/, models/ or ops/ — a wall clock that can step "
    "(NTP), read where the step is timed",
    "host-side timing uses time.perf_counter(); device timing belongs to the "
    "profiler (--profile-dir) or CUDA events",
)
def _check_time_time(root: str) -> Iterator[Violation]:
    for tree in _package_files(root, ("train", "models", "ops")):
        for node in ast.walk(tree.ast):
            if (
                isinstance(node, ast.Call)
                and _dotted(node.func) == "time.time"
                and not _suppressed(tree, node.lineno, "GC104")
            ):
                yield Violation(
                    "GC104", tree.rel, node.lineno,
                    "time.time() call in hot-path code",
                    RULES["GC104"].fix_hint,
                )


# ---------------------------------------------------------------------------
# GC107: implicit-dtype constants in model code
# ---------------------------------------------------------------------------

_GC107_CONSTRUCTORS = frozenset({
    "torch.tensor", "torch.ones", "torch.zeros", "torch.empty", "torch.full",
    "torch.arange",
})


@_rule(
    "GC107",
    "implicit-dtype-constant-in-model-code",
    "torch.tensor/ones/zeros/empty/full/arange without dtype= in models/ or "
    "ops/ — the default dtype is implicit, and a float32 constant promotes "
    "the bf16 arithmetic around it (the bf16->f32 converts the audit pins)",
    "pass dtype= (the config's compute/param dtype, the operand's x.dtype, "
    "or torch.int64/torch.float32 where that is meant); python scalars in "
    "arithmetic need no tensor at all",
)
def _check_implicit_f32_constants(root: str) -> Iterator[Violation]:
    for tree in _package_files(root, ("models", "ops")):
        for node in ast.walk(tree.ast):
            if not isinstance(node, ast.Call):
                continue
            name = _dotted(node.func)
            if name not in _GC107_CONSTRUCTORS:
                continue
            # A ``**kwargs`` splat may carry the dtype: not provably implicit.
            if any(kw.arg in ("dtype", None) for kw in node.keywords):
                continue
            if _suppressed(tree, node.lineno, "GC107"):
                continue
            yield Violation(
                "GC107", tree.rel, node.lineno,
                f"{name}(...) without a dtype in model code",
                RULES["GC107"].fix_hint,
            )


# ---------------------------------------------------------------------------
# GC108: collectives without a mesh group
# ---------------------------------------------------------------------------

#: torch.distributed callables -> the positional index of their group.
_GC108_COLLECTIVES = {
    "all_reduce": 2, "all_gather": 2, "all_gather_into_tensor": 2,
    "reduce_scatter": 3, "reduce_scatter_tensor": 3, "all_to_all": 2,
    "all_to_all_single": 4, "broadcast": 2, "reduce": 3, "gather": 3, "scatter": 3,
    "barrier": 0, "all_gather_object": 2, "broadcast_object_list": 2,
    "send": 2, "recv": 2, "isend": 2, "irecv": 2, "P2POp": 3,
}
_GC108_PREFIXES = ("dist.", "torch.distributed.")
#: Group expressions the mesh did not make.
_GC108_UNMADE = frozenset({
    "dist.group.WORLD", "torch.distributed.group.WORLD", "dist.GroupMember.WORLD",
    "torch.distributed.GroupMember.WORLD",
})


def _gc108_collective(call: ast.Call) -> Optional[Tuple[str, int]]:
    name = _dotted(call.func) or ""
    for prefix in _GC108_PREFIXES:
        if name.startswith(prefix) and name[len(prefix):] in _GC108_COLLECTIVES:
            short = name[len(prefix):]
            return short, _GC108_COLLECTIVES[short]
    return None


def _gc108_unmade(node: ast.AST) -> bool:
    if isinstance(node, ast.Constant) and node.value is None:
        return True
    if _dotted(node) in _GC108_UNMADE:
        return True
    return isinstance(node, ast.Call) and (_dotted(node.func) or "").endswith("new_group")


@_rule(
    "GC108",
    "collective-without-mesh-group",
    "torch.distributed collective in parallel/, models/ or ops/ with no "
    "group= (it runs over the default group, whatever the mesh) or with a "
    "group the mesh did not make (None, group.WORLD, an inline new_group)",
    "pass the mesh's group for the axis (mesh.data_group, model_group, "
    "pipe_group, ...; parallel/mesh.py); suppress a deliberate whole-group "
    "collective with '# graftcheck: disable=GC108'",
)
def _check_collective_groups(root: str) -> Iterator[Violation]:
    for tree in _package_files(root, ("parallel", "models", "ops")):
        for call in ast.walk(tree.ast):
            if not isinstance(call, ast.Call):
                continue
            hit = _gc108_collective(call)
            if hit is None:
                continue
            short, pos = hit
            group = [kw.value for kw in call.keywords if kw.arg == "group"]
            if not group and len(call.args) > pos:
                group = [call.args[pos]]
            if group and not _gc108_unmade(group[0]):
                continue
            if _suppressed(tree, call.lineno, "GC108"):
                continue
            what = "no group=" if not group else "a group the mesh did not make"
            yield Violation(
                "GC108", tree.rel, call.lineno,
                f"{_dotted(call.func)}(...) with {what}",
                RULES["GC108"].fix_hint,
            )


# ---------------------------------------------------------------------------
# GC109: host syncs / re-placements in the per-micro-batch loops
# ---------------------------------------------------------------------------

_GC109_FILES = ("pipeline.py", "interleaved.py")
#: The transport's per-message path, called every tick of the schedule loops.
_GC109_PER_MESSAGE = frozenset({("Transport", "post"), ("_Inbound", "get")})
_GC109_SYNC_ATTRS = frozenset({"item", "tolist", "cpu", "numpy", "synchronize"})
_GC109_PLACE_ATTRS = frozenset({"to", "cuda", "pin_memory"})


def _gc109_classify(call: ast.Call) -> Optional[str]:
    name = _dotted(call.func)
    if name in _GC102_SYNC_NAMES:
        return f"{name}(...) fences the card"
    if isinstance(call.func, ast.Attribute):
        if call.func.attr in _GC109_SYNC_ATTRS:
            return f".{call.func.attr}() is a host sync"
        if call.func.attr in _GC109_PLACE_ATTRS:
            return f".{call.func.attr}(...) re-places a value"
    for kw in call.keywords:
        if kw.arg == "pin_memory" and not (isinstance(kw.value, ast.Constant)
                                           and kw.value.value is False):
            return f"{name or 'a constructor'}(..., pin_memory=...) stages through host memory"
    return None


def _gc109_regions(tree_ast: ast.AST) -> Iterator[List[ast.AST]]:
    """The statement lists GC109 polices: every ``for ... in range(...)``
    loop's body, and the per-message transport methods."""
    for node in ast.walk(tree_ast):
        if (isinstance(node, ast.For) and isinstance(node.iter, ast.Call)
                and _dotted(node.iter.func) == "range"):
            yield node.body + node.orelse
        elif isinstance(node, ast.ClassDef):
            for stmt in node.body:
                if (isinstance(stmt, ast.FunctionDef)
                        and (node.name, stmt.name) in _GC109_PER_MESSAGE):
                    yield stmt.body


@_rule(
    "GC109",
    "per-microbatch-sync-or-replacement-in-schedule-loop",
    "host sync (.item()/.cpu()/synchronize()) or re-placement (.to(...), "
    ".cuda(), pinned memory) inside a per-micro-batch loop of "
    "parallel/pipeline.py or parallel/interleaved.py (their range() loops "
    "and the transport's per-message path) — one fence or copy per "
    "micro-batch in the schedule",
    "keep the message on the device (NCCL sends device tensors as they "
    "are); hoist placements out of the schedule loop; suppress deliberate "
    "exceptions with '# graftcheck: disable=GC109' and the reason",
)
def _check_schedule_loop_reshards(root: str) -> Iterator[Violation]:
    for tree in _package_files(root, ("parallel",)):
        if os.path.basename(tree.rel) not in _GC109_FILES:
            continue
        seen = set()  # nested loops would report an inner call twice
        for region in _gc109_regions(tree.ast):
            for stmt in region:
                for call in ast.walk(stmt):
                    if not isinstance(call, ast.Call):
                        continue
                    kind = _gc109_classify(call)
                    if (kind and (call.lineno, call.col_offset) not in seen
                            and not _suppressed(tree, call.lineno, "GC109")):
                        seen.add((call.lineno, call.col_offset))
                        yield Violation(
                            "GC109", tree.rel, call.lineno,
                            f"{kind} inside a per-micro-batch schedule loop",
                            RULES["GC109"].fix_hint,
                        )


# ---------------------------------------------------------------------------
# GC112: hard-coded exit-code literals outside the central EXIT_* registry
# ---------------------------------------------------------------------------

#: Receiver names that mark a comparison as exit-code-shaped: `rc == 75`,
#: `proc.returncode in (75, 76)`, `exit_code != 77`. Deliberately narrow —
#: a bare 75 elsewhere (a percentile, a size) is not this rule's business.
_GC112_RECEIVER = re.compile(
    r"(^|_)(rc|returncode|exit_?code|exit_?status)(_|\d*$)", re.IGNORECASE
)
_GC112_EXIT_NAME = re.compile(r"^EXIT_[A-Z0-9_]+$")
#: Call targets whose integer argument IS a process exit code.
_GC112_EXIT_CALLS = frozenset({"sys.exit", "os._exit", "exit", "SystemExit"})


def _gc112_registry(root: str):
    """Harvest the central registry: every module-level ``EXIT_NAME = int``
    assignment in the package -> {value: name}, plus the defining
    (file, line) pairs (exempt by construction — the registry itself is
    the one place the literals belong)."""
    values: Dict[int, str] = {}
    defining = set()
    for tree in _package_files(root, ("",)):
        for node in tree.ast.body:
            if not isinstance(node, ast.Assign) or len(node.targets) != 1:
                continue
            target = node.targets[0]
            if not (isinstance(target, ast.Name)
                    and _GC112_EXIT_NAME.match(target.id)):
                continue
            if isinstance(node.value, ast.Constant) and isinstance(
                node.value.value, int
            ):
                values[node.value.value] = target.id
                defining.add((tree.rel, node.lineno))
    return values, defining


def _gc112_compare_is_exitish(node: ast.Compare) -> bool:
    for side in [node.left, *node.comparators]:
        ident = None
        if isinstance(side, ast.Attribute):
            ident = side.attr
        elif isinstance(side, ast.Name):
            ident = side.id
        if ident and _GC112_RECEIVER.search(ident):
            return True
    return False


def _gc112_literals(node: ast.AST) -> Iterator[ast.Constant]:
    """Int literals inside one expression (tuples/lists/sets unpacked —
    the ``rc in (75, 76)`` shape)."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and type(sub.value) is int:
            yield sub


@_rule(
    "GC112",
    "hard-coded-exit-code-literal",
    "a registry exit-code value (EXIT_PREEMPTED 75 / EXIT_HUNG 76 / "
    "EXIT_NOTHING_TO_RESUME 77 / EXIT_DATA_STALL 78 — harvested, not "
    "hard-coded here either) as a bare integer literal in an exit call "
    "or an exit-code comparison, outside the defining EXIT_* assignment",
    "import the named constant from the faults package (e.g. "
    "`from ..faults import EXIT_PREEMPTED`) instead of its integer value — "
    "the renumbering that moved EXIT_NOTHING_TO_RESUME 76 -> 77 is exactly "
    "the drift this rule exists to catch",
)
def _check_exit_code_literals(root: str) -> Iterator[Violation]:
    values, defining = _gc112_registry(root)
    if not values:
        return
    for tree in _package_files(root, ("",)):
        for node in ast.walk(tree.ast):
            hits: List[ast.Constant] = []
            if isinstance(node, ast.Call):
                name = _dotted(node.func)
                if name in _GC112_EXIT_CALLS:
                    hits = [
                        c for arg in node.args for c in _gc112_literals(arg)
                    ]
            elif isinstance(node, ast.Compare):
                if _gc112_compare_is_exitish(node):
                    hits = [
                        c for side in [node.left, *node.comparators]
                        for c in _gc112_literals(side)
                    ]
            for lit in hits:
                if lit.value not in values:
                    continue
                if (tree.rel, lit.lineno) in defining:
                    continue
                if _suppressed(tree, lit.lineno, "GC112"):
                    continue
                yield Violation(
                    "GC112", tree.rel, lit.lineno,
                    f"hard-coded exit code {lit.value} "
                    f"({values[lit.value]}) outside the central EXIT_* "
                    "registry",
                    RULES["GC112"].fix_hint,
                )


# ---------------------------------------------------------------------------
# GC201: entrypoint <-> harness flag-surface drift
# ---------------------------------------------------------------------------

_FLAG_TOKEN = re.compile(r"--[a-z][a-z0-9-]+")


@_rule(
    "GC201",
    "entrypoint-flag-drift",
    "docker/entrypoint.sh env contract out of sync with "
    "train/harness.py::build_parser() — in either direction",
    "plumb the new flag through an env var in docker/entrypoint.sh (or add "
    "it to lint.ENTRYPOINT_EXEMPT_FLAGS with a reason); delete stale flags "
    "the harness no longer defines",
)
def _check_entrypoint_drift(root: str) -> Iterator[Violation]:
    entrypoint = os.path.join(root, "docker", "entrypoint.sh")
    if not os.path.exists(entrypoint):
        return
    from ...train.harness import build_parser

    parser_flags = set()
    for action in build_parser()._actions:
        parser_flags.update(
            o for o in action.option_strings if o.startswith("--")
        )
    parser_flags.discard("--help")

    text = open(entrypoint).read()
    entry_flags = set(_FLAG_TOKEN.findall(text))

    stale = entry_flags - parser_flags - ENTRYPOINT_WRAPPER_FLAGS
    if stale:
        yield Violation(
            "GC201", "docker/entrypoint.sh", 1,
            f"passes flags the harness does not define: {sorted(stale)}",
            RULES["GC201"].fix_hint,
        )
    missing = parser_flags - entry_flags - ENTRYPOINT_EXEMPT_FLAGS
    if missing:
        yield Violation(
            "GC201", "docker/entrypoint.sh", 1,
            f"harness flags with no container-env plumbing: {sorted(missing)}",
            RULES["GC201"].fix_hint,
        )


# ---------------------------------------------------------------------------
# Runner
# ---------------------------------------------------------------------------


def run_lint(
    root: str = REPO_ROOT,
    rules: Optional[Tuple[str, ...]] = None,
    files: Optional[Tuple[str, ...]] = None,
) -> List[Violation]:
    """Run every registered rule (or the named subset) over ``root``.

    ``files`` (repo-relative paths) scopes the REPORT to those files —
    the `--changed` pre-commit path. Rules still scan the whole package
    for their knowledge bases (GC103's mesh-axis harvest, GC201's flag
    surfaces), so a changed file is judged against unchanged context; a
    violation is only emitted when it sits in a changed file.
    """
    out: List[Violation] = []
    for rule, check in _CHECKS:
        if rules is not None and rule.id not in rules:
            continue
        out.extend(v for v in check(root) if v is not None)
    if files is not None:
        wanted = {f.replace(os.sep, "/") for f in files}
        out = [v for v in out if v.path.replace(os.sep, "/") in wanted]
    return sorted(out, key=lambda v: (v.path, v.line, v.rule_id))
