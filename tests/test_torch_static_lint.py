"""The port's graftcheck lint (``analysis/static/lint.py``) held against the
JAX package's (``analysis/static/lint.py``):

- the catalogs have the same ids, GC101 included (no PyTorch meaning, never
  fires), and ``--list-rules`` prints them with GC110 (the memory audit);
- the framework-neutral rules (GC105, GC106, GC111, GC112, GC201) report
  the same (rule, path within the package, line) set on the same fixture
  source laid out under a temporary root as each package;
- each re-aimed rule (GC102, GC103, GC104, GC107, GC108, GC109) fires on a
  fixture and not on its twin that carries ``# graftcheck: disable=RULE``;
- ``run_lint()`` on the port's own tree is clean, and ``--changed`` scopes
  findings to the files given.
"""

import os
import textwrap

import pytest

from distributed_llm_training_benchmark_framework_tpu.analysis.static import lint as jlint
from distributed_llm_training_benchmark_framework_tpu_torch.analysis.static import (
    __main__ as tcli,
)
from distributed_llm_training_benchmark_framework_tpu_torch.analysis.static import lint as tlint
from torch_threads import one_thread  # noqa: F401  (autouse)

JAX_PKG = jlint.PACKAGE
PKG = tlint.PACKAGE


def _lay_out(root, package: str, files: dict) -> None:
    """Write ``files`` ({path: source}) under ``root``; a path starting with
    "PKG/" goes under ``package``."""
    for rel, src in files.items():
        if rel.startswith("PKG/"):
            rel = package + rel[3:]
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(textwrap.dedent(src))


def _findings(lint_mod, root, rules):
    out = set()
    for v in lint_mod.run_lint(str(root), rules=rules):
        path = v.path.replace(os.sep, "/")
        pkg = lint_mod.PACKAGE + "/"
        out.add((v.rule_id, path[len(pkg):] if path.startswith(pkg) else path, v.line))
    return out


# ---------------------------------------------------------------------------
# The catalog
# ---------------------------------------------------------------------------


def test_catalogs_have_the_same_ids():
    assert list(tlint.RULES) == list(jlint.RULES)
    assert "GC101" in tlint.RULES and "no PyTorch meaning" in tlint.RULES["GC101"].description
    assert tlint.PACKAGE == "distributed_llm_training_benchmark_framework_tpu_torch"


def test_list_rules_prints_the_ids_and_gc110(capsys):
    assert tcli.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    ids = [ln.split()[0] for ln in out.splitlines() if ln.startswith("GC")]
    assert ids == list(jlint.RULES) + ["GC110"]


def test_the_ports_own_tree_is_clean():
    violations = tlint.run_lint()
    assert violations == [], "\n".join(map(str, violations))


# ---------------------------------------------------------------------------
# The framework-neutral rules: the same findings as JAX's
# ---------------------------------------------------------------------------

LOOP = """\
import json
import os
import signal
import shutil


def run(steps, recorder, sync_window, f, data):
    for step in range(steps):
        print("step", step)
        recorder.note("x", step=step)
        json.dump({}, f)
        signal.signal(signal.SIGTERM, None)
        os.fsync(3)
        shutil.copy("a", "b")
        with open("log.txt", "w") as g:
            g.write("x")
        sync_window(step)
        print("fenced")
        os.fsync(4)
        signal.setitimer(signal.ITIMER_REAL, 1)
        print("suppressed")  # graftcheck: disable=GC105
"""

DATA = """\
import time


def consume(steps, it, f, prefetch, sync_window):
    for step in range(steps):
        batch = next(it)
        f.read(10)
        f.seek(0)
        time.sleep(0.1)
        b = prefetch.get(step)
        with open("shard.bin", "rb") as g:
            g.readinto(b)
        sync_window(step)
        f.read(1)
        next(it)  # graftcheck: disable=GC111
"""

EXIT_CODES = """\
EXIT_PREEMPTED = 75
EXIT_HUNG = 76
EXIT_NOTHING_TO_RESUME = 77
EXIT_DATA_STALL = 78
"""

EXITS = """\
import os
import sys


def finish(rc, proc, exit_code):
    if rc == 75:
        sys.exit(76)
    if proc.returncode in (77, 78):
        os._exit(78)
    if exit_code != 75:  # graftcheck: disable=GC112
        raise SystemExit(77)
    if rc == 3:
        sys.exit(1)
"""

ENTRYPOINT = """\
#!/bin/bash
exec python -m harness --strategy "$STRATEGY" --no-such-flag --drop-on-retry
"""

NEUTRAL = {
    "GC105": {"PKG/train/loop.py": LOOP},
    "GC106": {"PKG/train/loop.py": LOOP},
    "GC111": {"PKG/data/reader.py": DATA, "PKG/train/loop.py": LOOP},
    "GC112": {"PKG/exit_codes.py": EXIT_CODES, "PKG/runtime/exits.py": EXITS},
    "GC201": {"docker/entrypoint.sh": ENTRYPOINT},
}


@pytest.mark.parametrize("rule", sorted(NEUTRAL))
def test_neutral_rule_reports_what_jax_reports(tmp_path, rule):
    roots = {}
    for name, package in (("jax", JAX_PKG), ("port", PKG)):
        roots[name] = tmp_path / name
        _lay_out(roots[name], package, NEUTRAL[rule])
    port = _findings(tlint, roots["port"], (rule,))
    assert port == _findings(jlint, roots["jax"], (rule,))
    assert port, f"the {rule} fixture must fire"


# ---------------------------------------------------------------------------
# The re-aimed rules: a fixture that fires, a suppressed twin that does not
# ---------------------------------------------------------------------------

MESH = """\
import dataclasses


@dataclasses.dataclass(frozen=True)
class MeshAxes:
    data: str = "data"
    model: str = "model"
    seq: str = "seq"
    pipe: str = "pipe"
    expert: str = "expert"
"""

REAIMED = {
    # rule: (files, the offending line, where it sits)
    "GC102": ({"PKG/train/loop.py": """\
        import torch


        def run(steps, step_fn, sync_window):
            for step in range(steps):
                loss = step_fn(step)
                {bad}
                sync_window(step)
        """}, "torch.cuda.synchronize()", "PKG/train/loop.py"),
    "GC103": ({"PKG/parallel/mesh.py": MESH, "PKG/parallel/use.py": """\
        def width(mesh):
            {bad}
        """}, 'return mesh.size("tensor")', "PKG/parallel/use.py"),
    "GC104": ({"PKG/ops/timing.py": """\
        import time


        def stamp():
            {bad}
        """}, "return time.time()", "PKG/ops/timing.py"),
    "GC107": ({"PKG/models/block.py": """\
        import torch


        def scale(x):
            {bad}
        """}, "return x * torch.tensor(0.5)", "PKG/models/block.py"),
    "GC108": ({"PKG/parallel/reduce.py": """\
        import torch.distributed as dist


        def total(x):
            {bad}
        """}, "dist.all_reduce(x)", "PKG/parallel/reduce.py"),
    "GC109": ({"PKG/parallel/pipeline.py": """\
        def ticks(inbox, device, M):
            for t in range(M):
                {bad}
        """}, "x = inbox[t].to(device)", "PKG/parallel/pipeline.py"),
}


@pytest.mark.parametrize("suppressed", [False, True], ids=["fires", "suppressed"])
@pytest.mark.parametrize("rule", sorted(REAIMED))
def test_reaimed_rule_fires_and_its_suppressed_twin_does_not(tmp_path, rule, suppressed):
    files, bad, where = REAIMED[rule]
    if suppressed:
        bad += f"  # graftcheck: disable={rule}"
    _lay_out(tmp_path, PKG, {k: v.replace("{bad}", bad) for k, v in files.items()})
    found = _findings(tlint, tmp_path, (rule,))
    if suppressed:
        assert found == set()
    else:
        assert {(r, p) for r, p, _ in found} == {(rule, where[len("PKG/"):])}, found


def test_gc108_flags_a_group_the_mesh_did_not_make(tmp_path):
    _lay_out(tmp_path, PKG, {"PKG/ops/x.py": """\
        import torch.distributed as dist


        def f(x, mesh):
            dist.all_reduce(x, group=mesh.model_group)
            dist.all_reduce(x, group=dist.group.WORLD)
            dist.all_gather_into_tensor(x, x, dist.new_group([0, 1]))
            dist.P2POp(dist.isend, x, 1, mesh.pipe_group)
            dist.P2POp(dist.isend, x, 1, tag=0)
        """})
    assert {line for _, _, line in _findings(tlint, tmp_path, ("GC108",))} == {6, 7, 9}


def test_gc107_takes_a_dtype_keyword_or_a_splat(tmp_path):
    _lay_out(tmp_path, PKG, {"PKG/models/x.py": """\
        import torch


        def f(shape, kw):
            a = torch.zeros(shape, dtype=torch.float32)
            b = torch.zeros(shape, **kw)
            c = torch.arange(4)
        """})
    assert {line for _, _, line in _findings(tlint, tmp_path, ("GC107",))} == {7}


def test_gc101_never_fires(tmp_path):
    _lay_out(tmp_path, PKG, {"PKG/train/step.py": "import jax\nstep = jax.jit(lambda x: x)\n"})
    assert _findings(tlint, tmp_path, ("GC101",)) == set()
    _lay_out(tmp_path, JAX_PKG, {"PKG/train/step.py": "import jax\nstep = jax.jit(lambda x: x)\n"})
    assert _findings(jlint, tmp_path, ("GC101",)) == {("GC101", "train/step.py", 2)}


def test_files_scope_the_report(tmp_path):
    files, bad, where = REAIMED["GC104"]
    _lay_out(tmp_path, PKG, {k: v.replace("{bad}", bad) for k, v in files.items()})
    rel = PKG + where[len("PKG"):]
    assert len(tlint.run_lint(str(tmp_path), rules=("GC104",), files=(rel,))) == 1
    assert tlint.run_lint(str(tmp_path), rules=("GC104",), files=("README.md",)) == []
