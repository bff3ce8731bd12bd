"""The port's scaling suite (``scripts/torch_scaling_suite.sh``) against the
JAX package's analysis and gate.

A module fixture runs ``scripts/torch_scaling_suite.sh --dryrun`` once:
tier S, fsdp, two geometries (ws 1 and ws 2 as two gloo ranks under
``runtime.launch``), each a fresh run of 12 steps with a checkpoint every
3, the grow leg (ws 2 resuming ws 1's checkpoint, a reshard of FSDP2's
shards) and the shrink leg (ws 1 resuming ws 2's), then the stamp, the
validator, ingest into the suite's own registry, the curves, the gate and
the report. Held here:

- exit 0, and the stages in JAX's order (``STAGE`` lines);
- each fresh row stamped with ``scaling_efficiency`` (the base 1.0), the
  stitch and shrink rows flagged ``resumed`` and
  ``resume_geometry_changed`` and never stamped;
- the stamps equal what JAX's ``analysis.scaling.stamp_results_dir``
  writes into a copy of the same rows, the curves equal JAX's
  ``build_curves`` over a registry JAX's ``regress`` ingested from the same
  rows, and every arm's gate verdict equals JAX's ``gate_arm`` there: the
  stitched candidates are skipped, not gated;
- the script's contract (JAX's ``tests/test_scaling.py``'s, on the port's
  script) and its wiring into ``scripts/torch_run_all_benchmarks.sh``.
"""

import glob
import json
import os
import shutil
import stat
import subprocess
from pathlib import Path

import pytest

from distributed_llm_training_benchmark_framework_tpu.analysis import scaling as jscaling
from distributed_llm_training_benchmark_framework_tpu.regress import compare as jcompare
from distributed_llm_training_benchmark_framework_tpu.regress import store as jstore
from distributed_llm_training_benchmark_framework_tpu_torch.analysis import scaling as tscaling
from distributed_llm_training_benchmark_framework_tpu_torch.regress import compare as tcompare
from distributed_llm_training_benchmark_framework_tpu_torch.regress import store as tstore

REPO = Path(__file__).resolve().parents[1]
SCRIPT = REPO / "scripts" / "torch_scaling_suite.sh"
RUNS = ("scaling-fsdp-ws1", "scaling-fsdp-ws2", "scaling-fsdp-ws2-stitch",
        "scaling-fsdp-ws1-shrink")


@pytest.fixture(scope="module")
def suite(tmp_path_factory):
    out = tmp_path_factory.mktemp("scaling")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                "REGISTRY_DIR", "RESULTS_DIR", "DIST_BACKEND"):
        env.pop(var, None)
    proc = subprocess.run([str(SCRIPT), "--dryrun", "--results-dir", str(out / "res"),
                           "--registry", str(out / "res" / "registry")],
                          capture_output=True, text=True, env=env, timeout=600)
    return proc, out / "res"


def _row(res, run):
    (path,) = glob.glob(str(res / f"{run}_results" / "result_*.json"))
    return json.loads(Path(path).read_text())


def test_dryrun_exits_0_through_every_stage(suite):
    proc, res = suite
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "=== Scaling suite complete: 0 failure(s) ===" in proc.stdout
    stages = [line.split()[1] for line in proc.stdout.splitlines() if line.startswith("STAGE ")]
    assert stages == list(RUNS) + ["stamp", "validate", "registry", "gate", "report"]
    assert (res / "summary" / "scaling_curves.json").exists()
    assert (res / "summary" / "BENCHMARK_REPORT.md").exists()
    assert "VALIDATE PASS" in proc.stdout


def test_fresh_rows_are_stamped_and_legs_are_flagged(suite):
    _, res = suite
    rows = {run: _row(res, run) for run in RUNS}
    assert [rows[r]["world_size"] for r in RUNS] == [1, 2, 2, 1]
    for run in RUNS[:2]:
        assert rows[run]["resumed"] is False
        assert rows[run]["scaling_efficiency"] is not None
    assert rows[RUNS[0]]["scaling_efficiency"] == pytest.approx(1.0)
    for run in RUNS[2:]:
        assert rows[run]["resumed"] is True and rows[run]["resume_geometry_changed"] is True
        assert rows[run].get("scaling_efficiency") is None
        assert rows[run]["steps"] == 12 + 3 and rows[run]["resume_step"] == 11


def test_stamps_equal_jaxs(suite, tmp_path):
    _, res = suite
    stamped = []
    for tag, mod in (("jax", jscaling), ("port", tscaling)):
        d = tmp_path / tag
        shutil.copytree(res, d, ignore=shutil.ignore_patterns("*_ckpt", "registry", "summary"))
        for path in glob.glob(str(d / "*_results" / "result_*.json")):
            row = json.loads(Path(path).read_text())
            row.pop("scaling_efficiency", None)
            Path(path).write_text(json.dumps(row))
        pairs = mod.stamp_results_dir(str(d))
        stamped.append(sorted((os.path.relpath(p, d), v) for p, v in pairs))
    assert stamped[0] == stamped[1] and len(stamped[1]) == 2
    want = dict(stamped[1])
    for run in RUNS[:2]:
        (path,) = [p for p in want if p.startswith(f"{run}_results")]
        assert _row(res, run)["scaling_efficiency"] == want[path]


def test_curves_and_gate_equal_jaxs(suite, tmp_path):
    _, res = suite
    jreg = jstore.Registry(str(tmp_path / "jax_registry"))
    jstore.ingest_results_dir(jreg, str(res))
    treg = tstore.Registry(str(res / "registry"))
    jc, jn = jscaling.build_curves(jreg)
    tc, tn = tscaling.build_curves(treg)
    assert tscaling.curves_to_json(tc, tn) == jscaling.curves_to_json(jc, jn)
    written = json.loads((res / "summary" / "scaling_curves.json").read_text())
    assert written == json.loads(json.dumps(tscaling.curves_to_json(tc, tn)))
    arms = treg.arms()
    assert sorted(arms) == sorted(jreg.arms()) == ["fsdp_ws1_seq64_tierS", "fsdp_ws2_seq64_tierS"]
    for arm in arms:
        verdict, line = tcompare.gate_arm(treg, arm, bank_regressions=False)
        assert verdict == jcompare.gate_arm(jreg, arm, bank_regressions=False)[0], arm
        # The fresh row is the candidate; the stitched row is never its baseline.
        assert verdict == "insufficient-data" and "no prior ok record" in line, line


def test_script_contract():
    """JAX's ``test_scaling_suite_script_contract``, on the port's script."""
    assert os.stat(SCRIPT).st_mode & stat.S_IXUSR
    body = SCRIPT.read_text()
    assert "--dryrun" in body
    assert "-stitch" in body and "-shrink" in body and "--resume" in body
    assert "--stamp-results-dir" in body
    assert "gate --all" in body
    assert body.index("stamp-results-dir") < body.index("ingest"), (
        "efficiency must be stamped before registry ingest or the records never carry it")
    assert "runtime.launch" in body and "torch.cuda.device_count()" in body
    assert "results/registry\"" not in body and "import jax" not in body


def test_run_all_wires_the_scaling_suite_behind_its_flag():
    body = (REPO / "scripts" / "torch_run_all_benchmarks.sh").read_text()
    assert 'SCALING_SUITE="${SCALING_SUITE:-0}"' in body
    assert 'SKIP_SCALING="${SKIP_SCALING:-0}"' in body
    assert "scripts/torch_scaling_suite.sh --dryrun" in body
