"""The port's local benchmark suite (``scripts/torch_run_all_benchmarks.sh``)
held against the JAX side's ``scripts/run_all_benchmarks.sh``:

- the plan: ``SUITE_DRY_RUN=1`` for the port (``DEVICE=cpu WORLD_SIZES="1 2
  4 8"``) and for JAX (8 forced host devices; JAX only plans, no arm runs)
  print the same ``PLAN`` lines, strategy x world size and the 14-arm
  composition roster at the widest world size, flags and all. The one
  difference is where the device goes: the port's header line says
  ``device=cpu`` and every arm gets ``--device cpu``, outside the plan's
  flags;
- one tiny end-to-end run on the CPU (``DEVICE=cpu TIER=S SEQ_LEN=32
  STEPS=6 WARMUP_STEPS=1 STRATEGIES="ddp zero2" WORLD_SIZES="1 2"
  SKIP_CHAOS=1``, and ``SKIP_PREFLIGHT=1``: the preflight's graftcheck runs
  in ``tests/test_torch_static_audit.py``): "Suite complete: 4 passed, 0
  failed", ``VALIDATE PASS``, a metrics.csv with one row per (strategy,
  ws), the plots, the report's Key findings, and the registry's records
  stamped with the port's ``backend`` (the device type) and torch version;
- the refusals: ``--k8s`` and ``SCALING_SUITE=1`` exit non-zero naming
  ROADMAP item 19, ``LAYER_LOOP=scan`` exits non-zero, and ``DEVICE=cpu``
  without ``WORLD_SIZES`` exits non-zero.
"""

import csv
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUITE = os.path.join(REPO, "scripts", "torch_run_all_benchmarks.sh")
JAX_SUITE = os.path.join(REPO, "scripts", "run_all_benchmarks.sh")
TINY = {"DEVICE": "cpu", "TIER": "S", "SEQ_LEN": "32", "STEPS": "6", "WARMUP_STEPS": "1",
        "STRATEGIES": "ddp zero2", "WORLD_SIZES": "1 2", "SKIP_CHAOS": "1",
        "SKIP_PREFLIGHT": "1"}


def _env(**extra):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    for var in ("INJECT_FAULT", "RECOVERY_POLICY", "SUPERVISOR_CHAOS", "REGISTRY_DIR",
                "SUPERVISOR_DEVICE_COUNT", "WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT", "EXTRA_ARGS", "RUN_SUFFIX", "COMPOSITIONS", "REMAT_SWEEP",
                "SCALING_SUITE", "PROFILE", "LAYER_LOOP", "ATTENTION"):
        env.pop(var, None)
    return dict(env, **extra)


def _run(script, env, *args, timeout=600):
    return subprocess.run(["bash", script, *args], cwd=REPO, env=_env(**env),
                          capture_output=True, text=True, timeout=timeout)


def _plan(proc):
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return [ln for ln in proc.stdout.splitlines() if ln.startswith("PLAN ")]


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    results = tmp_path_factory.mktemp("suite")
    return _run(SUITE, dict(TINY, RESULTS_DIR=str(results)), timeout=900), results


def test_the_plan_is_jaxs(tmp_path):
    common = {"SUITE_DRY_RUN": "1", "TIER": "S", "SEQ_LEN": "128"}
    port = _run(SUITE, dict(common, DEVICE="cpu", WORLD_SIZES="1 2 4 8",
                            RESULTS_DIR=str(tmp_path / "t")))
    jax = _run(JAX_SUITE, dict(common, JAX_PLATFORMS="cpu", RESULTS_DIR=str(tmp_path / "j"),
                               XLA_FLAGS="--xla_force_host_platform_device_count=8"))
    assert _plan(port) == _plan(jax)
    plans = _plan(port)
    assert len(plans) == 4 * 4 + 14
    assert "device=cpu" in port.stdout and "--device" not in "\n".join(plans)


def test_the_tiny_suite_runs_through_validate_and_gate(tiny):
    proc, results = tiny
    out = proc.stdout
    assert proc.returncode == 0, out[-4000:] + proc.stderr[-2000:]
    assert "=== Suite complete: 4 passed, 0 failed" in out
    assert "VALIDATE PASS" in out
    assert "regress gate: 4 arm(s) checked, 0 regression(s)" in out
    for stage in ("arms", "analysis", "regress"):
        assert f"STAGE {stage} wall " in out, stage
    with open(results / "summary" / "metrics.csv") as f:
        rows = list(csv.DictReader(f))
    keys = [(r["strategy"], r["world_size"]) for r in rows]
    assert sorted(keys) == [("ddp", "1"), ("ddp", "2"), ("zero2", "1"), ("zero2", "2")]
    assert {r["backend"] for r in rows} == {"cpu"}
    assert len(list((results / "plots").glob("*.png"))) >= 4
    report = (results / "summary" / "BENCHMARK_REPORT.md").read_text()
    assert "## Key findings" in report
    records = list((results / "registry" / "records").glob("*/*.json"))
    assert len(records) == 4
    for path in records:
        rec = json.load(open(path))
        assert rec["result"]["backend"] == "cpu" and rec["env"]["torch_version"], rec["env"]


@pytest.mark.parametrize("how", ["k8s", "scaling"])
def test_what_waits_for_item_19_is_refused(tmp_path, how):
    env = dict(TINY, RESULTS_DIR=str(tmp_path))
    proc = (_run(SUITE, env, "--k8s") if how == "k8s"
            else _run(SUITE, dict(env, SCALING_SUITE="1")))
    assert proc.returncode != 0 and "ROADMAP item 19" in proc.stdout
    assert not list(tmp_path.glob("bench-*"))


@pytest.mark.parametrize("env", [{"LAYER_LOOP": "scan"}, {"WORLD_SIZES": ""}],
                         ids=["scan", "cpu-without-world-sizes"])
def test_refusals_before_any_arm(tmp_path, env):
    proc = _run(SUITE, dict(TINY, RESULTS_DIR=str(tmp_path), **env))
    assert proc.returncode != 0 and "ERROR:" in proc.stdout
    assert not list(tmp_path.glob("bench-*"))


def test_a_process_writes_its_kernel_launches_at_exit(tmp_path):
    """``KERNEL_LAUNCHES_DIR``: how a parent (chip_smoke.py phase 25) counts
    the launches of the suite's processes."""
    code = ("from distributed_llm_training_benchmark_framework_tpu_torch.ops import _build\n"
            "_build.launched('flash_fwd'); _build.launched('flash_fwd'); "
            "_build.launched('flash_bwd_dq')\n")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120,
                   env=_env(KERNEL_LAUNCHES_DIR=str(tmp_path)))
    (path,) = tmp_path.glob("launches_*.json")
    assert json.load(open(path)) == {"flash_fwd": 2, "flash_bwd_dq": 1}
    subprocess.run([sys.executable, "-c", "import distributed_llm_training_benchmark_framework"
                    "_tpu_torch.ops._build"], cwd=REPO, check=True, timeout=120,
                   env=_env(KERNEL_LAUNCHES_DIR=str(tmp_path / "none")))
    assert not (tmp_path / "none").exists()
