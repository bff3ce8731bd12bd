"""The port's chaos suite (``scripts/torch_chaos_suite.sh``) and its retry
shim (``scripts/torch_with_retries.sh``), held against the JAX side's
``scripts/chaos_suite.sh``:

- the port's scripts parse under ``bash -n`` and are executable;
- ``--smoke`` on the CPU exits 0 with one ``CHAOS OK`` per fault (sigkill,
  torn-checkpoint, bitflip, data-corrupt-record);
- the smoke's outcome lines are those JAX's script prints (the other
  classified faults: ``tests/test_torch_chaos_classify.py``);
- the full matrix names every kind of ``faults.injection.FAULT_KINDS`` and
  is JAX's matrix arm for arm, but ``k8s-coordinator``, whose flag is
  refused naming ROADMAP item 19;
- a negative control: with every ``--resume`` made to fail (a
  ``PYTHON_BIN`` stub), the suite exits non-zero with ``CHAOS FAIL
  sigkill``.

The ``--elastic`` and ``--supervisor`` arms (multi-rank gloo runs) are not
run here: they do not fit this file's time; the full matrix runs them.
"""

import json
import os
import re
import subprocess

import pytest

from distributed_llm_training_benchmark_framework_tpu_torch.faults import injection
from torch_chaos import CHAOS, REPO, jax_ok_lines, ok_lines, run_chaos

SCRIPTS = os.path.join(REPO, "scripts")
SMOKE = ["sigkill", "torn-checkpoint", "bitflip", "data-corrupt-record"]


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    root = tmp_path_factory.mktemp("smoke")
    return run_chaos(["--smoke", "--jobs", "4"], root), root


@pytest.mark.parametrize("name", ["torch_chaos_suite.sh", "torch_with_retries.sh",
                                  "torch_run_all_benchmarks.sh"])
def test_scripts_parse_and_are_executable(name):
    path = os.path.join(SCRIPTS, name)
    assert subprocess.run(["bash", "-n", path]).returncode == 0, name
    assert os.access(path, os.X_OK), name


def test_the_retry_shim_execs_the_ports_supervisor():
    text = open(os.path.join(SCRIPTS, "torch_with_retries.sh")).read()
    assert "distributed_llm_training_benchmark_framework_tpu_torch.runtime.supervisor" in text
    assert "exec " in text and "PYTHON_BIN" in text
    for var in ("MAX_ARM_RETRIES", "RETRY_BACKOFF_SEC", "RECOVERY_POLICY"):
        assert var in text, var
    # It names nothing of the JAX package.
    assert "distributed_llm_training_benchmark_framework_tpu." not in text


def test_smoke_passes_on_the_cpu(smoke):
    proc, root = smoke
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert sorted(ok_lines(proc.stdout)) == sorted(SMOKE)
    assert "=== chaos suite: 4 ok, 0 failed ===" in proc.stdout
    row = json.load(open(root / "sigkill" / "results" / "result_ddp_ws1_seq32_tierS.json"))
    assert (row["backend"], row["resumed"]) == ("cpu", True)


def test_the_smoke_outcomes_are_jaxs(smoke):
    jax = jax_ok_lines()
    assert ok_lines(smoke[0].stdout) == {f: jax[f] for f in SMOKE}


def _matrix(text):
    """The default fault list and the ones the flags add."""
    faults = set(re.search(r'^FAULTS="([^"]*)"', text, re.M).group(1).split())
    for added in re.findall(r'FAULTS="\$FAULTS ([^"]*)"', text):
        faults |= set(added.split())
    return faults


def test_the_full_matrix_names_every_fault_kind_and_is_jaxs():
    text = open(CHAOS).read()
    matrix = _matrix(text)
    for kind in injection.FAULT_KINDS:
        assert kind in matrix, kind
    for fault in matrix:
        assert re.search(rf"^    (\S+\|)?{re.escape(fault)}(\|\S+)?\)$", text, re.M), fault
    jax = _matrix(open(os.path.join(SCRIPTS, "chaos_suite.sh")).read())
    assert jax - matrix == {"k8s-coordinator"} and matrix <= jax


def test_k8s_chaos_is_refused_naming_item_19(tmp_path):
    proc = run_chaos(["--k8s-chaos"], tmp_path, timeout=60)
    assert proc.returncode == 2 and "ROADMAP item 19" in proc.stderr


def test_recovery_made_impossible_fails_the_suite(tmp_path):
    """Negative control: a PYTHON_BIN whose every --resume exits 1."""
    stub = tmp_path / "python_no_resume"
    stub.write_text('#!/usr/bin/env bash\nfor a in "$@"; do [ "$a" = --resume ] && exit 1; done\n'
                    'exec python "$@"\n')
    stub.chmod(0o755)
    proc = run_chaos(["--faults", "sigkill"], tmp_path / "r", PYTHON_BIN=str(stub))
    assert proc.returncode != 0
    assert "CHAOS FAIL sigkill: resume attempt did not complete" in proc.stderr
    assert "=== chaos suite: 0 ok, 1 failed ===" in proc.stdout
