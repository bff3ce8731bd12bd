"""The port's offline verification and regression-gate scripts
(``scripts/torch_verify_offline.sh``, ``scripts/torch_regress_gate.sh``)
against the JAX package's (``scripts/verify_offline.sh``,
``scripts/regress_gate.sh``): the verify script runs its five local checks
and passes, with tier S, A and B parameter counts equal to the JAX
package's (by ``jax.eval_shape``), and refuses ``--image`` naming ROADMAP
item 19a; the gate script runs the port's registry CLI, ``gate --all`` by
default, with the CLI's exit code and output."""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

from distributed_llm_training_benchmark_framework_tpu.models import tinygpt as jtiny

REPO = Path(__file__).resolve().parents[1]


def _run(cmd, **env):
    full = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", **env)
    return subprocess.run(cmd, capture_output=True, text=True, timeout=300, cwd=REPO, env=full)


@pytest.fixture(scope="module")
def verify():
    return _run(["bash", "scripts/torch_verify_offline.sh"])


def test_verify_offline_runs_the_five_checks(verify):
    assert verify.returncode == 0, verify.stderr[-3000:]
    out = verify.stdout
    for i, what in enumerate(("imports", "model tiers", "synthetic dataset", "bundled configs",
                              "graftcheck --memory"), start=1):
        assert f"--- [{i}/5] {what}" in out
    assert "PY CHECKS PASSED" in out and "0 finding(s)" in out + verify.stderr
    assert out.rstrip().endswith("ALL OFFLINE CHECKS (incl. GC110 memory audit) PASSED")


def test_verify_offline_tiers_have_jaxs_parameter_counts(verify):
    counts = {t: int(n) for t, n in re.findall(r"OK: tier (\w)(?: \([^)]*\))?: (\d+) params",
                                               verify.stdout)}
    assert set(counts) == {"S", "A", "B"}
    for tier, n in counts.items():
        shapes = jax.eval_shape(
            lambda k, t=tier: jtiny.init_params(jtiny.get_model_config(t, 256), k),
            jax.random.key(0))
        assert n == sum(int(np.prod(leaf.shape)) for leaf in jax.tree_util.tree_leaves(shapes))


def test_verify_offline_refuses_image_naming_item_19a():
    res = _run(["bash", "scripts/torch_verify_offline.sh", "--image", "framework:latest"])
    assert res.returncode == 2 and "item 19a" in res.stderr and res.stdout == ""


@pytest.mark.parametrize("args", [[], ["gate", "--all"], ["list"]], ids=["default", "gate",
                                                                         "list"])
def test_regress_gate_wraps_the_ports_registry_cli(tmp_path, args):
    env = {"REGRESS_REGISTRY_TORCH": str(tmp_path / "registry")}
    script = _run(["bash", "scripts/torch_regress_gate.sh", *args], **env)
    cli = _run([sys.executable, "-m", "distributed_llm_training_benchmark_framework_tpu_torch."
                "regress", *(args or ["gate", "--all"])], **env)
    assert (script.returncode, script.stdout) == (cli.returncode, cli.stdout)
    assert script.returncode in (0, 2), script.stderr[-2000:]
