"""Faults the port's chaos suite (``scripts/torch_chaos_suite.sh``) must
classify as the JAX side's ``scripts/chaos_suite.sh`` does, run on the CPU
in one suite run: ``nan-loss`` (the validator rejects the completed row),
``hang`` (a 2 s in-process watchdog, exit 76, the stack dump and the
salvaged ``reason=hang`` partial, then a validated resume), ``data-stall``
(exit 78, the salvaged ``reason=data_stall`` partial, the resume at the
exact cursor) and ``data-missing-shard`` (refused, naming the shard): the
same outcome line per fault as JAX's script prints, and the artifacts
behind it.
"""

import json

import pytest

from torch_chaos import jax_ok_lines, ok_lines, run_chaos

CLASSIFIED = ["nan-loss", "hang", "data-stall", "data-missing-shard"]


@pytest.fixture(scope="module")
def classified(tmp_path_factory):
    root = tmp_path_factory.mktemp("classified")
    return run_chaos(["--faults", " ".join(CLASSIFIED), "--jobs", "4"], root,
                     CHAOS_WATCHDOG_SEC="2"), root


def test_faults_classify_as_in_jax(classified):
    proc, root = classified
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    jax = jax_ok_lines()
    assert ok_lines(proc.stdout) == {f: jax[f] for f in CLASSIFIED}
    assert "unresolved anomaly" in (root / "nan-loss" / "validate.log").read_text()
    hang = (root / "hang" / "phase1.log").read_text()
    assert "HANG WATCHDOG" in hang
    (partial,) = (root / "hang" / "salvage").glob("partial_*.json")
    assert json.load(open(partial))["reason"] == "hang"
    (partial,) = (root / "data-stall" / "salvage").glob("partial_*.json")
    assert json.load(open(partial))["reason"] == "data_stall"
    row = json.load(open(root / "data-stall" / "results" / "result_ddp_ws1_seq32_tierS.json"))
    assert row["stream_cursor_start"] == row["resume_step"] + 1
    assert "missing shard 2" in (root / "data-missing-shard" / "phase1.log").read_text()
