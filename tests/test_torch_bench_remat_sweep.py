"""The port's bench ``--remat-sweep`` (``bench.py``: ``REMAT_SWEEP_POLICIES``,
``measure_row(remat=...)``, ``registry_rows``), held against the JAX
bench's (the repo-root ``bench.py``):

- one tiny sweep on the CPU (tier S, S 32, 3 steps): the ``remat_sweep``
  sub-object holds the four policies' rows in JAX's order, each with its
  requested and resolved policy (``auto`` resolves to ``none`` on the CPU,
  whose memory the model does not know) and no headroom off the card;
- a sweep row's keys are those of JAX's sweep row on the same tiny config
  (JAX's ``_measure_row`` in this process), but for ``tokens_per_dollar``
  (the port has no H100 price yet, ROADMAP item 0) and the four keys every
  port bench row adds (``device_kind``, ``mean_step_time_sec``,
  ``loss_first_window``, ``loss_last_window``);
- one registry record per policy, each its own lineage, beside the top
  row's, from ``--regress on``;
- the port's ``make_report`` renders the frontier from those records, row
  for row as JAX's ``make_report`` renders it from the same registry;
- ``registry_rows`` fans the sub-object out as JAX's does.
"""

import contextlib
import io
import json
import os

import pandas as pd
import pytest

from distributed_llm_training_benchmark_framework_tpu.analysis import make_report as jreport
from distributed_llm_training_benchmark_framework_tpu_torch import bench as tbench
from distributed_llm_training_benchmark_framework_tpu_torch.analysis import (
    make_report as treport,
)
from distributed_llm_training_benchmark_framework_tpu_torch.regress import store as tstore
from torch_threads import one_thread  # noqa: F401  (autouse, module scope)

TINY = ["--tier", "S", "--seq-len", "32", "--steps", "3", "--warmup-steps", "1",
        "--sync-every", "1", "--flagship", "off", "--skip-preflight"]
PORT_ONLY = {"device_kind", "mean_step_time_sec", "loss_first_window", "loss_last_window"}
SWEEP_ARM = "bench_llama_tierS_seq32"


@pytest.fixture(scope="module")
def sweep(tmp_path_factory):
    reg = str(tmp_path_factory.mktemp("registry"))
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        tbench.main(["--device", "cpu", *TINY, "--remat-sweep", "--regress", "on",
                     "--registry", reg])
    (line,) = out.getvalue().splitlines()
    return json.loads(line), reg


@pytest.fixture(scope="module")
def jax_row():
    import bench as jbench

    args = jbench.build_parser().parse_args([*TINY, "--remat-sweep"])
    with contextlib.redirect_stdout(io.StringIO()):
        return jbench._measure_row(
            args, 1, model_family="llama", per_device_batch=2, grad_accum=2,
            layer_loop="unrolled", attention_impl="flash", dropout=None,
            use_checkpoint=False, remat="dots")


def test_the_sweep_has_one_row_per_policy(sweep):
    payload, _ = sweep
    rows = payload["remat_sweep"]
    assert list(rows) == list(tbench.REMAT_SWEEP_POLICIES) == ["none", "dots", "full", "auto"]
    for pol, row in rows.items():
        assert row["remat_policy"] == pol and row["value"] > 0
        assert row["remat_policy_resolved"] == ("none" if pol == "auto" else pol)
        assert row["hbm_headroom_gb"] is None and row["metric"].startswith("llama_tierS_seq32")
    assert "remat_policy" not in payload


def test_a_sweep_row_has_jaxs_keys(sweep, jax_row):
    port = set(sweep[0]["remat_sweep"]["dots"])
    assert port == (set(jax_row) - {"tokens_per_dollar"}) | PORT_ONLY
    assert jax_row["remat_policy_resolved"] == "dots"


def test_one_registry_record_per_policy_in_its_own_lineage(sweep):
    _, reg = sweep
    registry = tstore.Registry(reg)
    recs = registry.records(SWEEP_ARM)
    assert sorted(r["result"]["remat_policy"] for r in recs) == sorted(
        tbench.REMAT_SWEEP_POLICIES)
    assert sorted(r["source"] for r in recs) == sorted(
        f"bench.py:remat-sweep:{p}" for p in tbench.REMAT_SWEEP_POLICIES)
    assert len({tstore.config_key(r) for r in recs}) == 4
    for rec in recs:
        assert rec["result"]["backend"] == "cpu"
        assert registry.baseline(SWEEP_ARM, exclude_record_id=rec["record_id"],
                                 match_config_of=rec) is None
    (top,) = registry.records("bench_tinygpt_tierS_seq32")
    assert not top["result"].get("remat_policy")


def _frontier(md):
    return md.split("## Remat/HBM frontier")[1].split("\n## ")[0]


def test_make_report_renders_the_frontier_as_jaxs(sweep):
    _, reg = sweep
    row = {"strategy": "zero2", "world_size": 1, "seq_len": 32, "tier": "S",
           "tokens_per_sec": 1000.0, "mean_step_time_sec": 0.1, "peak_vram_gb": 0.0,
           "scaling_efficiency_pct": 100.0}
    md = treport.build_report(pd.DataFrame([row]), registry_root=reg)
    section = _frontier(md)
    lines = [ln for ln in section.splitlines() if ln.startswith("| ") and "policy" not in ln]
    assert [ln.split("|")[1].strip() for ln in lines] == ["none", "dots", "full", "auto"]
    assert f"### {SWEEP_ARM}" in section
    assert lines == [ln for ln in _frontier(jreport.build_report(
        pd.DataFrame([row]), registry_root=reg)).splitlines()
        if ln.startswith("| ") and "policy" not in ln]


def test_registry_rows_fan_out_one_row_per_policy():
    args = tbench.build_parser().parse_args(["--remat-sweep"])
    payload = {"metric": "tinygpt_tierA_seq2048_tokens_per_sec_per_chip", "value": 1.0,
               "remat_sweep": {p: {"value": 2.0, "remat_policy": p}
                               for p in tbench.REMAT_SWEEP_POLICIES}}
    rows = tbench.registry_rows(args, payload, backend="cuda")
    assert [src for src, _, _ in rows] == ["bench.py"] + [
        f"bench.py:remat-sweep:{p}" for p in sorted(tbench.REMAT_SWEEP_POLICIES)]
    assert "remat_sweep" not in rows[0][1]
    for _, _, extra in rows[1:]:
        assert (extra["model_family"], extra["per_device_batch"], extra["grad_accum"]) == (
            "llama", 2, 2)
