"""The port's framework-neutral analysis against JAX's, on frozen inputs.

- ``analysis.telemetry_report``: ``build_timeline``, the report text, the
  CLI over a file, a directory and ``--compare`` (the ``regress.stats``
  engine), all equal to JAX's on ``tests/fixtures/telemetry_*.jsonl``;
  ``--profile-dir`` / ``--run`` (the profiler join) equal to JAX's on its
  pipeline trace fixture rendered in torch's dialect;
- ``analysis.validate_results``: every finding on a good row and on broken
  ones, the marker contract and the CLI's exit codes, equal to JAX's; the
  one named difference is the device capacity (the port's table knows the
  H100, JAX's the TPU kinds);
- ``analysis.parse_metrics`` (metrics.csv cell for cell, rows without
  ``tokens_per_dollar`` among them), ``analysis.plot`` (the same file
  names), ``analysis.scaling`` (curves, efficiencies, waterfall, stamps and
  CLI over ``tests/fixtures/registry_frozen_scaling``) and
  ``analysis.make_report`` (JAX's Markdown but for the title, the arms'
  trade-off blurbs and the remat frontier's headroom note).
"""

import json
import os
import shutil
import sys
from pathlib import Path

import pandas as pd
import pytest

from distributed_llm_training_benchmark_framework_tpu.analysis import (
    make_report as jreport,
    parse_metrics as jparse,
    plot as jplot,
    scaling as jscaling,
    telemetry_report as jtrep,
    validate_results as jvalid,
)
from distributed_llm_training_benchmark_framework_tpu.regress import store as jstore
from distributed_llm_training_benchmark_framework_tpu_torch import analysis as tanalysis
from distributed_llm_training_benchmark_framework_tpu_torch.analysis import (
    make_report as treport,
    parse_metrics as tparse,
    plot as tplot,
    scaling as tscaling,
    telemetry_report as ttrep,
    validate_results as tvalid,
)
from distributed_llm_training_benchmark_framework_tpu_torch.regress import store as tstore

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_trace_render as render  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
TRACE_FROZEN_PP = FIXTURES / "trace_frozen_pipeline"
TELEMETRY = [FIXTURES / n for n in ("telemetry_frozen.jsonl", "telemetry_compare_a.jsonl",
                                    "telemetry_compare_b_slow.jsonl")]


class _Capture:
    """stdout and stderr of one in-process CLI call."""

    def __enter__(self):
        import io

        self._saved = sys.stdout, sys.stderr
        sys.stdout, sys.stderr = self.out, self.err = io.StringIO(), io.StringIO()
        return self

    def __exit__(self, *exc):
        sys.stdout, sys.stderr = self._saved

    def texts(self):
        return self.out.getvalue(), self.err.getvalue()


def _both(fn_jax, fn_port):
    """(result, stdout, stderr) of each call, SystemExit's code as result."""
    out = []
    for fn in (fn_jax, fn_port):
        with _Capture() as cap:
            try:
                res = fn()
            except SystemExit as e:
                res = ("exit", e.code)
        out.append((res, *cap.texts()))
    return out


# ---------------------------------------------------------------------------
# telemetry_report
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("path", TELEMETRY, ids=lambda p: p.stem)
def test_timeline_and_report_equal_jax(path):
    from distributed_llm_training_benchmark_framework_tpu.telemetry import read_events as jread
    from distributed_llm_training_benchmark_framework_tpu_torch.telemetry import (
        read_events as tread,
    )

    events = tread(str(path))
    assert events == jread(str(path))
    tl = ttrep.build_timeline(events)
    assert tl == jtrep.build_timeline(events)
    assert ttrep.format_report(tl) == jtrep.format_report(tl)


@pytest.mark.parametrize("argv", [
    ["--telemetry", str(TELEMETRY[0])],
    ["--compare", str(TELEMETRY[1]), str(TELEMETRY[2])],
    ["--compare", str(TELEMETRY[1]), str(TELEMETRY[1])],
    ["--results-dir", str(FIXTURES)],
    ["--telemetry", str(FIXTURES / "no_such.jsonl")],
], ids=["file", "compare", "compare_aa", "dir", "missing"])
def test_telemetry_report_cli_equals_jax(argv, tmp_path):
    jax_side, port_side = _both(lambda: jtrep.main(argv), lambda: ttrep.main(argv))
    assert port_side == jax_side


def test_telemetry_report_plots_equal_jax(tmp_path):
    events = ttrep.read_events(str(TELEMETRY[0]))
    tl = ttrep.build_timeline(events)
    names = [[os.path.basename(p) for p in mod.write_plots(tl, str(tmp_path / tag))]
             for tag, mod in (("j", jtrep), ("t", ttrep))]
    assert names[0] == names[1] and names[1]


@pytest.mark.parametrize("run", [False, True], ids=["profile_dir", "run"])
def test_profile_join_is_live(run, tmp_path):
    """``--profile-dir`` (and ``--run``) join the telemetry against the trace
    as JAX's do: on JAX's pipeline fixture and its rendering in torch's
    dialect the reports are equal but for the trace's path."""
    torch_dir = render.render_dir(str(TRACE_FROZEN_PP), str(tmp_path / "pp"))
    base = ["--telemetry", str(TELEMETRY[0]), "--profile-dir"]
    jax_side, port_side = _both(
        lambda: jtrep.main(base + [str(TRACE_FROZEN_PP)] + (["--run", "."] if run else [])),
        lambda: ttrep.main(base + [torch_dir] + (["--run", "host_4242"] if run else [])))

    def strip(side):
        res, out, err = side
        return res, [ln for ln in out.splitlines() if not ln.startswith("  trace: ")], err

    assert strip(port_side) == strip(jax_side)
    assert port_side[0] == 0 and "== Profiler join ==" in port_side[1]
    assert "device steps traced: 3, median 0.0100s" in port_side[1]


# ---------------------------------------------------------------------------
# validate_results
# ---------------------------------------------------------------------------


def result(**kw):
    r = {"strategy": "zero2", "world_size": 1, "rank": 0, "seq_len": 2048, "tier": "A",
         "steps": 100, "warmup_steps": 5, "per_device_batch": 1, "grad_accum": 4,
         "tokens_per_sec": 40000.0, "mean_step_time_sec": 0.2, "mean_loss": 6.1,
         "peak_vram_gb": 10.0, "h2d_gbps_per_gpu": 1e-5, "sync_every": 1,
         "step_time_cv_pct": 2.0, "loss_first_window": 9.0, "loss_last_window": 6.0,
         "est_hbm_gb": 9.0, "peak_hbm_gb": 10.0, "peak_hbm_method": "allocator",
         "device_kind": "cpu", "model_family": "tinygpt", "wall_time_total_sec": 30.0,
         "time_in_compile_sec": 2.0, "time_in_timed_sec": 20.0}
    r.update(kw)
    return r


BROKEN = {
    "good": {},
    "missing_key": {"h2d_gbps_per_gpu": None},
    "zero_tps": {"tokens_per_sec": 0.0},
    "loss_high": {"mean_loss": 20.0},
    "loss_nan": {"mean_loss": float("nan")},
    "frozen_run": {"loss_last_window": 9.0},
    "cv": {"step_time_cv_pct": 30.0},
    "cv_offload": {"step_time_cv_pct": 20.0, "offload_opt_state": True},
    "resumed_no_restarts": {"resumed": True, "n_restarts": 0},
    "resume_discontinuous": {"resumed": True, "n_restarts": 1, "resume_baseline_loss": 3.0},
    "restarts_not_resumed": {"n_restarts": 2},
    "rollback_ledger": {"n_rollbacks": 2, "rollback_steps_replayed": 1},
    "replayed_no_rollback": {"rollback_steps_replayed": 3},
    "geometry_not_resumed": {"resume_geometry_changed": True},
    "supervision_one_attempt": {"supervision": {"n_attempts": 1}},
    "supervision_leg_no_geometry": {"supervision": {"n_attempts": 2, "shrink_legs": ["2->1"]},
                                    "resumed": True, "n_restarts": 1},
    "supervision_good": {"supervision": {"n_attempts": 2, "shrink_legs": ["2->1"]},
                         "resumed": True, "n_restarts": 1, "resume_geometry_changed": True},
    "memory_model": {"est_hbm_gb": 2.0},
    "overflow": {"expert_overflow_pct": 80.0},
    "phases": {"time_in_timed_sec": 40.0},
    "tier_s": {"tier": "S", "mean_loss": 5.0},
    "stream": {"data_mode": "stream", "data_stall_frac": 1.5},
    "mfu_floor_v5e": {"device_kind": "TPU v5 lite", "attention_impl": "flash", "sync_every": 10,
                      "mfu_pct": 20.0},
}


@pytest.mark.parametrize("case", sorted(BROKEN))
def test_validator_findings_equal_jax(case):
    row = result(**BROKEN[case])
    if row.get("h2d_gbps_per_gpu") is None:
        del row["h2d_gbps_per_gpu"]
    found = tvalid.validate_result(row, case)
    assert found == jvalid.validate_result(row, case)
    assert (found == []) == (case in ("good", "supervision_good", "cv_offload", "tier_s"))


def test_device_capacity_is_the_ports_table():
    row = result(device_kind="NVIDIA H100 80GB HBM3", peak_hbm_gb=90.0, est_hbm_gb=85.0)
    assert tvalid._hbm_capacity_gb("NVIDIA H100 80GB HBM3") == 80.0
    found = tvalid.validate_result(row, "h100")
    assert any("exceeds 80.0 GB NVIDIA H100 80GB HBM3 HBM" in f for f in found)
    assert found[: len(jvalid.validate_result(row, "h100"))] == jvalid.validate_result(row, "h100")
    assert tvalid._hbm_capacity_gb("cpu") is None


def test_validator_cli_and_markers_equal_jax(tmp_path):
    good, bad = tmp_path / "good", tmp_path / "bad"
    for d, row in ((good, result()), (bad, result(mean_loss=30.0))):
        (d / "logs").mkdir(parents=True)
        (d / "result_zero2_ws1_seq2048_tierA.json").write_text(json.dumps(row))
    (good / "logs" / "run.log").write_text(
        "x\nBENCHMARK_RESULT_JSON_START\n{\"a\": 1}\nBENCHMARK_RESULT_JSON_END\n")
    (bad / "logs" / "run.log").write_text("BENCHMARK_RESULT_JSON_START\n{not json\n")
    for argv in (["--results-dir", str(good), "--logs-dir", str(good / "logs")],
                 ["--results-dir", str(bad), "--logs-dir", str(bad / "logs")],
                 ["--results-dir", str(tmp_path / "empty")]):
        jax_side, port_side = _both(lambda: jvalid.main(argv), lambda: tvalid.main(argv))
        assert port_side == jax_side
    assert port_side[0] == 1


# ---------------------------------------------------------------------------
# metrics.csv, plots, make_report
# ---------------------------------------------------------------------------


def _row(strategy, ws, tps, seq=2048, **kw):
    r = {"strategy": strategy, "world_size": ws, "rank": 0, "seq_len": seq, "tier": "A",
         "steps": 100, "per_device_batch": 1, "grad_accum": 4, "tokens_per_sec": tps,
         "mean_step_time_sec": 0.5, "mean_loss": 6.1, "peak_vram_gb": 10.0 + ws,
         "h2d_gbps_per_gpu": 1e-5, "attention_impl": "flash", "mfu_pct": 30.0 + ws,
         "n_params": 236e6, "device_kind": "NVIDIA H100 80GB HBM3"}
    r.update(kw)
    return r


ROWS = {
    "a/result_zero2_ws1_seq2048_tierA.json": _row("zero2", 1, 40000.0),
    "b/result_zero2_ws2_seq2048_tierA.json": _row("zero2", 2, 76000.0),
    "c/result_zero2_ws4_seq2048_tierA.json": _row(
        "zero2", 4, 140000.0, resumed=True, n_restarts=1, resume_geometry_changed=True,
        supervision={"schema_version": 1, "n_attempts": 2, "classes": ["preempted", "ok"],
                     "actions": ["resume-shrunk"], "shrink_legs": ["8->4"], "gave_up": False}),
    "d/result_ddp_ws1_seq2048_tierA.json": _row("ddp", 1, 42000.0, n_rollbacks=1,
                                                rollback_steps_replayed=2),
    "e/result_ddp_ws2_seq4096_tierA.json": _row("ddp", 2, 60000.0, seq=4096,
                                                tensor_parallel=2),
    "f/result_fsdp_ws1_seq2048_tierA.json": _row("fsdp", 1, 39000.0, attention_impl="reference",
                                                 tokens_per_dollar=2.5e7,
                                                 usd_per_chip_hour=1.2),
    "g/result.json": _row("zero3", 2, 50000.0, pipeline_parallel=2,
                          pipeline_schedule="interleaved", virtual_stages=2),
}
PARTIAL = {"strategy": "fsdp", "world_size": 2, "rank": 0, "seq_len": 2048, "tier": "A",
           "per_device_batch": 1, "grad_accum": 4, "tokens_per_sec": 30000.0,
           "total_steps": 100, "step": 40, "window_mean_step_time_sec": 0.6, "loss": 6.5,
           "reason": "preempted"}
GAVE_UP = {"schema_version": 1, "n_attempts": 3, "final_class": "hung", "gave_up": True}


@pytest.fixture(scope="module")
def results_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("results")
    for name, row in ROWS.items():
        (d / name).parent.mkdir(parents=True, exist_ok=True)
        (d / name).write_text(json.dumps(row))
    (d / "partial_fsdp_ws2_seq2048_tierA.json").write_text(json.dumps(PARTIAL))
    (d / "h").mkdir()
    (d / "h" / "supervision.json").write_text(json.dumps(GAVE_UP))
    return d


@pytest.fixture(scope="module")
def csvs(results_dir, tmp_path_factory):
    out = tmp_path_factory.mktemp("csv")
    texts = {}
    for tag, mod in (("jax", jparse), ("port", tparse)):
        with _Capture() as cap:
            code = mod.main(["--results-dir", str(results_dir), "--out", str(out / tag)])
        stdout, stderr = (t.replace(str(out / tag), "OUT") for t in cap.texts())
        texts[tag] = (code, stdout, stderr, (out / tag / "metrics.csv").read_text())
    return out, texts


def test_metrics_csv_equals_jax_cell_for_cell(csvs):
    out, texts = csvs
    assert texts["port"] == texts["jax"] and texts["port"][0] == 0
    assert "supervisor gave up after 3 attempt(s)" in texts["port"][1]
    df = pd.read_csv(out / "port" / "metrics.csv")
    sup = df[df["supervised_attempts"] == 2]
    assert list(sup["supervised_actions"]) == ["resume-shrunk"]
    assert list(sup["supervised_shrink_legs"]) == ["8->4"]
    assert df["tokens_per_dollar"].isna().sum() == len(df) - 1
    assert list(df.columns)[-1] == "scaling_efficiency_pct"


def test_plots_have_jax_file_names(csvs):
    out, _ = csvs
    df = pd.read_csv(out / "port" / "metrics.csv")
    names = [sorted(os.path.basename(p) for p in mod.make_plots(df, str(out / f"plots_{tag}")))
             for tag, mod in (("jax", jplot), ("port", tplot))]
    assert names[0] == names[1] and "mfu_by_strategy.png" in names[1]


def test_attribution_classes_are_jaxs():
    from distributed_llm_training_benchmark_framework_tpu.analysis import memory_anatomy

    assert tanalysis.ATTRIBUTION_CLASSES == memory_anatomy.ATTRIBUTION_CLASSES


def port_line(line):
    """JAX's report line as the port writes it: the title, the arms'
    trade-off blurbs and the remat frontier's headroom note (with the
    port's window note) are the only lines that differ (``make_report``)."""
    if line == "# TPU Distributed Training Benchmark Report":
        return treport.TITLE
    for arm, (_, blurb) in jreport.TRADEOFFS.items():
        if line == blurb:
            return treport.TRADEOFFS[arm][1]
    return line.replace("(blank off-TPU).",
                        "(blank off the card). " + treport.FRONTIER_WINDOW_NOTE)


def _registry(tmp_path, store_mod, dirs):
    reg = store_mod.Registry(str(tmp_path / "reg"))
    for name in dirs:
        for p in sorted((FIXTURES / name).glob("record_*.json")):
            reg.ingest(json.loads(p.read_text()))
    return reg.root


@pytest.mark.parametrize("with_registry", [False, True])
def test_markdown_report_equals_jax_but_named_lines(csvs, tmp_path, with_registry):
    out, _ = csvs
    df = pd.read_csv(out / "port" / "metrics.csv")
    reports = []
    for tag, mod, store_mod in (("jax", jreport, jstore), ("port", treport, tstore)):
        root = ""
        if with_registry:
            root = _registry(tmp_path / tag, store_mod,
                             ("registry_frozen_scaling", "registry_frozen_remat"))
        text = mod.build_report(df, plots_dir="../plots", registry_root=root)
        reports.append(text.replace(root, "REG") if root else text)
    jmd, tmd = reports[0].splitlines(), reports[1].splitlines()
    assert tmd == [port_line(x) for x in jmd]
    differ = [x for x in jmd if port_line(x) != x]
    assert differ[0].startswith("# TPU")
    assert len(differ) == 1 + len(set(df["strategy"])) + with_registry
    assert "Best cost efficiency:** fsdp" in reports[1]
    assert ("## Scaling curves" in reports[1]) == with_registry
    assert ("blank off the card" in reports[1]) == with_registry


def test_report_cli_equals_jax(csvs, tmp_path):
    out, _ = csvs
    for tag, mod in (("jax", jreport), ("port", treport)):
        with _Capture():
            assert mod.main(["--csv", str(out / "port" / "metrics.csv"),
                             "--out", str(tmp_path / tag)]) == 0
    texts = [(tmp_path / tag / "BENCHMARK_REPORT.md").read_text().splitlines()
             for tag in ("jax", "port")]
    assert texts[1] == [port_line(x) for x in texts[0]]


# ---------------------------------------------------------------------------
# scaling
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def scaling_registries(tmp_path_factory):
    base = tmp_path_factory.mktemp("scaling")
    return {tag: _registry(base / tag, store_mod, ("registry_frozen_scaling",))
            for tag, store_mod in (("jax", jstore), ("port", tstore))}


def test_scaling_curves_equal_jax(scaling_registries):
    jc, jn = jscaling.build_curves(jstore.Registry(scaling_registries["jax"]))
    tc, tn = tscaling.build_curves(tstore.Registry(scaling_registries["port"]))
    assert tscaling.curves_to_json(tc, tn) == jscaling.curves_to_json(jc, jn)
    assert tscaling.format_report(tc, tn, "REG") == jscaling.format_report(jc, jn, "REG")
    effs = [p.efficiency_pct for c in tc for p in c.points if p.efficiency_pct is not None]
    assert len(effs) >= 3 and max(effs) == pytest.approx(100.0)
    roots = scaling_registries
    assert [x.replace(roots["port"], "REG") for x in tscaling.scaling_section(roots["port"])] == \
        [x.replace(roots["jax"], "REG") for x in jscaling.scaling_section(roots["jax"])]


def test_scaling_curves_keep_devices_apart(tmp_path):
    """One configuration at world 1 and 2: a curve on one device, none
    across a CPU point and an H100 point."""
    row = {"strategy": "ddp", "tier": "S", "seq_len": 64, "per_device_batch": 1,
           "grad_accum": 2, "steps": 8, "warmup_steps": 1, "attention_impl": "reference",
           "model_family": "tinygpt"}
    curves = {}
    for tag, kinds in (("same", ("cuda", "cuda")), ("mixed", ("cpu", "cuda"))):
        reg = tstore.Registry(str(tmp_path / tag))
        for ws, backend in zip((1, 2), kinds):
            reg.ingest(tstore.make_record(arm=f"ddp_ws{ws}", result_row=dict(
                row, world_size=ws, tokens_per_sec=1000.0 * ws, backend=backend,
                device_kind=backend)))
        curves[tag] = tscaling.build_curves(reg)[0]
    assert [len(c.points) for c in curves["same"]] == [2]
    assert curves["mixed"] == []


def test_scaling_cli_equals_jax(scaling_registries, tmp_path):
    sides = []
    for tag, mod in (("jax", jscaling), ("port", tscaling)):
        root, out = scaling_registries[tag], tmp_path / tag
        with _Capture() as cap:
            code = mod.main(["--registry", root, "--out", str(out), "--png", "--json"])
        text = cap.texts()[0].replace(root, "REG").replace(str(out), "OUT")
        sides.append((code, text, json.loads((out / "scaling_curves.json").read_text()),
                      (out / "scaling_curves.png").exists()))
    assert sides[0] == sides[1] and sides[1][0] == 0


def test_scaling_stamps_equal_jax(results_dir, tmp_path):
    stamped = []
    for tag, mod in (("jax", jscaling), ("port", tscaling)):
        d = tmp_path / tag
        shutil.copytree(results_dir, d)
        pairs = mod.stamp_results_dir(str(d))
        stamped.append(sorted((os.path.relpath(p, d), v) for p, v in pairs))
    assert stamped[0] == stamped[1] and stamped[1]
