"""The port's flight recorder against the JAX package's, on the CPU.

Both recorders are driven through one call sequence (phases, windows, a NaN
loss, a step-time spike that opens and resolves, a note, a resume, an
emergency heartbeat, abort) and must write the same events with the same
keys (timestamps aside) and print the same heartbeat keys; a port run's
telemetry file is read by JAX's ``telemetry_report`` and its heartbeats by
JAX's ``parse_heartbeat_line``; its events hold every key JAX's own tests
pin (``tests/test_telemetry.py``).
"""

import json
import os

import pytest
import torch

from distributed_llm_training_benchmark_framework_tpu import telemetry as jtel
from distributed_llm_training_benchmark_framework_tpu.analysis import telemetry_report as jreport
from distributed_llm_training_benchmark_framework_tpu.analysis import validate_results as jvalid
from distributed_llm_training_benchmark_framework_tpu_torch import telemetry as ttel
from distributed_llm_training_benchmark_framework_tpu_torch.train import run_benchmark
from torch_threads import one_thread  # noqa: F401  (autouse)

META = {"strategy": "zero2", "world_size": 1, "seq_len": 64, "tier": "S"}
# Window step times: three to set the median, a 4x spike, then back to normal.
WINDOWS = [(1, [5.0], 0.10), (2, [4.9], 0.10), (3, [4.8], 0.10), (4, [4.7], 0.40),
           (5, [4.6], 0.10), (6, [float("nan")], 0.10)]


def _drive(mod, results_dir, rank=0):
    rec = mod.TelemetryRecorder("zero2_ws1_seq64_tierS", results_dir=str(results_dir),
                                heartbeat_every_sec=0.0, tokens_per_step=128, total_steps=8,
                                rank=rank, is_main=rank == 0, meta=META)
    rec.begin_phase("init")
    rec.begin_phase("compile")
    rec.note("fault_injected", fault="sigterm@6", detail="drill")
    for step, losses, dt in WINDOWS:
        rec.step_window(last_step=step, losses=losses, window_mean_step_time_sec=dt)
        if step == 1:
            rec.begin_phase("timed")
    rec.note_resume(step=0, n_restarts=1, baseline_loss=5.5, geometry_changed=True,
                    source_geometry={"mesh_axes": {"data": 2}, "world_size": 2})
    rec.begin_phase("checkpoint")
    rec.emergency_heartbeat(reason="preempted", extra={"emergency_checkpoint_step": 6})
    n = rec.n_anomalies
    rec.abort("preempted")
    return rec, n


def _shape(events):
    return [(e["event"], sorted(k for k in e)) for e in events]


@pytest.mark.parametrize("rank", [0, 1])
def test_recorders_write_the_same_events_and_keys(tmp_path, capsys, rank):
    jrec, jn = _drive(jtel, tmp_path / "jax", rank)
    jout = capsys.readouterr().out
    trec, tn = _drive(ttel, tmp_path / "port", rank)
    tout = capsys.readouterr().out
    assert os.path.basename(jrec.path) == os.path.basename(trec.path)
    jev, tev = jtel.read_events(jrec.path), ttel.read_events(trec.path)
    assert _shape(jev) == _shape(tev)
    assert jn == tn == 2  # the spike and the NaN loss; a resolve is not one
    kinds = [e["event"] for e in tev]
    for kind in ("anomaly", "anomaly_resolved", "resume", "run_aborted", "fault_injected"):
        assert kind in kinds, kind
    for j, t in zip(jev, tev):
        assert {k: v for k, v in j.items() if k not in ("ts", "rel", "dur_sec", "phase_times",
                                                        "wall_time_total_sec")} == \
               {k: v for k, v in t.items() if k not in ("ts", "rel", "dur_sec", "phase_times",
                                                        "wall_time_total_sec")}
    jbeats = [jtel.parse_heartbeat_line(ln) for ln in jout.splitlines()]
    tbeats = [jtel.parse_heartbeat_line(ln) for ln in tout.splitlines()]
    jbeats, tbeats = [b for b in jbeats if b], [b for b in tbeats if b]
    assert len(jbeats) == len(tbeats) == (0 if rank else len(WINDOWS) + 1)
    assert [sorted(b) for b in jbeats] == [sorted(b) for b in tbeats]


def test_constants_and_helpers_match_jax(tmp_path):
    assert ttel.HEARTBEAT_MARKER == jtel.HEARTBEAT_MARKER == "BENCHMARK_HEARTBEAT"
    assert ttel.PHASES == jtel.PHASES and ttel.SCHEMA_VERSION == jtel.SCHEMA_VERSION
    for rank in (0, 3):
        assert ttel.telemetry_filename("a", rank) == jtel.telemetry_filename("a", rank)
    assert ttel.is_rank_sibling("telemetry_a.rank2.jsonl")
    path = tmp_path / "t.jsonl"
    path.write_text('{"event": "run_meta", "ts": 1, "rel": 0}\n{"event": "step_window", "st')
    assert [e["event"] for e in ttel.read_events(str(path))] == ["run_meta"]
    line = 'BENCHMARK_HEARTBEAT {"step": 3}'
    assert ttel.parse_heartbeat_line(line) == jtel.parse_heartbeat_line(line) == {"step": 3}
    with pytest.raises(ValueError):
        ttel.TelemetryRecorder("a", results_dir=None).begin_phase("compiling")


@pytest.fixture(scope="module")
def port_run(tmp_path_factory):
    """A tier-S run of the port with telemetry, heartbeats every window and a
    checkpoint: its result, results directory and stdout."""
    import contextlib
    import io

    out = tmp_path_factory.mktemp("run")
    buf = io.StringIO()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    with contextlib.redirect_stdout(buf):
        result = run_benchmark(tier="S", seq_len=64, steps=5, warmup_steps=1, device="cpu",
                               sync_every=2, results_dir=str(out / "res"), heartbeat_sec=0.0,
                               checkpoint_dir=str(out / "ck"), checkpoint_every=2)
    torch.set_num_threads(threads)
    return result, out / "res", buf.getvalue()


def test_jax_report_reads_a_port_run(port_run):
    result, res, stdout = port_run
    path = res / "telemetry_zero2_ws1_seq64_tierS.jsonl"
    events = jtel.read_events(str(path))
    tl = jreport.build_timeline(events)
    assert tl["end"]["event"] == "run_end"
    assert [w["step"] for w in tl["windows"]] == [0, 2, 4]
    for phase in ("init", "compile", "timed", "checkpoint", "finalize"):
        assert tl["phase_times"][phase] > 0, phase
    assert result.time_in_compile_sec == pytest.approx(tl["phase_times"]["compile"], abs=1e-3)
    assert result.time_in_checkpoint_sec > 0 and result.n_anomalies == 0
    assert "completed (ok), last step 4" in jreport.format_report(tl)
    beats = [jtel.parse_heartbeat_line(ln) for ln in stdout.splitlines()]
    beats = [b for b in beats if b]
    assert [b["step"] for b in beats] == [0, 2, 4]
    assert {"arm", "step", "total_steps", "loss", "tokens_per_sec", "phase",
            "strategy"} <= set(beats[-1])
    saved = [e for e in events if e["event"] == "checkpoint_saved"]
    assert [e["step"] for e in saved] == [2, 4]
    assert all(e["bytes"] > 0 and e["digest_ms"] >= 0 for e in saved)
    row = json.loads((res / "result_zero2_ws1_seq64_tierS.json").read_text())
    assert jvalid.validate_result(row, "port") == []
    assert jvalid.validate_telemetry(str(res / "result_zero2_ws1_seq64_tierS.json"), row,
                                     "port") == []


def test_port_events_hold_every_key_jax_pins(port_run):
    """The keys ``tests/test_telemetry.py`` pins on JAX's frozen fixture."""
    _, res, _ = port_run
    by_kind = {}
    for e in ttel.read_events(str(res / "telemetry_zero2_ws1_seq64_tierS.jsonl")):
        by_kind.setdefault(e["event"], e)
    assert {"arm", "schema_version", "tokens_per_step", "total_steps"} <= set(by_kind["run_meta"])
    assert {"phase", "ts", "rel"} <= set(by_kind["phase_begin"])
    assert {"phase", "dur_sec"} <= set(by_kind["phase_end"])
    assert {"step", "steps_in_window", "loss", "window_mean_step_time_sec", "cum_tokens",
            "tokens_per_sec", "peak_hbm_bytes", "phase"} <= set(by_kind["step_window"])
    assert {"status", "last_step", "phase_times", "wall_time_total_sec", "n_anomalies",
            "n_unresolved_anomalies"} <= set(by_kind["run_end"])
