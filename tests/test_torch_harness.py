"""The port's harness CLI (``train/harness.py``) on the CPU.

- every option of JAX's ``build_parser()`` is in the port's with the same
  default, or is refused (with its reason) when set away from the port's;
  ``--profile-dir`` is live and reaches ``run_benchmark``;
- ``--device cpu`` subprocess runs: exit 0, the result marker block, and a
  result file JAX's ``analysis/validate_results.py`` accepts;
- ``sigterm@N`` -> 75 with an emergency checkpoint and a final heartbeat
  naming it, then ``--resume`` -> 0 with a resumed row that passes JAX's
  restart-coherence checks; a resume past the end -> 77;
- no card and no ``--device cpu``: a failure, not a CPU run.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from distributed_llm_training_benchmark_framework_tpu import telemetry as jtel
from distributed_llm_training_benchmark_framework_tpu.analysis import validate_results as jvalid
from distributed_llm_training_benchmark_framework_tpu.train import harness as jharness
from distributed_llm_training_benchmark_framework_tpu_torch.train import harness as tharness

REPO = Path(__file__).resolve().parents[1]
CMD = [sys.executable, "-m", "distributed_llm_training_benchmark_framework_tpu_torch.train"
       ".harness"]
SMALL = ["--world-size", "1", "--tier", "S", "--seq-len", "64", "--per-device-batch", "1",
         "--grad-accum", "2", "--warmup-steps", "2", "--attention", "flash"]
ARM = "zero2_ws1_seq64_tierS"


def _run(args, **env):
    full = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", **env)
    full.pop("INJECT_FAULT", None)
    return subprocess.run(CMD + args, capture_output=True, text=True, timeout=180, cwd=REPO,
                          env=full)


def _options(parser):
    return {a.dest: a for a in parser._actions if a.option_strings and a.dest != "help"}


def test_every_jax_option_is_live_or_refused():
    jax_opts, port_opts = _options(jharness.build_parser()), _options(tharness.build_parser())
    for dest, action in jax_opts.items():
        assert dest in port_opts, dest
        port = port_opts[dest]
        assert port.option_strings == action.option_strings, dest
        assert port.required == action.required, dest
        if port.default != action.default:
            assert dest in tharness.REFUSED, dest
        if action.choices is not None:
            assert list(port.choices) == list(action.choices), dest
    assert set(port_opts) - set(jax_opts) == {"device"}
    for dest, (default, reason) in tharness.REFUSED.items():
        assert port_opts[dest].default == default and reason, dest


REFUSALS = [(["--layer-loop", "scan"], "Queue 1 item 0"),
            (["--xla-latency-hiding"], "XLA or Pallas"),
            (["--prng-impl", "threefry"], "threefry"),
            (["--flash-block-q", "128"], "XLA or Pallas"),
            (["--flash-block-k", "128"], "XLA or Pallas"),
            (["--flash-block-k-bwd", "128"], "XLA or Pallas"),
            (["--flash-pallas-backward"], "XLA or Pallas"),
            (["--flash-blockwise-backward"], "XLA or Pallas"),
            (["--debug"], "not ported")]


@pytest.mark.parametrize("flag,reason", REFUSALS, ids=[f[0][0] for f in REFUSALS])
def test_unported_flags_are_refused_with_their_reason(tmp_path, flag, reason):
    with pytest.raises(SystemExit, match=reason) as refused:
        tharness.main(["--device", "cpu", "--strategy", "ddp", "--steps", "3",
                       "--results-dir", str(tmp_path)] + SMALL + flag)
    assert flag[0] in str(refused.value)


def test_profile_dir_is_live(tmp_path, monkeypatch):
    """``--profile-dir`` reaches ``run_benchmark`` as JAX's harness passes it
    (the trace it makes: ``tests/test_torch_profile_summary.py``)."""
    seen = {}
    monkeypatch.setattr(tharness, "run_benchmark", lambda **kw: seen.update(kw))
    assert tharness.main(["--device", "cpu", "--strategy", "ddp", "--steps", "3",
                          "--results-dir", str(tmp_path), "--profile-dir",
                          str(tmp_path / "p")] + SMALL) == 0
    assert seen["profile_dir"] == str(tmp_path / "p")
    assert "profile_dir" not in tharness.REFUSED


def test_runtime_flags_without_a_checkpoint_dir_are_refused(tmp_path):
    with pytest.raises(ValueError, match="--resume needs --checkpoint-dir"):
        tharness.main(["--device", "cpu", "--strategy", "ddp", "--steps", "3", "--resume",
                       "--results-dir", str(tmp_path)] + SMALL)
    with pytest.raises(ValueError, match="incompatible with --resume"):
        tharness.main(["--device", "cpu", "--strategy", "zero2", "--steps", "3", "--resume",
                       "--offload-opt-state", "--offload-delayed-update",
                       "--offload-dpu-start-step", "1", "--checkpoint-dir",
                       str(tmp_path / "ck"), "--results-dir", str(tmp_path)] + SMALL)
    assert not (tmp_path / "ck").exists()


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """A plain ddp run; then zero2 with checkpoints every 2 steps preempted
    by ``sigterm@4``, its ``--resume``, and a second resume past the end."""
    out = tmp_path_factory.mktemp("harness")
    # Fenced every 2 steps: the validator's step-time CV envelope holds a
    # per-step-synced row to device stability, which a shared CPU lacks.
    plain = _run(["--device", "cpu", "--strategy", "ddp", "--steps", "6", "--sync-every", "2",
                  "--results-dir", str(out / "plain")] + SMALL)
    base = ["--device", "cpu", "--strategy", "zero2", "--steps", "8", "--results-dir",
            str(out / "r"), "--checkpoint-dir", str(out / "c"), "--checkpoint-every", "2",
            "--heartbeat-sec", "0"] + SMALL
    runs = {"plain": plain, "preempted": _run(base + ["--inject-fault", "sigterm@4"])}
    runs["preempted_telemetry"] = jtel.read_events(str(out / "r" / f"telemetry_{ARM}.jsonl"))
    runs["resumed"] = _run(base + ["--resume"])
    runs["resumed_row"] = json.loads((out / "r" / f"result_{ARM}.json").read_text())
    runs["past_end"] = _run(base + ["--resume"])
    return out, runs


def test_plain_cpu_run_emits_markers_and_a_valid_row(chain):
    out, runs = chain
    proc = runs["plain"]
    assert proc.returncode == 0, proc.stderr[-2000:]
    block = proc.stdout.split("BENCHMARK_RESULT_JSON_START", 1)[1].split(
        "BENCHMARK_RESULT_JSON_END", 1)[0]
    row = json.loads(block)
    assert (row["strategy"], row["world_size"], row["sync_every"]) == ("ddp", 1, 2)
    assert row["attention_impl"] == "flash" and row["time_in_compile_sec"] > 0
    assert not row["resumed"] and row["n_anomalies"] == 0
    assert jvalid.main(["--results-dir", str(out / "plain")]) == 0
    assert (out / "plain" / "telemetry_ddp_ws1_seq64_tierS.jsonl").exists()


def test_sigterm_exits_75_with_an_emergency_checkpoint(chain):
    out, runs = chain
    proc = runs["preempted"]
    assert proc.returncode == 75, proc.stderr[-2000:]
    assert "PREEMPTED: preempted at step 4 (emergency checkpoint at step 4)" in proc.stdout
    beats = [jtel.parse_heartbeat_line(ln) for ln in proc.stdout.splitlines()]
    final = [b for b in beats if b][-1]
    assert final["reason"] == "preempted" and final["emergency_checkpoint_step"] == 4
    events = runs["preempted_telemetry"]
    assert events[-1]["event"] == "run_aborted" and events[-1]["reason"] == "preempted"
    assert [e["step"] for e in events if e["event"] == "checkpoint_saved"] == [2, 4]


def test_resume_exits_0_with_a_coherent_resumed_row(chain):
    out, runs = chain
    proc = runs["resumed"]
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "Resumed from checkpoint at step 4 (restart #1)" in proc.stdout
    row = runs["resumed_row"]
    assert (row["resumed"], row["n_restarts"], row["resume_step"]) == (True, 1, 4)
    assert row["resume_baseline_loss"] > 0 and not row["resume_geometry_changed"]
    assert jvalid.validate_result(row, "resumed") == []
    # The validator's restart coherence rejects a resumed row without its ledger.
    assert jvalid.validate_result(dict(row, n_restarts=0), "incoherent")


def test_resume_past_the_end_exits_77(chain):
    out, runs = chain
    proc = runs["past_end"]
    assert proc.returncode == 77, proc.stderr[-2000:]
    assert "NOTHING TO RESUME" in proc.stdout
    assert "BENCHMARK_RESULT_JSON_START" not in proc.stdout


def test_without_a_card_the_harness_fails(tmp_path):
    proc = _run(["--strategy", "ddp", "--steps", "3", "--results-dir", str(tmp_path)] + SMALL,
                CUDA_VISIBLE_DEVICES="")
    assert proc.returncode not in (0, 75, 76, 77)
    assert "no CUDA device" in proc.stderr
    assert "BENCHMARK_RESULT_JSON_START" not in proc.stdout
