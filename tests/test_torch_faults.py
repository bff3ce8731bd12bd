"""The port's chaos harness against the JAX package's, on the CPU.

- the ``--inject-fault`` grammar: every spec of JAX's
  ``tests/test_fault_tolerance.py`` (and the ranked and data kinds), good
  and bad, gives equal ``FaultSpec`` fields or the same refusal from both
  parsers;
- the injectors fire at the same boundary (signals patched out);
- the SIGTERM guard's install / uninstall, the hang watchdog firing at a
  1 s timeout with the same ``hang_dump`` trail as JAX's, and a watchdog
  abort of a real harness run (exit 76);
- ``enospc-on-save`` and ``nan-loss`` through ``run_benchmark``, and every
  kind armed (the sentinel's and the stream's are tested in
  ``tests/test_torch_sentinel.py`` and ``tests/test_torch_stream.py``);
- two harness ranks over gloo: ``sigterm-rank`` stops both at one step with
  one emergency checkpoint (the store's flag and agreement), and
  ``stall-rank`` aborts both with 76 (the store's hang flag).
"""

import dataclasses
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from distributed_llm_training_benchmark_framework_tpu import faults as jfaults
from distributed_llm_training_benchmark_framework_tpu import telemetry as jtel
from distributed_llm_training_benchmark_framework_tpu.analysis import validate_results as jvalid
from distributed_llm_training_benchmark_framework_tpu.faults import injection as jinj
from distributed_llm_training_benchmark_framework_tpu.faults import watchdog as jwatch
from distributed_llm_training_benchmark_framework_tpu_torch import faults as tfaults
from distributed_llm_training_benchmark_framework_tpu_torch import telemetry as ttel
from distributed_llm_training_benchmark_framework_tpu_torch.faults import injection as tinj
from distributed_llm_training_benchmark_framework_tpu_torch.faults import watchdog as twatch
from distributed_llm_training_benchmark_framework_tpu_torch.train import run_benchmark
from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
HARNESS = [sys.executable, "-m", "distributed_llm_training_benchmark_framework_tpu_torch"
           ".train.harness", "--device", "cpu", "--strategy", "zero2", "--world-size", "1",
           "--tier", "S", "--seq-len", "64", "--per-device-batch", "1", "--grad-accum", "2"]

GOOD = ["sigkill@10", "hang@6:45", "torn-checkpoint", "enospc-on-save", None, "", "sigterm@3",
        " sigterm@3 ", "sigterm-rank@3:1", "stall-rank@4:1", "stall-rank@4:1:2.5", "nan-loss@0",
        "bitflip@2", "grad-explode@2", "opt-moments@5", "data-stall@3", "data-stall@3:7",
        "data-corrupt-record@11", "data-slow-reader@5:20", "data-missing-shard@1"]
BAD = ["sigkill", "sigterm@", "nan-loss@x", "sigkill@-1", "torn-checkpoint@5", "sigkill@5:10",
       "hang@5:0", "meteor-strike@3", "sigterm-rank@3", "sigterm-rank@3:x",
       "sigterm-rank@3:1:5", "stall-rank@3:-1", "stall-rank@3:1:0", "data-slow-reader@3",
       "data-slow-reader@3:-2", "hang@2:soon"]


@pytest.mark.parametrize("spec", GOOD + BAD)
def test_both_parsers_agree(spec):
    try:
        want = jfaults.parse_fault_spec(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            tfaults.parse_fault_spec(spec)
        assert str(got.value) == str(e)
        assert spec in BAD
        return
    assert spec in GOOD
    got = tfaults.parse_fault_spec(spec)
    if want is None:
        assert got is None
        return
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert str(got) == str(want)


def test_registry_matches_jax():
    assert set(tfaults.FAULT_KINDS) == set(jfaults.FAULT_KINDS)
    assert tinj.STEPPED_KINDS == jinj.STEPPED_KINDS and tinj.RANKED_KINDS == jinj.RANKED_KINDS
    assert tfaults.DATA_KINDS == jfaults.DATA_KINDS
    assert tfaults.ARMED_KINDS | set(tfaults.WAITS_FOR) == set(tfaults.FAULT_KINDS)
    assert not tfaults.ARMED_KINDS & set(tfaults.WAITS_FOR)
    assert (tfaults.EXIT_PREEMPTED, tfaults.EXIT_HUNG, tfaults.EXIT_NOTHING_TO_RESUME,
            tfaults.EXIT_DATA_STALL) == (jfaults.EXIT_PREEMPTED, jfaults.EXIT_HUNG,
                                         jfaults.EXIT_NOTHING_TO_RESUME,
                                         jfaults.EXIT_DATA_STALL) == (75, 76, 77, 78)


@pytest.mark.parametrize("spec,rank", [("sigterm@8", 0), ("sigkill@0", 0),
                                       ("sigterm-rank@5:1", 1), ("sigterm-rank@5:1", 0),
                                       ("hang@4:0.01", 0), ("stall-rank@4:2:0.01", 2),
                                       ("stall-rank@4:2:0.01", 0)])
def test_injectors_fire_at_the_same_boundary(monkeypatch, spec, rank):
    def drive(pkg, mod):
        fired = []
        now = [None]
        monkeypatch.setattr(mod.os, "kill", lambda pid, sig: fired.append((now[0], sig)))
        monkeypatch.setattr(mod.time, "sleep", lambda s: fired.append((now[0], s)))
        inj = pkg.FaultInjector(pkg.parse_fault_spec(spec), is_main=False, rank=rank)
        for b in (1, 3, 5, 7, 9, 11):
            now[0] = b
            inj.at_boundary(b)
        return fired

    assert drive(tfaults, tinj) == drive(jfaults, jinj)


def test_guard_installs_flags_and_uninstalls():
    before = signal.getsignal(signal.SIGTERM)
    guard = tfaults.PreemptionGuard()
    try:
        assert guard.installed and not guard.requested and guard.coordinate(3) is None
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5
        while not guard.requested and time.monotonic() < deadline:
            time.sleep(0.01)
        assert guard.requested and guard.coordinate(4) == 4
    finally:
        guard.uninstall()
    assert signal.getsignal(signal.SIGTERM) is before and not guard.installed
    guard.uninstall()  # idempotent
    assert not tfaults.PreemptionGuard(enabled=False).installed


def _fire(pkg_tel, pkg_watch, tmp_path):
    rec = pkg_tel.TelemetryRecorder("arm", results_dir=str(tmp_path), heartbeat_every_sec=0.0)
    rec.begin_phase("timed")
    codes = []
    dog = pkg_watch.HangWatchdog(1.0, recorder=rec, poll_interval_sec=0.05,
                                 _exit=codes.append)
    dog.start()
    dog.beat(7)
    deadline = time.monotonic() + 10
    while not codes and time.monotonic() < deadline:
        time.sleep(0.05)
    dog.disarm()
    return codes, pkg_tel.read_events(rec.path)


def test_watchdog_fires_at_one_second_like_jax(tmp_path, capsys):
    t0 = time.monotonic()
    codes, events = _fire(ttel, twatch, tmp_path / "port")
    assert codes == [76] and 1.0 <= time.monotonic() - t0 < 8.0
    jcodes, jevents = _fire(jtel, jwatch, tmp_path / "jax")
    assert jcodes == [76]
    assert [e["event"] for e in events] == [e["event"] for e in jevents]
    dump = next(e for e in events if e["event"] == "hang_dump")
    jdump = next(e for e in jevents if e["event"] == "hang_dump")
    assert set(dump) == set(jdump) and dump["last_beat_step"] == 7 and dump["stacks"]
    assert next(e for e in events if e["event"] == "run_aborted")["reason"] == "hang"
    beats = [jtel.parse_heartbeat_line(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [b["reason"] for b in beats if b] == ["hang", "hang"]
    assert twatch.HangWatchdog(0).armed is False


def test_harness_hang_exits_76_with_a_stack_dump(tmp_path):
    # The timeout sits well above a step's time on a loaded host, so only
    # the injected hang can trip it.
    proc = subprocess.run(HARNESS + ["--steps", "6", "--warmup-steps", "1", "--results-dir",
                                     str(tmp_path), "--inject-fault", "hang@2:120",
                                     "--hang-timeout-sec", "10"],
                          capture_output=True, text=True, timeout=120, cwd=REPO,
                          env=dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1"))
    assert proc.returncode == 76, proc.stderr[-2000:]
    assert "HANG WATCHDOG" in proc.stderr
    events = ttel.read_events(str(tmp_path / "telemetry_zero2_ws1_seq64_tierS.jsonl"))
    kinds = [e["event"] for e in events]
    assert "fault_injected" in kinds and "hang_dump" in kinds
    assert events[-1]["event"] == "run_aborted" and events[-1]["reason"] == "hang"


SMALL = dict(tier="S", seq_len=64, warmup_steps=1, device="cpu", sync_every=1)


def test_enospc_on_save_degrades_and_finishes(tmp_path, capsys):
    r = run_benchmark(steps=3, results_dir=str(tmp_path / "res"),
                      checkpoint_dir=str(tmp_path / "ck"), checkpoint_every=1,
                      inject_fault="enospc-on-save", **SMALL)
    assert r.steps == 3 and r.tokens_per_sec > 0
    events = ttel.read_events(str(tmp_path / "res" / "telemetry_zero2_ws1_seq64_tierS.jsonl"))
    failed = [e for e in events if e["event"] == "checkpoint_failed"]
    assert [e["step"] for e in failed] == [1, 2, 2]  # two periodic saves, then the final
    assert all("No space left" in e["error"] for e in failed)
    assert not [n for n in os.listdir(tmp_path / "ck") if n.isdigit()]
    assert events[-1]["event"] == "run_end"
    assert "WARNING: checkpoint save at step 1 failed" in capsys.readouterr().out


def test_nan_loss_is_an_unresolved_anomaly(tmp_path):
    r = run_benchmark(steps=3, results_dir=str(tmp_path), inject_fault="nan-loss@2", **SMALL)
    assert r.n_anomalies == 1
    path = tmp_path / "result_zero2_ws1_seq64_tierS.json"
    import json

    failures = jvalid.validate_telemetry(str(path), json.loads(path.read_text()), "row")
    assert any("unresolved anomaly" in f for f in failures)


def test_every_kind_is_armed():
    assert tfaults.ARMED_KINDS == set(tfaults.FAULT_KINDS) and tfaults.WAITS_FOR == {}


def test_inject_fault_env_is_the_fallback(monkeypatch):
    monkeypatch.setenv("INJECT_FAULT", "data-stall@1")
    with pytest.raises(ValueError, match="data-stall@1 is a streaming-data fault"):
        run_benchmark(steps=2, **SMALL)
    with pytest.raises(ValueError, match="needs --checkpoint-dir"):
        run_benchmark(steps=2, inject_fault="torn-checkpoint", **SMALL)


def _two_ranks(tmp_path, extra):
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                "INJECT_FAULT"):
        env.pop(var, None)
    cmd = list(HARNESS)
    cmd[cmd.index("--world-size") + 1] = "2"
    procs = [subprocess.Popen(cmd + ["--num-processes", "2", "--rank", str(r), "--master-port",
                                     str(port), "--steps", "8", "--warmup-steps", "1",
                                     "--results-dir", str(tmp_path / "r")] + extra,
                              cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=180) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return [p.returncode for p in procs], outs


def test_sigterm_on_one_rank_stops_both_at_one_step(tmp_path):
    """``sigterm-rank@3:1``: rank 1 alone is signalled; rank 0 learns of it
    from the store's flag, both agree a step, save one emergency checkpoint
    and exit 75."""
    codes, outs = _two_ranks(tmp_path, ["--checkpoint-dir", str(tmp_path / "c"),
                                        "--inject-fault", "sigterm-rank@3:1"])
    assert codes == [75, 75], [err[-1500:] for _, err in outs]
    steps = {line.split("preempted at step ")[1].split(" ")[0]
             for out, _ in outs for line in out.splitlines() if line.startswith("PREEMPTED")}
    assert len(steps) == 1
    (step,) = steps
    assert os.path.isdir(tmp_path / "c" / step) and (tmp_path / "c" / f"digest_{step}.json").exists()
    assert (tmp_path / "r" / "telemetry_zero2_ws2_seq64_tierS.rank1.jsonl").exists()


def test_stall_on_one_rank_aborts_both_with_76(tmp_path):
    """``stall-rank@3:1:120``: rank 1 stalls; its watchdog fires and publishes
    the hang flag, and rank 0 aborts with the same code."""
    codes, outs = _two_ranks(tmp_path, ["--inject-fault", "stall-rank@3:1:120",
                                        "--hang-timeout-sec", "10"])
    assert codes == [76, 76], [err[-1500:] for _, err in outs]
    assert "HANG WATCHDOG (rank 1)" in outs[1][1]
