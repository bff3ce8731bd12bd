"""The port's supervisor and launcher against JAX's ``runtime.supervisor``.

- the pure half, on the same inputs through both modules: ``classify_exit``
  over -15..255, the policy's refusals and the shipped
  ``configs/recovery_policy.json``, ``backoff_sec`` float for float,
  ``plan_world_size`` over a grid, the chaos grammar, ``parse_cli`` with
  JAX's malformed calls, the geometry sidecar reader;
- the same scripted exit sequences through both ``Supervisor.run``s with a
  stub child (a Python script that imports neither torch nor jax and exits
  by a counter file): equal ledgers but for ``duration_sec``, equal
  argv / env surgery, equal stamped rows, JAX's frozen ledger schema;
- the port's own parts: the launcher (exit codes, a SIGKILLed rank, SIGTERM
  forwarded to every rank, through the supervisor too), ``--nproc``
  rewritten with ``--world-size``, the CPU probe, no torch in the
  supervisor's process, ``supervised_attempt`` in the recorder's meta under
  JAX's rule;
- one real chain (module fixture): a two-rank gloo harness at tier S
  preempted by ``sigterm@5`` under ``--chaos lose-host@2``, classed
  ``preempted`` (the launcher carries exit 75 up), resumed at world 1, its
  stamped row passed by both validators, and the post-run path over its
  results: the port's regress, metrics.csv, telemetry report and Markdown
  report against JAX's.
"""

import json
import os
import signal
import subprocess
import sys
import time
import types
from pathlib import Path

import pytest

from distributed_llm_training_benchmark_framework_tpu.analysis import (
    make_report as jreport,
    parse_metrics as jparse,
    telemetry_report as jtrep,
    validate_results as jvalid,
)
from distributed_llm_training_benchmark_framework_tpu.regress import compare as jcompare
from distributed_llm_training_benchmark_framework_tpu.runtime import supervisor as jsup
from distributed_llm_training_benchmark_framework_tpu.train import loop as jloop
from distributed_llm_training_benchmark_framework_tpu_torch.analysis import (
    make_report as treport,
    parse_metrics as tparse,
    telemetry_report as ttrep,
    validate_results as tvalid,
)
from distributed_llm_training_benchmark_framework_tpu_torch.regress import compare as tcompare
from distributed_llm_training_benchmark_framework_tpu_torch.regress import store as tstore
from distributed_llm_training_benchmark_framework_tpu_torch.runtime import launch as tlaunch
from distributed_llm_training_benchmark_framework_tpu_torch.runtime import supervisor as tsup
from distributed_llm_training_benchmark_framework_tpu_torch.train import loop as tloop
from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
FROZEN_LEDGER = REPO / "tests" / "fixtures" / "supervision_ledger_frozen.json"
PKG = "distributed_llm_training_benchmark_framework_tpu_torch"
SUP = [sys.executable, "-m", f"{PKG}.runtime.supervisor"]
LAUNCH = [sys.executable, "-m", tlaunch.LAUNCH_MODULE]


def _env(**extra):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1", **extra)
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                "INJECT_FAULT", "SUPERVISOR_CHAOS", "RECOVERY_POLICY",
                "SUPERVISOR_DEVICE_COUNT", "BENCH_SUPERVISED_ATTEMPT",
                "REGRESS_REGISTRY_TORCH"):
        if var not in extra:
            env.pop(var, None)
    return env


# ---------------------------------------------------------------------------
# The pure half, through both modules
# ---------------------------------------------------------------------------


def test_classify_exit_equals_jax_over_every_code():
    for rc in range(-15, 256):
        assert tsup.classify_exit(rc) == jsup.classify_exit(rc), rc
    assert tsup.EXIT_CLASSES == jsup.EXIT_CLASSES and tsup.ACTIONS == jsup.ACTIONS
    assert tsup.SUPERVISOR_FAULT_KINDS == jsup.SUPERVISOR_FAULT_KINDS
    assert (tsup.BACKOFF_CAP_SEC, tsup.LEDGER_NAME, tsup.SUPERVISION_SCHEMA_VERSION) == (
        jsup.BACKOFF_CAP_SEC, jsup.LEDGER_NAME, jsup.SUPERVISION_SCHEMA_VERSION)


def _policy(**overrides):
    p = {"schema_version": 1, "backoff_base_sec": 0.0, "backoff_max_sec": 0.0,
         "jitter_frac": 0.0, "classes": {"preempted": {"action": "resume", "max_attempts": 2}}}
    p.update(overrides)
    return p


@pytest.mark.parametrize("mutate", [
    lambda p: p.update(schema_version=2),
    lambda p: p.update(classes={}),
    lambda p: p.update(classes={"bogus": {"action": "resume"}}),
    lambda p: p.update(classes={"ok": {"action": "resume"}}),
    lambda p: p.update(classes={"hung": {"action": "reboot", "max_attempts": 1}}),
    lambda p: p.update(classes={"hung": {"action": "resume", "max_attempts": -1}}),
    lambda p: p.update(classes={"hung": {"action": "resume", "max_attempts": 1.5}}),
    lambda p: p.update(jitter_frac=-0.1),
    lambda p: p.update(backoff_base_sec=-1),
], ids=["schema", "empty", "unknown-class", "ok-class", "action", "negative", "float",
        "jitter", "backoff"])
def test_policy_refusals_equal_jax(mutate):
    messages = []
    for mod in (jsup, tsup):
        p = _policy()
        mutate(p)
        with pytest.raises(mod.PolicyError) as e:
            mod.validate_policy(p)
        messages.append(str(e.value))
    assert messages[0] == messages[1]
    assert not issubclass(tsup.PolicyError, jsup.PolicyError)


def test_policies_equal_jax(tmp_path, monkeypatch):
    with open(REPO / "configs" / "recovery_policy.json") as f:
        shipped = json.load(f)
    assert tsup.validate_policy(json.loads(json.dumps(shipped))) == \
        jsup.validate_policy(json.loads(json.dumps(shipped)))
    for env in ({}, {"MAX_ARM_RETRIES": "3", "RETRY_BACKOFF_SEC": "2"}, {"MAX_ARM_RETRIES": "0"}):
        assert tsup.default_policy_from_env(env) == jsup.default_policy_from_env(env)
    monkeypatch.setenv("MAX_ARM_RETRIES", "4")
    assert tsup.load_policy(None) == jsup.load_policy(None)
    path = tmp_path / "policy.json"
    path.write_text(json.dumps(_policy()))
    assert tsup.load_policy(str(path)) == jsup.load_policy(str(path))


def test_backoff_equals_jax_float_for_float():
    for base, cap, frac in ((2.0, 9.0, 0.0), (4.0, 600.0, 0.25), (5.0, 600.0, 0.1),
                            (0.0, 0.0, 0.5), (0.5, 3.0, 1.0)):
        p = {"backoff_base_sec": base, "backoff_max_sec": cap, "jitter_frac": frac}
        for n in range(-1, 7):
            for token in ("python3|1", "python3|2", "arm|3", "x", ""):
                assert tsup.backoff_sec(p, n_recoveries=n, token=token) == \
                    jsup.backoff_sec(p, n_recoveries=n, token=token)


def test_plan_world_size_equals_jax_over_a_grid():
    axes_set = ({"data": 4}, {"data": 3}, {"data": 2}, {"data": 8, "model": 2},
                {"data": 2, "seq": 2, "pipe": 2}, {"model": 4}, {"data": 6, "expert": 2}, {})
    for axes in axes_set:
        for available in (None, 0, 1, 2, 3, 4, 5, 8, 16):
            for original in (1, 2, 4, 8, 16):
                for current in (1, 2, 4, 8):
                    kw = dict(saved_axes=axes, available=available, original_world=original,
                              current_world=current)
                    assert tsup.plan_world_size(**kw) == jsup.plan_world_size(**kw), kw


CHAOS_SPECS = (["lose-host@2"], ["lose-host@2:3", "regain-host@4"], ["preempt-storm@2"],
               ["", ""], ["meteor@2"], ["lose-host@soon"], ["lose-host@0"],
               ["preempt-storm@2:9"], ["regain-host@3:1"], ["lose-host@1:x"])


@pytest.mark.parametrize("specs", CHAOS_SPECS, ids=[",".join(s) or "empty" for s in CHAOS_SPECS])
def test_chaos_grammar_equals_jax(specs):
    out = []
    for mod in (jsup, tsup):
        try:
            out.append(("ok", mod.parse_supervisor_chaos(specs)))
        except ValueError as e:
            out.append(("refused", str(e)))
    assert out[0] == out[1]


CLI_CALLS = (
    ["--resume-flag", "--resume", "--drop-on-retry", "--inject-fault", "--chaos", "lose-host@2",
     "--chaos=preempt-storm@2", "--results-dir", "/r", "--", "python", "-u", "h.py"],
    ["--policy", "p.json", "--ledger", "l.json", "--", "x"],
    ["--policy"],
    ["--frobnicate", "x", "--", "cmd"],
    ["--results-dir", "/r"],
    ["--results-dir", "/r", "--"],
    ["--", "a", "--", "b"],
)


@pytest.mark.parametrize("argv", CLI_CALLS, ids=range(len(CLI_CALLS)))
def test_parse_cli_equals_jax(argv):
    out = []
    for mod in (jsup, tsup):
        try:
            out.append(("ok", mod.parse_cli(argv)))
        except ValueError as e:
            out.append(("refused", str(e)))
    assert out[0] == out[1]


def test_cli_usage_error_exits_2():
    proc = subprocess.run(SUP + ["--no-such-flag"], capture_output=True, text=True, cwd=REPO,
                          env=_env(), timeout=60)
    assert proc.returncode == 2 and "usage:" in proc.stderr


def test_saved_geometry_reader_equals_jax(tmp_path):
    seen = []
    for files in ({}, {"geometry_4.json": {"schema_version": 1, "mesh_axes": {"data": 4},
                                           "world_size": 4},
                       "geometry_8.json": {"schema_version": 1, "mesh_axes": {"data": 2},
                                           "world_size": 2}},
                  {"geometry_9.json": {"schema_version": 99, "mesh_axes": {"data": 2}}},
                  {"geometry_9.json": "{not json"},
                  {"geometry_9.json": {"schema_version": 1, "mesh_axes": [2]}}):
        for name, payload in files.items():
            (tmp_path / name).write_text(payload if isinstance(payload, str)
                                         else json.dumps(payload))
        got = tsup.read_saved_geometry(str(tmp_path))
        assert got == jsup.read_saved_geometry(str(tmp_path))
        seen.append(got)
    assert seen[1]["mesh_axes"] == {"data": 2} and seen[2] is None


# ---------------------------------------------------------------------------
# The same exit sequences through both supervisors
# ---------------------------------------------------------------------------

STUB = """
import json, os, sys
state = os.environ["STUB_DIR"]
codes = json.load(open(os.path.join(state, "codes.json")))
count = os.path.join(state, "count")
n = int(open(count).read()) if os.path.exists(count) else 0
open(count, "w").write(str(n + 1))
with open(os.path.join(state, "log.jsonl"), "a") as f:
    f.write(json.dumps({"argv": sys.argv[1:], "inject": os.environ.get("INJECT_FAULT", "unset"),
                        "attempt": os.environ.get("BENCH_SUPERVISED_ATTEMPT")}) + "\\n")
rc = codes[n] if n < len(codes) else 0
if rc == 0:
    rd = sys.argv[sys.argv.index("--results-dir") + 1]
    with open(os.path.join(rd, "result_stub.json"), "w") as f:
        json.dump({"arm": "stub", "world_size": 1}, f)
sys.exit(rc)
"""

SHRINK_POLICY = {"preempted": {"action": "resume-shrunk", "max_attempts": 3}}
SCENARIOS = {
    # codes, classes, policy overrides, Supervisor kwargs, chaos specs, geometry, probe
    "resume_drops_fault": ([75, 0], {"preempted": {"action": "resume", "max_attempts": 2}},
                           {}, dict(resume_flag="--resume", drop_on_retry="--inject-fault"),
                           [], None, None),
    "budget_spent": ([76] * 9, {"hung": {"action": "resume", "max_attempts": 2}}, {},
                     dict(resume_flag="--resume"), [], None, None),
    "nothing_to_resume": ([77], {"nothing-to-resume": {"action": "resume", "max_attempts": 5}},
                          {}, {}, [], None, None),
    "cold_retry": ([1, 0], {"crash": {"action": "cold-retry", "max_attempts": 1}}, {},
                   dict(resume_flag="--resume", drop_on_retry="--inject-fault"), [], None, None),
    "no_policy_entry": ([1], {"preempted": {"action": "resume", "max_attempts": 1}}, {}, {}, [],
                        None, None),
    "preempt_storm": ([75, 75, 0], {"preempted": {"action": "resume", "max_attempts": 3}}, {},
                      dict(resume_flag="--resume", drop_on_retry="--inject-fault"),
                      ["preempt-storm@2"], None, None),
    "backoff_jitter": ([75, 78, 75, 0], {"preempted": {"action": "resume", "max_attempts": 3},
                                         "data_stall": {"action": "resume", "max_attempts": 1}},
                       {"backoff_base_sec": 2.0, "backoff_max_sec": 600.0, "jitter_frac": 0.25},
                       dict(resume_flag="--resume"), [], None, None),
    "shrink_then_regrow": ([75, 75, 0], SHRINK_POLICY, {},
                           dict(resume_flag="--resume", drop_on_retry="--inject-fault"),
                           ["lose-host@2:3", "regain-host@3"], {"data": 4}, 8),
    "shrink_infeasible": ([75, 0], SHRINK_POLICY, {}, dict(resume_flag="--resume"),
                          ["lose-host@2:1"], {"model": 4}, 8),
    "shrink_probe_none": ([75, 0], SHRINK_POLICY, {}, dict(resume_flag="--resume"), [],
                          {"data": 4}, None),
}


def _run_stub(mod, tmp_path, monkeypatch, scenario):
    codes, classes, overrides, kwargs, chaos, geometry, probe = SCENARIOS[scenario]
    state, results, ckpt = tmp_path / "state", tmp_path / "results", tmp_path / "ckpt"
    for d in (state, results, ckpt):
        if d.exists():
            for f in d.iterdir():
                f.unlink()
        d.mkdir(exist_ok=True)
    (state / "codes.json").write_text(json.dumps(codes))
    stub = tmp_path / "stub.py"
    stub.write_text(STUB)
    if geometry:
        (ckpt / "geometry_4.json").write_text(json.dumps({"schema_version": 1,
                                                          "mesh_axes": geometry,
                                                          "world_size": 4}))
    monkeypatch.setenv("STUB_DIR", str(state))
    for var in ("INJECT_FAULT", "BENCH_SUPERVISED_ATTEMPT", "SUPERVISOR_DEVICE_COUNT"):
        monkeypatch.delenv(var, raising=False)
    sleeps = []
    cmd = [sys.executable, str(stub), "--steps", "5", "--inject-fault", "sigterm@3",
           "--results-dir", str(results), "--world-size", "4", "--checkpoint-dir", str(ckpt)]
    s = mod.Supervisor(cmd, policy=mod.validate_policy(_policy(classes=classes, **overrides)),
                       chaos=mod.parse_supervisor_chaos(chaos), sleep=sleeps.append,
                       probe=lambda: probe, **kwargs)
    rc = s.run()
    ledger = json.loads((results / "supervision.json").read_text())
    for a in ledger["attempts"]:
        assert a.pop("duration_sec") >= 0
    row = results / "result_stub.json"
    log = [json.loads(line) for line in (state / "log.jsonl").read_text().splitlines()]
    return rc, ledger, sleeps, log, json.loads(row.read_text()) if row.exists() else None


@pytest.mark.parametrize("scenario", sorted(SCENARIOS))
def test_scripted_exits_give_jax_ledger(tmp_path, monkeypatch, scenario):
    jax_side = _run_stub(jsup, tmp_path, monkeypatch, scenario)
    port_side = _run_stub(tsup, tmp_path, monkeypatch, scenario)
    assert port_side == jax_side
    rc, ledger, _, _, row = port_side
    frozen = json.loads(FROZEN_LEDGER.read_text())
    assert ledger["schema_version"] == frozen["schema_version"]
    assert sorted(ledger) == sorted(frozen["ledger_keys"])
    base, optional = set(frozen["attempt_keys"]) - {"duration_sec"}, set(
        frozen["optional_attempt_keys"])
    for attempt in ledger["attempts"]:
        assert base <= set(attempt) and set(attempt) - base <= optional, attempt
    assert sorted(tsup.supervision_summary(ledger)) == sorted(frozen["summary_keys"])
    assert rc == ledger["attempts"][-1]["rc"]
    assert (row is not None and "supervision" in row) == (rc == 0 and ledger["n_attempts"] > 1)


def test_scripted_shrink_and_regrow_legs(tmp_path, monkeypatch):
    rc, ledger, _, log, row = _run_stub(tsup, tmp_path, monkeypatch, "shrink_then_regrow")
    assert rc == 0 and ledger["shrink_legs"] == ["4->2", "2->4"]
    worlds = [entry["argv"][entry["argv"].index("--world-size") + 1] for entry in log]
    assert worlds == ["4", "2", "4"] and row["supervision"]["shrink_legs"] == ["4->2", "2->4"]
    assert [entry["attempt"] for entry in log] == ["1", "2", "3"]
    assert [entry["inject"] for entry in log] == ["unset", "", ""]


def test_stamp_touches_only_this_runs_row(tmp_path):
    stale = tmp_path / "result_old.json"
    stale.write_text('{"arm": "old"}')
    past = time.time() - 3600
    os.utime(stale, (past, past))
    assert tsup.stamp_result_row(str(tmp_path), time.time(), {"n_attempts": 2}) is None
    fresh = tmp_path / "result_new.json"
    fresh.write_text('{"arm": "new"}')
    assert tsup.stamp_result_row(str(tmp_path), past, {"n_attempts": 2}) == str(fresh)
    assert json.loads(fresh.read_text())["supervision"] == {"n_attempts": 2}
    assert "supervision" not in json.loads(stale.read_text())


# ---------------------------------------------------------------------------
# The port's own parts: the launcher, --nproc, the probe, no torch
# ---------------------------------------------------------------------------


def _launcher_cmd(nproc, harness_args=("--world-size", "2")):
    return LAUNCH + ["--nproc", str(nproc), "--"] + [sys.executable, "h.py", *harness_args]


@pytest.mark.parametrize("available, world, legs", [(1, 1, ["2->1"]), (8, 2, [])])
def test_resume_shrunk_rewrites_the_launchers_process_count(tmp_path, available, world, legs):
    (tmp_path / "geometry_4.json").write_text(json.dumps(
        {"schema_version": 1, "mesh_axes": {"data": 2}, "world_size": 2}))
    cmd = _launcher_cmd(2, ("--world-size", "2", "--checkpoint-dir", str(tmp_path),
                            "--results-dir", str(tmp_path)))
    s = tsup.Supervisor(cmd, policy=tsup.validate_policy(_policy()), resume_flag="--resume",
                        probe=lambda: available)
    nxt, notes = s.plan_next_cmd("resume-shrunk", 2)
    launch_at = nxt.index(tlaunch.LAUNCH_MODULE)
    assert nxt[launch_at + 1:launch_at + 3] == ["--nproc", str(world)]
    assert nxt[nxt.index("--world-size") + 1] == str(world) and nxt[-1] == "--resume"
    assert s.ledger["shrink_legs"] == legs and notes["devices_available"] == available
    plain = [sys.executable, "h.py", "--world-size", "2"]
    assert tsup.set_launcher_nproc(plain, 1) == plain


def test_probe_counts_gloo_ranks_under_device_cpu(monkeypatch):
    monkeypatch.delenv("SUPERVISOR_DEVICE_COUNT", raising=False)
    assert tsup.probe_device_count(device="cpu") == len(os.sched_getaffinity(0)) >= 1
    monkeypatch.setenv("SUPERVISOR_DEVICE_COUNT", "3")
    assert tsup.probe_device_count(device="cpu") == 3 == tsup.probe_device_count()
    monkeypatch.setenv("SUPERVISOR_DEVICE_COUNT", "many")
    assert tsup.probe_device_count() is None
    s = tsup.Supervisor(["x", "--device", "cpu", "--world-size", "2"],
                        policy=tsup.validate_policy(_policy()))
    monkeypatch.delenv("SUPERVISOR_DEVICE_COUNT")
    assert s.probe() == len(os.sched_getaffinity(0))


RANK = """
import os, signal, sys, time
argv = sys.argv[1:]
rank = int(argv[argv.index("--rank") + 1]) if "--rank" in argv else 0
n = int(argv[argv.index("--num-processes") + 1]) if "--num-processes" in argv else 1
out = argv[argv.index("--out") + 1]
mode = argv[argv.index("--mode") + 1]
open(os.path.join(out, f"rank{rank}.argv"), "w").write(" ".join(argv) + " LOCAL_RANK="
                                                        + os.environ.get("LOCAL_RANK", "-"))
print(f"OUT rank{rank}", flush=True)
def on_term(signum, frame):
    open(os.path.join(out, f"rank{rank}.term"), "w").write("x")
    sys.exit(75)
signal.signal(signal.SIGTERM, on_term)
if mode.startswith("exit"):
    sys.exit(int(mode[4:]))
if mode == "sigkill1":
    if rank == 1:
        os.kill(os.getpid(), signal.SIGKILL)
    time.sleep(60)
if mode == "first75":
    if rank == 0:
        sys.exit(75)
    time.sleep(60)
if mode == "wait":
    open(os.path.join(out, f"rank{rank}.ready"), "w").write("x")
    attempt = os.environ.get("BENCH_SUPERVISED_ATTEMPT", "1")
    if attempt != "1":
        if rank == 0:
            open(os.path.join(out, "result_x.json"), "w").write('{"arm": "x"}')
        sys.exit(0)
    time.sleep(60)
    sys.exit(1)
"""


def _rank_cmd(tmp_path, mode):
    rank = tmp_path / "rank.py"
    rank.write_text(RANK)
    return [sys.executable, str(rank), "--out", str(tmp_path), "--mode", mode]


def _launch(tmp_path, nproc, mode):
    return subprocess.Popen(LAUNCH + ["--nproc", str(nproc), "--"] + _rank_cmd(tmp_path, mode),
                            env=_env(), cwd=REPO)


@pytest.mark.parametrize("code", [0, 75, 76, 77, 78])
def test_launcher_exits_with_the_ranks_code(tmp_path, code):
    proc = _launch(tmp_path, 2, f"exit{code}")
    assert proc.wait(timeout=60) == code
    argv = [(tmp_path / f"rank{r}.argv").read_text() for r in range(2)]
    port = {a.split("--master-port ")[1].split()[0] for a in argv}
    assert len(port) == 1
    for r, a in enumerate(argv):
        assert f"--num-processes 2 --rank {r} --master-port" in a and a.endswith(
            f"LOCAL_RANK={r}")


def test_launcher_stdout_is_rank_zeros_alone(tmp_path):
    proc = subprocess.run(LAUNCH + ["--nproc", "3", "--"] + _rank_cmd(tmp_path, "exit0"),
                          env=_env(), cwd=REPO, capture_output=True, text=True, timeout=60)
    assert proc.returncode == 0
    assert proc.stdout.split() == ["OUT", "rank0"]
    assert "OUT rank1" in proc.stderr and "OUT rank2" in proc.stderr


@pytest.mark.parametrize("argv, needle", [
    (["--", "x"], "--nproc is required"),
    (["--nproc", "2", "--frob", "1", "--", "x"], "unknown flag"),
    (["--nproc", "2", "--"], "no command after"),
    (["--nproc", "2"], "missing -- separator"),
    (["--nproc"], "needs a value"),
])
def test_launcher_refuses_malformed_calls(argv, needle, capsys):
    with pytest.raises(ValueError, match=needle):
        tlaunch.parse_cli(argv)
    assert tlaunch.main(argv) == 2 and "usage:" in capsys.readouterr().err
    assert tlaunch.parse_cli(["--nproc=3", "--", "a", "--b"]) == (3, ["a", "--b"])


def test_launcher_of_one_rank_runs_the_command_as_it_is(tmp_path):
    assert _launch(tmp_path, 1, "exit75").wait(timeout=60) == 75
    argv = (tmp_path / "rank0.argv").read_text()
    assert "--rank" not in argv and "--num-processes" not in argv


@pytest.mark.parametrize("mode, code", [("sigkill1", 128 + signal.SIGKILL), ("first75", 75)])
def test_launcher_kills_the_rest_after_the_grace(tmp_path, mode, code):
    t0 = time.monotonic()
    assert tlaunch.launch(_rank_cmd(tmp_path, mode), 2, grace_sec=1.0) == code
    assert time.monotonic() - t0 < 30  # the survivor's 60 s sleep was cut


def _wait_ready(tmp_path, n):
    deadline = time.monotonic() + 60
    while not all((tmp_path / f"rank{r}.ready").exists() for r in range(n)):
        assert time.monotonic() < deadline
        time.sleep(0.05)


def test_launcher_forwards_sigterm_to_every_rank(tmp_path):
    proc = _launch(tmp_path, 3, "wait")
    _wait_ready(tmp_path, 3)
    proc.send_signal(signal.SIGTERM)
    assert proc.wait(timeout=60) == 75
    assert all((tmp_path / f"rank{r}.term").exists() for r in range(3))


def test_supervisor_sigterm_reaches_every_rank_and_resumes(tmp_path):
    """SIGTERM to the supervisor -> the launcher -> both ranks (75); the
    policy resumes, attempt 2 exits 0; and neither the supervisor's nor the
    launcher's process imports torch."""
    rank = tmp_path / "rank.py"
    rank.write_text(RANK)
    code = ("import sys; from " + PKG + ".runtime import supervisor as s; "
            "rc = s.main(sys.argv[1:]); import " + PKG + ".runtime.launch; "
            "print('TORCH', 'torch' in sys.modules, flush=True); sys.exit(rc)")
    proc = subprocess.Popen(
        [sys.executable, "-c", code, "--resume-flag", "--resume", "--results-dir",
         str(tmp_path), "--"] + LAUNCH + ["--nproc", "2", "--", sys.executable, str(rank),
                                          "--out", str(tmp_path), "--mode", "wait"],
        env=_env(MAX_ARM_RETRIES="1", RETRY_BACKOFF_SEC="0"), cwd=REPO,
        stdout=subprocess.PIPE, text=True)
    _wait_ready(tmp_path, 2)
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=60)
    assert proc.returncode == 0 and "TORCH False" in out
    assert all((tmp_path / f"rank{r}.term").exists() for r in range(2))
    ledger = json.loads((tmp_path / "supervision.json").read_text())
    assert [a["class"] for a in ledger["attempts"]] == ["preempted", "ok"]
    assert json.loads((tmp_path / "result_x.json").read_text())["supervision"]["n_attempts"] == 2


@pytest.mark.parametrize("value", ["", "1", "2", "7", "x", "-3"])
def test_supervised_attempt_in_meta_follows_jax(monkeypatch, value):
    monkeypatch.setenv("BENCH_SUPERVISED_ATTEMPT", value)
    jrec = jloop._make_recorder(dict(
        strategy=types.SimpleNamespace(name="zero2"), world_size=1, seq_len=64, tier="S",
        per_device_batch=1, grad_accum=2, steps=4, telemetry=False, results_dir=None))
    trec = tloop._make_recorder(
        strategy="zero2", world_size=1, tensor_parallel=1, sequence_parallel=1,
        pipeline_parallel=1, expert_parallel=1, pipeline_schedule="gpipe", virtual_stages=2,
        n_experts=0, causal=False, ring_zigzag=None, tp_collective_matmul=False, seq_len=64,
        tier="S", model_family="tinygpt", per_device_batch=1, grad_accum=2,
        attention_impl="reference", results_dir=None, telemetry=False, heartbeat_sec=30.0,
        steps=4, data_path=None)
    assert jrec.meta["strategy"] == trec.meta["strategy"] == "zero2"
    assert trec.meta.get("supervised_attempt") == jrec.meta.get("supervised_attempt")
    assert ("supervised_attempt" in trec.meta) == (value in ("2", "7"))


# ---------------------------------------------------------------------------
# One real chain: two gloo ranks preempted, resumed at world 1
# ---------------------------------------------------------------------------

HARNESS = [sys.executable, "-m", f"{PKG}.train.harness", "--device", "cpu", "--strategy",
           "zero2", "--world-size", "2", "--tier", "S", "--seq-len", "64",
           "--per-device-batch", "1", "--grad-accum", "2", "--steps", "8",
           "--warmup-steps", "1", "--heartbeat-sec", "0", "--checkpoint-every", "2"]
ROW = "result_zero2_ws1_seq64_tierS.json"


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    base = tmp_path_factory.mktemp("supervised_chain")
    results, ckpt = base / "results", base / "ckpt"
    policy = base / "policy.json"
    policy.write_text(json.dumps({
        "schema_version": 1, "backoff_base_sec": 0.0, "backoff_max_sec": 0.0,
        "jitter_frac": 0.0,
        "classes": {"preempted": {"action": "resume-shrunk", "max_attempts": 2},
                    "crash": {"action": "cold-retry", "max_attempts": 1}}}))
    proc = subprocess.run(
        SUP + ["--policy", str(policy), "--resume-flag", "--resume", "--drop-on-retry",
               "--inject-fault", "--results-dir", str(results), "--chaos", "lose-host@2",
               "--"] + LAUNCH + ["--nproc", "2", "--"] + HARNESS
        + ["--results-dir", str(results), "--checkpoint-dir", str(ckpt),
           "--inject-fault", "sigterm@5"],
        capture_output=True, text=True, env=_env(), cwd=REPO, timeout=300)
    return {"base": base, "results": results, "proc": proc}


def test_chain_is_preempted_then_resumed_at_world_one(chain):
    proc = chain["proc"]
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "geometry leg 2->1" in proc.stderr
    ledger = json.loads((chain["results"] / "supervision.json").read_text())
    assert ledger["n_attempts"] == 2 and ledger["shrink_legs"] == ["2->1"]
    first, second = ledger["attempts"]
    assert (first["class"], first["rc"], first["action"]) == ("preempted", 75, "resume-shrunk")
    assert first["devices_available"] == 1 and first["world_size"] == 2
    cmd2 = " ".join(second["cmd"])
    assert "--nproc 1 --" in cmd2 and "--world-size 1" in cmd2 and "--resume" in cmd2
    assert "--inject-fault" not in cmd2 and second["class"] == "ok"


def test_chain_row_is_stamped_and_both_validators_pass_it(chain):
    path = chain["results"] / ROW
    row = json.loads(path.read_text())
    assert row["world_size"] == 1 and row["resumed"] and row["resume_geometry_changed"]
    assert row["supervision"]["n_attempts"] == 2
    assert row["supervision"]["actions"] == ["resume-shrunk"]
    assert row["supervision"]["shrink_legs"] == ["2->1"]
    for vr in (tvalid, jvalid):
        assert vr.validate_result(row, "row") + vr.validate_telemetry(str(path), row, "row") == []
    failures, n = tvalid.collect(str(chain["results"]), None)
    assert failures == [] and n == 1


def test_chain_telemetry_carries_the_attempt(chain):
    res = chain["results"]
    first = [json.loads(x) for x in (res / "telemetry_zero2_ws2_seq64_tierS.jsonl").open()]
    second = [json.loads(x) for x in (res / "telemetry_zero2_ws1_seq64_tierS.jsonl").open()]
    assert "supervised_attempt" not in first[0] and first[0]["event"] == "run_meta"
    assert second[0]["event"] == "run_meta" and second[0]["supervised_attempt"] == 2
    # Only rank 0 writes the launcher's stdout: every heartbeat line is whole.
    beats = [json.loads(line.split(" ", 1)[1]) for line in chain["proc"].stdout.splitlines()
             if line.startswith("BENCHMARK_HEARTBEAT")]
    later = [b for b in beats if b["world_size"] == 1]
    assert later and all(b["supervised_attempt"] == 2 for b in later)
    assert all("supervised_attempt" not in b for b in beats if b["world_size"] == 2)


def test_chain_post_run_path_equals_jax(chain, tmp_path, capsys):
    """ingest -> gate -> metrics.csv -> telemetry report -> Markdown on the
    chain's results, through the port's modules and JAX's."""
    res = str(chain["results"])
    outs = {}
    for tag, cmp_mod, parse, trep, report in (("jax", jcompare, jparse, jtrep, jreport),
                                              ("port", tcompare, tparse, ttrep, treport)):
        reg = str(tmp_path / tag / "reg")
        codes = [cmp_mod.main(["--registry", reg, "ingest", "--results-dir", res]),
                 cmp_mod.main(["--registry", reg, "gate", "--all"]),
                 cmp_mod.main(["--registry", reg, "list"])]
        df = parse.add_scaling_efficiency(parse.load_results(res))
        csv = tmp_path / f"{tag}.csv"
        parse.to_csv(df, str(csv))
        codes.append(trep.main(["--results-dir", res]))
        md = report.build_report(df, registry_root=reg).replace(reg, "REG")
        text = capsys.readouterr().out.replace(reg, "REG")
        outs[tag] = (codes, csv.read_text(), text, md)
    assert outs["port"][:3] == outs["jax"][:3]
    assert outs["port"][0] == [0, 0, 0, 0]
    # The resumed, supervised row is recorded, but never a baseline and
    # never gated.
    assert "SKIP arm=zero2_ws1_seq64_tierS" in outs["port"][2]
    assert "is a resumed (stitched) run" in outs["port"][2]
    reg = tstore.Registry(str(tmp_path / "port" / "reg"))
    assert len(reg.records("zero2_ws1_seq64_tierS")) == 1
    assert reg.baseline("zero2_ws1_seq64_tierS") is None
    assert ",2,resume-shrunk,2->1," in outs["port"][1]
    assert outs["port"][3].splitlines() == [port_line(x) for x in outs["jax"][3].splitlines()]
    assert "Supervised recoveries:** 1 arm(s)" in outs["port"][3]


def port_line(line):
    """JAX's report line as the port writes it: the title, the arms'
    trade-off blurbs and the remat frontier's headroom note (with the
    port's window note) are the only lines that differ (``make_report``'s docstring)."""
    if line == "# TPU Distributed Training Benchmark Report":
        return treport.TITLE
    for arm, (_, blurb) in jreport.TRADEOFFS.items():
        if line == blurb:
            return treport.TRADEOFFS[arm][1]
    return line.replace("(blank off-TPU).",
                        "(blank off the card). " + treport.FRONTIER_WINDOW_NOTE)
