"""The port's run registry and regression gate against JAX's ``regress``.

Frozen inputs only (no training but the bench's two tier-S runs at the
end): ``tests/fixtures/registry_frozen*``. Held equal to JAX's: record ids,
``config_key``, the registry's reads (baseline, noise-floor histories), the
never-baseline rules (partial, resumed, rolled back, supervisor-recovered,
banked), and the CLI's outputs and exit codes for ingest / list / gate /
compare / trend / bisect / bank / unbank. The port's own: ``torch_version``
and no ``jax_version`` in the fingerprint, its default root and variable,
``ingest --legacy`` refused, and the bench's ``--regress`` / ``--registry``
(one JSON line on stdout, the record and the verdict on stderr).
"""

import argparse
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from distributed_llm_training_benchmark_framework_tpu.regress import compare as jcompare
from distributed_llm_training_benchmark_framework_tpu.regress import store as jstore
from distributed_llm_training_benchmark_framework_tpu_torch import bench as tbench
from distributed_llm_training_benchmark_framework_tpu_torch.regress import compare as tcompare
from distributed_llm_training_benchmark_framework_tpu_torch.regress import stats as tstats
from distributed_llm_training_benchmark_framework_tpu_torch.regress import store as tstore

REPO = Path(__file__).resolve().parents[1]
FIXTURES = REPO / "tests" / "fixtures"
FROZEN = FIXTURES / "registry_frozen"
FROZEN_ARM = "zero2_ws4_seq128_tierS"
RECORD_DIRS = ("registry_frozen_candidates", "registry_frozen_scaling",
               "registry_frozen_scaling_candidates", "registry_frozen_remat")


def _fixture_records(name):
    if name == "registry_frozen":
        return [json.loads(p.read_text()) for p in sorted((FROZEN / "records").rglob("*.json"))]
    return [json.loads(p.read_text()) for p in sorted((FIXTURES / name).glob("record_*.json"))]


@pytest.mark.parametrize("name", ("registry_frozen",) + RECORD_DIRS)
def test_config_keys_and_record_ids_equal_jax(name):
    for rec in _fixture_records(name):
        assert tstore.config_key(rec) == jstore.config_key(rec)
        assert tstore.record_id_for(rec) == jstore.record_id_for(rec)
        if rec.get("schema_version") == 1:
            assert tstore.record_id_for(rec) == rec["record_id"]
        kw = dict(arm=rec["arm"], result_row=rec["result"], windows=rec["windows"],
                  tokens_per_step=rec["tokens_per_step"], status=rec["status"],
                  source=rec.get("source", ""), metric=rec["metric"])
        mine, theirs = tstore.make_record(**kw), jstore.make_record(**kw)
        assert mine["record_id"] == theirs["record_id"]
        assert {k: v for k, v in mine.items() if k != "env"} == \
            {k: v for k, v in theirs.items() if k != "env"}


def test_fingerprint_names_torch_not_jax():
    import torch

    row = {"device_kind": "NVIDIA H100 80GB HBM3", "backend": "cuda", "world_size": 1}
    env = tstore.make_record(arm="a", result_row=row)["env"]
    assert env["torch_version"] == torch.__version__ and "jax_version" not in env
    assert env["cuda_version"] == torch.version.cuda
    assert (env["device_kind"], env["backend"]) == ("NVIDIA H100 80GB HBM3", "cuda")
    jenv = jstore.make_record(arm="a", result_row=row)["env"]
    assert set(env) - {"torch_version", "cuda_version"} == set(jenv) - {"jax_version"}


def test_registry_root_is_the_ports_own(monkeypatch):
    monkeypatch.delenv("REGRESS_REGISTRY_TORCH", raising=False)
    monkeypatch.setenv("REGRESS_REGISTRY", "/elsewhere/jax")
    assert tstore.default_registry_root() == str(REPO / "results" / "registry_torch")
    assert jstore.default_registry_root() == "/elsewhere/jax"
    monkeypatch.setenv("REGRESS_REGISTRY_TORCH", "/elsewhere/torch")
    assert tstore.Registry().root == "/elsewhere/torch"
    assert tstore.REGISTRY_ENV == "REGRESS_REGISTRY_TORCH"


def test_legacy_ingest_is_refused(tmp_path, capsys):
    reg = str(tmp_path / "reg")
    with pytest.raises(tstore.LegacyRefused, match="TPU-era"):
        tstore.ingest_legacy(tstore.Registry(reg), str(REPO))
    assert tcompare.main(["--registry", reg, "ingest", "--legacy"]) == 2
    err = capsys.readouterr().err
    assert "ingest --legacy is refused" in err and "BENCH_r*.json" in err
    assert not os.path.exists(reg)


def test_registry_reads_equal_jax():
    treg, jreg = tstore.Registry(str(FROZEN)), jstore.Registry(str(FROZEN))
    assert treg.arms() == jreg.arms() and treg.index_lines() == jreg.index_lines()
    for arm in treg.arms():
        assert treg.records(arm) == jreg.records(arm)
        cand = treg.latest(arm)
        for kw in ({}, {"exclude_record_id": cand["record_id"]}, {"match_config_of": cand}):
            assert treg.baseline(arm, **kw) == jreg.baseline(arm, **kw)
            assert treg.history_values(arm, metric_name="tokens_per_sec", **kw) == \
                jreg.history_values(arm, metric_name="tokens_per_sec", **kw)
            for key, *_ in tstats.SECONDARY_METRICS:
                assert treg.result_history_values(arm, result_key=key, **kw) == \
                    jreg.result_history_values(arm, result_key=key, **kw)


ROW = {"strategy": "zero2", "world_size": 1, "rank": 0, "seq_len": 64, "tier": "S",
       "steps": 8, "per_device_batch": 1, "grad_accum": 2, "tokens_per_sec": 2000.0,
       "mean_step_time_sec": 0.06, "mean_loss": 5.5, "peak_vram_gb": 0.0,
       "h2d_gbps_per_gpu": 0.0, "attention_impl": "reference", "model_family": "tinygpt"}
NEVER_BASELINE = {
    "partial": ({"partial": True}, "partial", False),
    "resumed": ({"resumed": True, "n_restarts": 1}, "ok", False),
    "geometry_changed": ({"resume_geometry_changed": True}, "ok", False),
    "rolled_back": ({"n_rollbacks": 1, "rollback_steps_replayed": 2}, "ok", False),
    "supervised": ({"supervision": {"n_attempts": 2}}, "ok", False),
    "supervised_once": ({"supervision": {"n_attempts": 1}}, "ok", True),
    "banked": ({}, "ok", False),
    "clean": ({}, "ok", True),
}


@pytest.mark.parametrize("kind", sorted(NEVER_BASELINE))
def test_never_baseline_rules_equal_jax(tmp_path, kind):
    extra, status, eligible = NEVER_BASELINE[kind]
    picked = []
    for mod in (jstore, tstore):
        reg = mod.Registry(str(tmp_path / mod.__name__))
        clean, _ = reg.ingest(mod.make_record(arm="arm", result_row=ROW, source="a"))
        rec, _ = reg.ingest(mod.make_record(
            arm="arm", result_row=dict(ROW, tokens_per_sec=2100.0, **extra), status=status,
            source="b"))
        if kind == "banked":
            assert reg.bank(rec["record_id"], reason="test")
        base = reg.baseline("arm", match_config_of=clean)
        hist = reg.history_values("arm", metric_name="tokens_per_sec")
        picked.append((base["record_id"], hist))
        assert base["record_id"] == (rec if eligible else clean)["record_id"]
    assert picked[0] == picked[1]


def test_a_cpu_record_is_never_a_cuda_baseline(tmp_path):
    """``config_key`` stays JAX's, with no device axis; the port's baseline
    and noise floor also match the candidate's ``device_of``."""
    reg = tstore.Registry(str(tmp_path / "reg"))
    cpu_row = dict(ROW, backend="cpu", device_kind="cpu")
    gpu_row = dict(ROW, backend="cuda", device_kind="NVIDIA H100 80GB HBM3")
    cpu, _ = reg.ingest(tstore.make_record(arm="arm", result_row=cpu_row, source="cpu"))
    gpu, _ = reg.ingest(tstore.make_record(arm="arm", result_row=gpu_row, source="gpu"))
    assert tstore.config_key(cpu) == tstore.config_key(gpu)
    assert tstore.device_of(cpu) != tstore.device_of(gpu)
    kw = dict(exclude_record_id=gpu["record_id"], match_config_of=gpu)
    assert reg.baseline("arm", **kw) is None
    assert reg.history_values("arm", metric_name="tokens_per_sec", **kw) == []
    assert reg.result_history_values("arm", result_key="tokens_per_sec", **kw) == []
    assert "first record with this configuration" in tcompare.verdict_line_for_bench(reg, gpu)
    verdict, line = tcompare.gate_arm(reg, "arm")
    assert verdict == tstats.VERDICT_INSUFFICIENT and "no prior ok record" in line
    gpu2, _ = reg.ingest(tstore.make_record(
        arm="arm", result_row=dict(gpu_row, tokens_per_sec=2100.0), source="gpu2"))
    kw = dict(exclude_record_id=gpu2["record_id"], match_config_of=gpu2)
    assert reg.baseline("arm", **kw)["record_id"] == gpu["record_id"]
    assert reg.history_values("arm", metric_name="tokens_per_sec", **kw) == [2000.0]


# ---------------------------------------------------------------------------
# The CLI over the frozen registry, step by step through both packages
# ---------------------------------------------------------------------------

CLI_STEPS = (
    ("list", ["list"]),
    ("gate_aa", ["gate", "--all"]),
    ("compare_aa", ["compare", "last-good", "latest", "--arm", FROZEN_ARM]),
    ("ingest_slow", None),
    ("gate_regression", ["gate", "--arm", FROZEN_ARM]),
    ("gate_again", ["gate", "--all"]),
    ("compare_slow", ["compare", "e63efb7f", "latest", "--arm", FROZEN_ARM]),
    ("trend", ["trend", FROZEN_ARM, "--png", "PNG"]),
    ("trend_limit", ["trend", FROZEN_ARM, "--limit", "1"]),
    ("trend_unknown", ["trend", "no_such_arm"]),
    ("bisect", ["bisect", "e63efb7f", "latest", "--arm", FROZEN_ARM]),
    ("bank", ["bank", "e63efb7f"]),
    ("bank_again", ["bank", "e63efb7f"]),
    ("list_banked", ["list"]),
    ("unbank", ["unbank", "e63efb7f", "--reason", "re-measured"]),
    ("unbank_again", ["unbank", "e63efb7f"]),
    ("unknown_id", ["compare", "ffff", "latest", "--arm", FROZEN_ARM]),
    ("ambiguous_selector", ["compare", "latest", "latest"]),
    ("fresh_arm", ["gate", "--arm", "no_such_arm"]),
)


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("cli")
    slow = json.loads((FIXTURES / "registry_frozen_candidates" / "record_slow.json").read_text())
    out = {}
    for tag, cmp_mod, store_mod in (("jax", jcompare, jstore), ("port", tcompare, tstore)):
        root = str(base / tag / "reg")
        shutil.copytree(FROZEN, root)
        png = str(base / tag / "trend.png")
        for name, argv in CLI_STEPS:
            if argv is None:
                _, created = store_mod.Registry(root).ingest(slow)
                out.setdefault(name, {})[tag] = (created, "", "")
                continue
            argv = [png if a == "PNG" else a for a in argv]
            cap = _Capture()
            with cap:
                code = cmp_mod.main(["--registry", root] + argv)
            text = [t.replace(root, "REG").replace(png, "PNG") for t in cap.texts()]
            out.setdefault(name, {})[tag] = (code, *text)
        out.setdefault("png", {})[tag] = os.path.getsize(png) > 0
    return out


class _Capture:
    """stdout and stderr of one in-process CLI call."""

    def __enter__(self):
        import io

        self._saved = sys.stdout, sys.stderr
        sys.stdout, sys.stderr = self.out, self.err = io.StringIO(), io.StringIO()

    def __exit__(self, *exc):
        sys.stdout, sys.stderr = self._saved

    def texts(self):
        return self.out.getvalue(), self.err.getvalue()


@pytest.mark.parametrize("step", [name for name, _ in CLI_STEPS] + ["png"])
def test_cli_step_equals_jax(cli_runs, step):
    assert cli_runs[step]["port"] == cli_runs[step]["jax"]


def test_cli_verdicts(cli_runs):
    assert cli_runs["gate_aa"]["port"][0] == 0 and "NEUTRAL" in cli_runs["gate_aa"]["port"][1]
    code, out, _ = cli_runs["gate_regression"]["port"]
    line = next(x for x in out.splitlines() if "REGRESSION" in x)
    assert code == 1 and f"arm={FROZEN_ARM}" in line and "delta=-10.0" in line
    assert "CI95=[" in line
    assert cli_runs["trend_unknown"]["port"][0] == 2
    assert cli_runs["unknown_id"]["port"][0] == 2 == cli_runs["fresh_arm"]["port"][0]


@pytest.mark.parametrize("where", ["record", "registry"])
def test_schema_drift_is_refused_as_in_jax(tmp_path, where):
    future = json.loads((FIXTURES / "registry_frozen_candidates" / "record_future.json")
                        .read_text())
    outcomes = []
    for mod, cmp_mod in ((jstore, jcompare), (tstore, tcompare)):
        root = tmp_path / mod.__name__
        if where == "record":
            with pytest.raises(mod.SchemaDrift) as e:
                mod.Registry(str(root)).ingest(future)
            outcomes.append(str(e.value))
        else:
            root.mkdir()
            (root / "registry_meta.json").write_text('{"schema_version": 99}')
            cap = _Capture()
            with cap:
                code = cmp_mod.main(["--registry", str(root), "list"])
            outcomes.append((code, cap.texts()[1].replace(str(root), "REG")))
    assert outcomes[0] == outcomes[1]


# ---------------------------------------------------------------------------
# The bench's --regress / --registry
# ---------------------------------------------------------------------------

BENCH = [sys.executable, "-m", "distributed_llm_training_benchmark_framework_tpu_torch.bench",
         "--device", "cpu", "--tier", "S", "--seq-len", "64", "--steps", "3",
         "--warmup-steps", "1", "--flagship", "off", "--skip-preflight"]


def _bench(*extra):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "REGRESS_REGISTRY_TORCH"):
        env.pop(var, None)
    return subprocess.run(BENCH + list(extra), capture_output=True, text=True, cwd=REPO,
                          env=env, timeout=300)


def test_bench_records_and_gives_a_verdict_on_stderr(tmp_path, capsys):
    reg = str(tmp_path / "reg")
    proc = _bench("--regress", "on", "--registry", reg)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = proc.stdout.splitlines()
    assert len(lines) == 1
    payload = json.loads(lines[0])
    assert payload["metric"] == "tinygpt_tierS_seq64_tokens_per_sec_per_chip"
    assert "regress: recorded bench_tinygpt_tierS_seq64 " in proc.stderr
    assert "first record with this configuration" in proc.stderr
    # The next invocation of the same configuration (auto: the registry
    # exists now) is judged against that record.
    args = tbench.build_parser().parse_args(BENCH[3:] + ["--registry", reg])
    tbench.record_in_registry(args, dict(payload, value=payload["value"] * 0.5),
                              backend="cpu")
    err = capsys.readouterr().err
    assert "regress: recorded bench_tinygpt_tierS_seq64 " in err
    assert "vs last-good arm=bench_tinygpt_tierS_seq64" in err
    records = tstore.Registry(reg).records("bench_tinygpt_tierS_seq64")
    assert len(records) == 2
    for rec in records:
        res = rec["result"]
        assert (res["backend"], res["device_kind"], res["steps"], res["layer_loop"]) == \
            ("cpu", "cpu", 3, "unrolled")
        assert rec["env"]["torch_version"] and "jax_version" not in rec["env"]
    assert tstore.config_key(records[0]) == tstore.config_key(records[1])


def test_bench_auto_skips_without_a_registry(tmp_path, capsys):
    args = argparse.Namespace(regress="auto", registry=str(tmp_path / "none"), strategy="zero2",
                              tier="S", seq_len=64, steps=3, warmup_steps=1, sync_every=10,
                              model_family="tinygpt", per_device_batch=1, grad_accum=4)
    payload = {"metric": "tinygpt_tierS_seq64_tokens_per_sec_per_chip", "value": 1.0,
               "flagship": {"metric": "llama_tierS_seq64_tokens_per_sec_per_chip", "value": 2.0}}
    tbench.record_in_registry(args, payload, backend="cpu")
    assert "skipping ingest" in capsys.readouterr().err and not (tmp_path / "none").exists()
    rows = tbench.registry_rows(args, payload, backend="cuda")
    assert [source for source, _, _ in rows] == ["bench.py", "bench.py:flagship"]
    assert all(extra["backend"] == "cuda" for _, _, extra in rows)
    args.regress = "off"
    tbench.record_in_registry(args, payload)
    assert capsys.readouterr().err == ""
