"""The port's collective audit (``analysis/static/collective_audit.py``), its
budgets (``configs/collective_budgets_torch.json``), its CLI and the bench's
preflight, held against the JAX package's ``analysis/static/hlo_audit.py``:

- the roster is JAX's but the scan arm, spec for spec, and the pipeline
  arms are those of JAX's budgets file;
- the pipeline laws: the counted messages equal
  ``parallel.pipeline.expected_messages`` per direction, the bubble bounds
  equal JAX's ``pipeline_bubble_bound`` to 1e-6, and for gpipe and 1f1b at
  P 2 the pipeline's sends equal JAX's ``expected_pipeline_permutes``;
- the frozen budgets cover the roster, the world tiers obey the growth
  laws, and the memory tiers obey GC110's with no exception (each rank
  draws only its own rows' dropout masks, ``models/tinygpt.py``, so
  ``pp2-gpipe``'s temps stay flat along ``data``);
- a fresh audit of ``llama-tp2-gqa`` and of ``zero3-dp8`` (and of the
  pipeline arm ``pp2-1f1b``) equals its frozen entry;
- JAX's tier-scaling rule, growth laws and wording on the same inputs;
- each ``--inject`` seed bug exits 1 naming its arm, an unknown arm exits
  2, and no audit process initializes CUDA;
- the bench's preflight: a failing one exits 2 with nothing on stdout, and
  ``--skip-preflight`` skips it.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

from distributed_llm_training_benchmark_framework_tpu.analysis.static import hlo_audit as jaudit
from distributed_llm_training_benchmark_framework_tpu_torch import bench as tbench
from distributed_llm_training_benchmark_framework_tpu_torch.analysis.static import (
    __main__ as tcli,
)
from distributed_llm_training_benchmark_framework_tpu_torch.analysis.static import (
    collective_audit as audit,
)
from distributed_llm_training_benchmark_framework_tpu_torch.parallel.pipeline import (
    expected_messages,
)
from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
CLI = [sys.executable, "-m",
       "distributed_llm_training_benchmark_framework_tpu_torch.analysis.static"]


@pytest.fixture(scope="module")
def budgets():
    return audit.load_budgets()


def _env():
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT"):
        env.pop(var, None)
    return env


# ---------------------------------------------------------------------------
# The roster
# ---------------------------------------------------------------------------


def test_roster_is_jaxs_but_the_scan_arm():
    jax_roster = {n: s for n, s in jaudit.ROSTER.items() if n not in audit.NOT_AUDITED}
    assert list(audit.NOT_AUDITED) == ["llama-fsdp-dp4-tp2-scan"]
    assert list(audit.ROSTER) == list(jax_roster)
    for name, spec in audit.ROSTER.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(jax_roster[name]), name


def test_pipeline_arms_are_those_of_jaxs_budgets(budgets):
    jax_budgets = jaudit.load_budgets()
    assert set(audit.PIPELINE_ROSTER) == set(jax_budgets["pipeline_schedules"]["arms"])
    for name, spec in audit.PIPELINE_ROSTER.items():
        assert dataclasses.asdict(spec) == dataclasses.asdict(jaudit.PIPELINE_ROSTER[name])


def test_list_arms_prints_the_roster_and_the_pipeline_arms(capsys):
    assert tcli.main(["--list-arms"]) == 0
    out = capsys.readouterr().out.splitlines()
    roster = [ln.split(":")[0] for ln in out if not ln.startswith("[")]
    pipes = [ln.split()[1].rstrip(":") for ln in out if ln.startswith("[pipeline]")]
    assert roster == list(audit.ROSTER) and len(roster) == 9
    assert pipes == list(audit.PIPELINE_ROSTER) and len(pipes) == 4


# ---------------------------------------------------------------------------
# The pipeline laws
# ---------------------------------------------------------------------------


def test_frozen_pipeline_messages_and_bubbles_obey_the_laws(budgets):
    section = budgets["pipeline_schedules"]["arms"]
    for name, spec in audit.PIPELINE_ROSTER.items():
        meta = section[name]["schedule"]
        P, V = meta["stages"], meta["virtual"]
        for label, m in (("base", meta["microbatches"]), ("grown", meta["grown_microbatches"])):
            entry = section[name][label]
            want = expected_messages(spec.pipeline_schedule, P, m, V)
            assert entry["messages"] == {"fwd": want, "bwd": want}, (name, label)
            assert entry["collectives"]["send"] == 2 * want
            assert audit.pipeline_bubble_bound(spec.pipeline_schedule, P, m, V) == pytest.approx(
                jaudit.pipeline_bubble_bound(spec.pipeline_schedule, P, m, V), abs=1e-6)
            if spec.pipeline_schedule in ("gpipe", "1f1b") and P == 2:
                assert entry["collectives"]["send"] == jaudit.expected_pipeline_permutes(
                    spec.pipeline_schedule, P, m)
        assert meta["bubble_frac_bound"] == pytest.approx(
            jaudit.pipeline_bubble_bound(spec.pipeline_schedule, P, meta["microbatches"], V),
            abs=1e-6)


def test_a_fresh_pipeline_audit_equals_its_frozen_entry(budgets):
    result = audit.audit_pipeline_arm(audit.PIPELINE_ROSTER["pp2-1f1b"])
    assert result.compile_error is None, result.compile_error
    assert audit.pipeline_law_findings(result) == []
    assert audit.diff_pipeline_against_budget(result, budgets) == []


# ---------------------------------------------------------------------------
# The frozen budgets
# ---------------------------------------------------------------------------


def test_frozen_budgets_cover_the_roster_and_the_growth_laws(budgets):
    assert (budgets["backend"], budgets["world_size"]) == ("torch", 8)
    assert budgets["torch_version"]
    assert set(budgets["arms"]) == set(audit.ROSTER)
    assert set(budgets["memory_budgets"]["arms"]) == set(audit.ROSTER)
    assert set(budgets["world_tiers"]) == set(audit.TOPOLOGY_TIERS)
    for tier in budgets["world_tiers"].values():
        assert set(tier["arms"]) == set(audit.TOPOLOGY_ARMS)
    mem_tiers = budgets["memory_budgets"]["topology_tiers"]
    assert set(mem_tiers) == set(audit.TOPOLOGY_DEFAULT_TIERS)
    assert all(e["replication_reshard_suspects"] == 0 for e in budgets["arms"].values())
    assert "donated_inputs" not in budgets["arms"]["ddp-dp8"]
    assert audit.growth_law_findings(audit.assemble_per_tier(budgets)) == []
    per_tier, stale = audit.commensurable_memory_tiers(budgets)
    assert stale == []
    # No exception: pp2-gpipe's dropout masks no longer grow with data.
    assert audit.memory_growth_law_findings(per_tier) == []
    for arm, spec in audit.ROSTER.items():
        assert audit.arm_shards_state_over_data(arm) == (spec.strategy != "ddp"), arm


@pytest.mark.parametrize("arm", ["llama-tp2-gqa", "zero3-dp8"])
def test_a_fresh_audit_equals_its_frozen_entry(budgets, arm):
    report = audit.audit_arm(audit.ROSTER[arm])
    assert report.to_budget_entry() == budgets["arms"][arm]
    assert audit.diff_against_budget(report, budgets) == []
    memory = audit.audit_arm_memory(audit.ROSTER[arm])
    assert audit.diff_memory_against_budget(memory, budgets) == []
    assert memory.peak_bytes == memory.argument_bytes + memory.temp_bytes
    assert memory.estimate_bytes > 0


def test_update_budgets_round_trip_keeps_the_other_arms(budgets, tmp_path):
    path = str(tmp_path / "b.json")
    with open(path, "w") as f:
        json.dump(budgets, f)
    report = audit.ArmReport(**{**budgets["arms"]["zero3-dp8"], "arm": "zero3-dp8"})
    doc = audit.write_budgets([report], path, existing=audit.load_budgets(path))
    assert doc["arms"] == budgets["arms"]
    for section in ("pipeline_schedules", "memory_budgets", "world_tiers"):
        assert doc[section] == budgets[section]
    stale = dict(budgets, torch_version="0.0")
    with pytest.raises(ValueError, match="partial --arms regeneration"):
        audit.write_budgets([report], path, existing=stale)


# ---------------------------------------------------------------------------
# JAX's rules on the same inputs
# ---------------------------------------------------------------------------


def test_scale_spec_to_devices_is_jaxs():
    for name in audit.TOPOLOGY_ARMS:
        spec = audit.ROSTER.get(name) or audit.PIPELINE_ROSTER[name]
        jspec = jaudit.ROSTER.get(name) or jaudit.PIPELINE_ROSTER[name]
        for tier in audit.TOPOLOGY_TIERS.values():
            assert dataclasses.asdict(audit.scale_spec_to_devices(spec, tier.device_count)) \
                == dataclasses.asdict(jaudit.scale_spec_to_devices(jspec, tier.device_count))
    with pytest.raises(ValueError, match="does not divide"):
        audit.scale_spec_to_devices(audit.ROSTER["zero2-sp4-ring"], 6)


def test_growth_laws_and_wording_are_jaxs():
    names = dict(zip(audit.TOPOLOGY_TIERS, jaudit.TOPOLOGY_TIERS))  # world-16 -> v5e-16

    def entry(ag, ar, suspects=0):
        return {"collectives": {"all-gather": ag, "all-reduce": ar},
                "replication_reshard_suspects": suspects}

    per_tier = {"world-16": {"a": entry(2, 4), "b": entry(0, 3)},
                "world-64": {"a": entry(9, 4, 1), "b": entry(2, 3)}}
    port = audit.growth_law_findings(per_tier)
    jax = jaudit.growth_law_findings({names[t]: v for t, v in per_tier.items()})
    for t, j in names.items():
        port = [f.replace(t, j) for f in port]
    assert port == jax and len(port) == 3
    mem = {"world-16": {"zero3-dp8": {"temp_bytes": 100, "argument_bytes": 50}},
           "world-64": {"zero3-dp8": {"temp_bytes": 120, "argument_bytes": 50}}}
    port = audit.memory_growth_law_findings(mem)
    jax = jaudit.memory_growth_law_findings({names[t]: v for t, v in mem.items()})
    for t, j in names.items():
        port = [f.replace(t, j) for f in port]
    assert port == jax and len(port) == 2


def test_budget_diff_wording_is_jaxs(budgets):
    frozen = budgets["arms"]["zero3-dp8"]
    grown = dict(frozen["collectives"], **{"all-gather": frozen["collectives"]["all-gather"] + 2})
    report = audit.ArmReport(**{**frozen, "arm": "zero3-dp8", "collectives": grown})
    deltas = audit.diff_against_budget(report, budgets)
    n = frozen["collectives"]["all-gather"]
    assert f"zero3-dp8: all-gather REGRESSED {n} -> {n + 2} (+2 per step)" in deltas
    fewer = dict(frozen["collectives"], **{"all-reduce": frozen["collectives"]["all-reduce"] - 1})
    deltas = audit.diff_against_budget(
        audit.ArmReport(**{**frozen, "arm": "zero3-dp8", "collectives": fewer}), budgets)
    assert any("improved" in d and "bank it with --update-budgets" in d for d in deltas)
    assert audit.diff_against_budget(
        audit.ArmReport(**{**frozen, "arm": "nope"}), budgets)[0].startswith(
        "nope: no frozen budget for this arm")


# ---------------------------------------------------------------------------
# The CLI: the seed bugs, usage errors, no CUDA
# ---------------------------------------------------------------------------

INJECTIONS = {
    "bad-kv-spec": "llama-tp2-gqa",
    "bad-fsdp-axis": "llama-fsdp-dp4-tp2",
    "bad-forward-gather": "zero3-dp8",
    "bad-cmm-ring": "llama-tp2-gqa-cmm",
    "bad-pipeline-spec": "pp2-gpipe",
}


@pytest.fixture(scope="module")
def cli_runs():
    """Every CLI run of this module, started together (each a process of
    its own): {tag: CompletedProcess-like (returncode, stdout, stderr)}."""
    runs = {f"inject:{k}": ["--audit", "--inject", k, "--arms", a] for k, a in INJECTIONS.items()}
    runs["unknown-arm"] = ["--audit", "--arms", "no-such-arm"]
    runs["unknown-tier"] = ["--topology", "world-3"]
    procs = {tag: subprocess.Popen(CLI + args, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                   text=True, cwd=REPO, env=_env())
             for tag, args in runs.items()}
    out = {}
    for tag, proc in procs.items():
        stdout, stderr = proc.communicate(timeout=300)
        out[tag] = (proc.returncode, stdout, stderr)
    return out


@pytest.mark.parametrize("inject", sorted(INJECTIONS))
def test_each_injection_exits_1_naming_its_arm(cli_runs, inject):
    rc, _, stderr = cli_runs[f"inject:{inject}"]
    assert rc == 1, stderr[-3000:]
    assert f"{INJECTIONS[inject]}:" in stderr or f"{INJECTIONS[inject]} VIOLATES" in stderr
    assert "torch.cuda.is_initialized() = False" in stderr


@pytest.mark.parametrize("tag", ["unknown-arm", "unknown-tier"])
def test_usage_errors_exit_2(cli_runs, tag):
    rc, stdout, stderr = cli_runs[tag]
    assert rc == 2 and stdout == "", stderr[-2000:]
    assert "unknown" in stderr


def test_inject_cannot_be_frozen():
    with pytest.raises(SystemExit) as e:
        tcli.main(["--audit", "--inject", "bad-kv-spec", "--update-budgets"])
    assert e.value.code == 2


# ---------------------------------------------------------------------------
# The bench's preflight
# ---------------------------------------------------------------------------

BENCH_ARGS = ["--device", "cpu", "--tier", "S", "--seq-len", "64", "--steps", "2",
              "--warmup-steps", "1", "--flagship", "off"]
BAD_PREFLIGHT = ("--audit", "--inject", "bad-cmm-ring", "--arms", "llama-tp2-gqa-cmm")


def test_bench_preflight_is_jaxs_scope():
    assert tbench.PREFLIGHT_ARGS == ("--lint", "--audit", "--arms", "llama-tp2-gqa")
    assert tbench.build_parser().parse_args([]).skip_preflight is False


def test_a_failing_preflight_stops_the_bench_before_stdout(monkeypatch, capsys):
    monkeypatch.setattr(tbench, "PREFLIGHT_ARGS", BAD_PREFLIGHT)
    with pytest.raises(SystemExit) as e:
        tbench.main(BENCH_ARGS)
    assert e.value.code == 2
    out, err = capsys.readouterr()
    assert out == ""
    assert "graftcheck preflight FAILED" in err and "--skip-preflight" in err
    assert "llama-tp2-gqa-cmm:" in err


def test_skip_preflight_skips_it(monkeypatch, capsys):
    monkeypatch.setattr(tbench, "PREFLIGHT_ARGS", BAD_PREFLIGHT)
    (result,) = tbench.main(BENCH_ARGS + ["--skip-preflight"])
    out, err = capsys.readouterr()
    (line,) = [ln for ln in out.splitlines() if ln.strip()]
    assert json.loads(line)["metric"] == "tinygpt_tierS_seq64_tokens_per_sec_per_chip"
    assert "graftcheck" not in err
