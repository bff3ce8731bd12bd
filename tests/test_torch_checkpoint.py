"""The port's checkpoint / resume (``runtime/checkpoint.py``) on the CPU.

- one process: each recipe's straight 4 steps equal 2 steps + SIGTERM
  (its emergency save) + restore + 2 steps bit for bit in fp32, at dropout
  0 and 0.1 (bare AdamW, warmup + clip, serial and delayed offload, bf16
  parameters, the async save, whose save in flight the SIGTERM commits);
- over two gloo ranks (``tests/torch_ckpt_worker.py``): the same for every
  arm laid out over the group (DDP, FSDP2, zero2's buckets, offload's host
  state, bf16 parameters) and for zero2 over ``model``, ``pipe`` and
  ``expert`` shards, and the geometry change both ways (zero2 saved
  at world 2 restored by one process, and the reverse), with
  ``resume_geometry_changed`` on the row and the validator passing it;
- the async save under load, in one process and over two gloo ranks: a
  slowed write in flight while steps run and the next save starts, a
  SIGTERM whose emergency flush commits the save in flight, and a resume
  from that async-written step equal to the straight run bit for bit;
- the sidecars: digest, quarantine and fallback, the all-torn cold start,
  the restart ledger, with keys equal to JAX's frozen
  ``tests/fixtures/checkpoint_quarantine_frozen``; the ``layer_layout``
  refusal; a tier mismatch refused by name; a ``torn-checkpoint`` drill
  through the harness.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from distributed_llm_training_benchmark_framework_tpu.analysis import validate_results as jvalid
from distributed_llm_training_benchmark_framework_tpu_torch.faults import Preempted
from distributed_llm_training_benchmark_framework_tpu_torch.faults.injection import (
    _tear_newest_file,
)
from distributed_llm_training_benchmark_framework_tpu_torch.models import TinyGPT, get_config
from distributed_llm_training_benchmark_framework_tpu_torch.parallel.strategies import (
    get_strategy,
    make_optimizer,
)
from distributed_llm_training_benchmark_framework_tpu_torch.runtime.checkpoint import (
    BenchmarkCheckpointer,
    TrainState,
)
from distributed_llm_training_benchmark_framework_tpu_torch.train import run_benchmark
from distributed_llm_training_benchmark_framework_tpu_torch.train.step import TrainStep
from torch_threads import one_thread  # noqa: F401  (autouse)

sys.path.insert(0, os.path.dirname(__file__))
from torch_ckpt_worker import (  # noqa: E402
    ARMS,
    ASYNC_EVERY,
    ASYNC_STEPS,
    GROUP_ARMS,
    RUN,
    spawn_ranks,
    strategy,
    wait_ranks,
)

REPO = Path(__file__).resolve().parents[1]
FROZEN = REPO / "tests" / "fixtures" / "checkpoint_quarantine_frozen"


# Without a group every arm is its recipe on the plain model (fsdp is ddp's,
# zero3 zero2's), so one process runs each recipe and state once; the
# layouts over a group run below.
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("label", ("ddp", "zero2", "offload_serial", "offload_delayed", "bf16",
                                   "zero2_async"))
def test_resume_equals_the_straight_run_in_one_process(tmp_path, label, dropout):
    kw = dict(RUN, strategy=strategy(label.replace("_async", "")), per_device_batch=1,
              dropout=dropout, telemetry=False)
    straight, resumed = [], []
    run_benchmark(steps=4, loss_log=straight, **kw)
    # Sync: no periodic save, so the SIGTERM's emergency save writes step 1.
    # Async: step 1's periodic save is in flight, and the SIGTERM commits it.
    is_async = label.endswith("_async")
    ck = dict(checkpoint_dir=str(tmp_path), checkpoint_every=int(is_async),
              checkpoint_async=is_async)
    with pytest.raises(Preempted) as stop:
        run_benchmark(steps=4, loss_log=resumed, inject_fault="sigterm@1", **ck, **kw)
    assert (stop.value.step, stop.value.saved_step) == (1, 1)
    row = run_benchmark(steps=4, loss_log=resumed, resume=True, **ck, **kw)
    assert resumed == straight  # bit for bit
    assert (row.resumed, row.n_restarts, row.resume_step) == (True, 1, 1)
    assert row.resume_baseline_loss == pytest.approx(straight[1], abs=1e-6)
    kept = ["1", "2", "3"] if is_async else ["1", "3"]
    assert sorted(n for n in os.listdir(tmp_path) if n.isdigit()) == kept


@pytest.fixture(scope="module")
def group_runs(tmp_path_factory):
    """World 1 saves ``w1`` (zero2, per-device batch 2, 2 steps); two gloo
    ranks run the worker; world 1 then resumes the worker's ``w2``."""
    out = tmp_path_factory.mktemp("ckpt")
    kw = dict(RUN, strategy=strategy("zero2"), telemetry=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    w1_straight = []
    run_benchmark(steps=4, per_device_batch=2, loss_log=w1_straight, **kw)
    run_benchmark(steps=2, per_device_batch=2, checkpoint_dir=str(out / "w1"), **kw)
    wait_ranks(spawn_ranks(2, out))
    ranks = [json.loads((out / f"out.rank{r}.json").read_text()) for r in range(2)]
    from_w2 = []
    row = run_benchmark(steps=4, per_device_batch=2, loss_log=from_w2,
                        checkpoint_dir=str(out / "w2"), resume=True, results_dir=str(out / "r1"),
                        **kw)
    torch.set_num_threads(threads)
    return out, ranks, w1_straight, {"losses": from_w2, "row": row.to_dict()}


@pytest.mark.parametrize("label", ARMS + tuple(GROUP_ARMS))
def test_resume_equals_the_straight_run_over_two_ranks(group_runs, label):
    out, ranks, _, _ = group_runs
    for res in ranks:
        assert res[label]["resumed"] == res[label]["straight"], label  # bit for bit
        assert res[label]["row"]["resumed"] and res[label]["row"]["n_restarts"] == 1
    row = json.loads(next((out / f"res_{label}").glob("result_*.json")).read_text())
    assert row["world_size"] == 2 and row["resumed"] and not row["resume_geometry_changed"]
    for key, width in GROUP_ARMS.get(label, {}).items():
        assert row[key] == width, key
    assert jvalid.validate_result(row, label) == []


def test_geometry_change_both_ways(group_runs):
    out, ranks, w1_straight, from_w2 = group_runs
    world2 = ranks[0]["zero2"]["straight"]
    # Saved by one process, resumed over two ranks (and the reverse): the
    # same global batch, so the losses agree to fp32 summation order.
    assert ranks[0]["from_w1"]["losses"] == pytest.approx(world2[2:], rel=1e-5)
    assert from_w2["losses"] == pytest.approx(w1_straight[2:], rel=1e-5)
    for row in (ranks[0]["from_w1"]["row"], from_w2["row"]):
        assert row["resumed"] and row["resume_geometry_changed"] and row["n_restarts"] == 1
        assert jvalid.validate_result(row, "elastic") == []
    ledger = json.loads((out / "w2" / "restarts.json").read_text())
    assert ledger["n_geometry_changes"] == 1
    assert ledger["last_geometry_change"]["from_mesh_axes"]["data"] == 2
    assert ledger["last_geometry_change"]["to_mesh_axes"]["data"] == 1
    geom = json.loads((out / "w2" / "geometry_1.json").read_text())
    assert set(geom) == {"schema_version", "step", "mesh_axes", "world_size", "params",
                         "opt_state"}
    assert geom["world_size"] == 2
    wte = next(e for e in geom["params"] if e["path"] == "params/wte")
    assert wte == {"path": "params/wte", "shape": [512, 128], "dtype": "float32", "spec": None}


@pytest.fixture(scope="module")
def async_runs(tmp_path_factory):
    """The worker's async scenario in one process and over two gloo ranks,
    started together: {world: [each rank's result]}."""
    outs = {w: tmp_path_factory.mktemp(f"async{w}") for w in (1, 2)}
    procs = {w: spawn_ranks(w, out, ("async",)) for w, out in outs.items()}
    for w in procs:
        wait_ranks(procs[w], timeout=240)
    return {w: [json.loads((out / f"async.rank{r}.json").read_text()) for r in range(w)]
            for w, out in outs.items()}


@pytest.mark.parametrize("world", [1, 2])
def test_async_resume_after_sigterm_equals_the_straight_run(async_runs, world):
    stop = 5
    for res in async_runs[world]:
        saved = res["saved"]
        assert saved == 4  # the save in flight at step 5's boundary, committed by the flush
        assert len(res["first"]) == stop + 1
        assert res["first"][:saved + 1] + res["second"] == res["straight"]  # bit for bit
        assert len(res["straight"]) == ASYNC_STEPS
        row = res["row"]
        assert (row["resumed"], row["n_restarts"], row["resume_step"]) == (True, 1, saved)
        saves = [(e["step"], e["async"]) for e in res["events"]
                 if e["event"] == "checkpoint_saved"]
        assert saves == [(s, True) for s in range(ASYNC_EVERY, stop, ASYNC_EVERY)]
        flush = [e for e in res["events"] if e["event"] == "emergency_flush"]
        assert [(e["mode"], e["step"], e["committed_step"], e["steps_delta"]) for e in flush] == [
            ("async-delta", stop, saved, stop - saved)]
        aborted = [e for e in res["events"] if e["event"] == "run_aborted"]
        assert [e["reason"] for e in aborted] == ["preempted"]
    # The slowed rank: a step finished while a write was in flight.
    writes = async_runs[world][-1]["writes"]
    assert len(writes) == 2 and any(end > began for began, end in writes), writes


def _tiny_state(seed=0, family="tinygpt", tier="S"):
    cfg = get_config(family, tier, 64, dropout=0.1)
    model = TinyGPT(cfg)
    model.init_weights(torch.Generator().manual_seed(seed))
    opt = make_optimizer(get_strategy("zero2"), model.parameters())
    step = TrainStep(model, opt, grad_accum=1, micro_batch=1, seed=seed,
                     device=torch.device("cpu"))
    return TrainState(model, opt, step), model, opt, step


def _save_two(tmp_path):
    ck = BenchmarkCheckpointer(str(tmp_path))
    state, model, opt, _ = _tiny_state()
    opt.count = 7
    ck.save(1, state, meta={"last_loss": 5.1234})
    with torch.no_grad():
        model.wte.add_(1.0)
    ck.save(2, state, meta={"last_loss": 5.0})
    return ck


def test_digest_quarantine_fallback_and_ledger(tmp_path):
    ck = _save_two(tmp_path)
    digest = json.loads((tmp_path / "digest_1.json").read_text())
    frozen = json.loads((FROZEN / "digest_8.json").read_text())
    assert set(digest) == set(frozen) and set(digest["meta"]) == set(frozen["meta"])
    assert ck.validate_step(2) == ("ok", "digest verified")
    assert ck.step_meta(1) == {"last_loss": 5.1234}
    assert _tear_newest_file(ck.step_dir(2))
    assert ck.validate_step(2)[0] == "mismatch"
    state, model, opt, _ = _tiny_state(seed=1)
    assert ck.restore_latest(state) == 1  # fell back past the torn step
    _, ref, _, _ = _tiny_state()
    assert torch.equal(model.wte, ref.wte) and opt.count == 7
    note = json.loads((tmp_path / "quarantine" / "step_2" / "QUARANTINE.json").read_text())
    assert set(note) == set(json.loads((FROZEN / "QUARANTINE.json").read_text()))
    assert note["step"] == 2 and note["reason"].startswith("mismatch")
    assert (tmp_path / "quarantine" / "step_2" / "digest_2.json").exists()
    assert ck.all_steps() == [1]
    assert (ck.note_restart(), ck.note_restart(geometry_changed=False)) == (1, 2)
    assert ck.n_restarts() == 2 and ck.n_geometry_changes() == 0
    _tear_newest_file(ck.step_dir(1))
    assert ck.restore_latest(state) is None  # all torn: a cold start
    assert ck.all_steps() == [] and (tmp_path / "quarantine" / "step_1").exists()
    with pytest.raises(FileNotFoundError):
        ck.restore(state, step=5)


def test_layer_layout_and_tier_mismatch_are_refused(tmp_path):
    _save_two(tmp_path)
    state, _, _, _ = _tiny_state()
    other = BenchmarkCheckpointer(str(tmp_path), layout={"layer_layout": "interleaved:pp=2:v=2"})
    with pytest.raises(ValueError, match="parameter layout"):
        other.restore(state)
    with pytest.raises(ValueError, match="refusing to mix layouts"):
        other.save(3, state)
    geo = BenchmarkCheckpointer(str(tmp_path), geometry={"mesh_axes": {"data": 1},
                                                         "world_size": 1})
    geo.save(3, state)
    with torch.device("meta"):
        big = TinyGPT(get_config("tinygpt", "A", 64))
    tier_a = TrainState(big, make_optimizer(get_strategy("zero2"), big.parameters()))
    with pytest.raises(ValueError, match=r"params/blocks/bfc/0: saved shape \[512\] != this "
                                         r"run's \[4096\]"):
        geo.restore(tier_a)
    llama, _, _, _ = _tiny_state(family="llama")
    with pytest.raises(ValueError, match="does not fit this run's state"):
        geo.restore(llama)


def test_torn_checkpoint_drill_through_the_harness(tmp_path):
    cmd = [sys.executable, "-m", "distributed_llm_training_benchmark_framework_tpu_torch"
           ".train.harness", "--device", "cpu", "--strategy", "zero2", "--world-size", "1",
           "--tier", "S", "--seq-len", "64", "--per-device-batch", "1", "--grad-accum", "2",
           "--steps", "8", "--warmup-steps", "1", "--results-dir", str(tmp_path / "r"),
           "--checkpoint-dir", str(tmp_path / "c"), "--checkpoint-every", "2"]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("INJECT_FAULT", None)
    torn = subprocess.run(cmd + ["--inject-fault", "torn-checkpoint"], capture_output=True,
                          text=True, timeout=120, cwd=REPO, env=env)
    assert torn.returncode == -9, torn.stderr[-2000:]
    resumed = subprocess.run(cmd + ["--resume"], capture_output=True, text=True, timeout=120,
                             cwd=REPO, env=env)
    assert resumed.returncode == 0, resumed.stderr[-2000:]
    assert "checkpoint step 4 failed validation" in resumed.stdout
    assert (tmp_path / "c" / "quarantine" / "step_4" / "QUARANTINE.json").exists()
    path = tmp_path / "r" / "result_zero2_ws1_seq64_tierS.json"
    row = json.loads(path.read_text())
    assert (row["resumed"], row["resume_step"], row["n_restarts"]) == (True, 2, 1)
    assert jvalid.validate_result(row, "torn") == []
    assert jvalid.validate_telemetry(str(path), row, "torn") == []
