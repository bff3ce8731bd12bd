"""The port's numerics sentinel and its rollback against the JAX package's.

- ``faults/sentinel.py``: JAX's guard cases (``tests/test_self_healing.py``)
  run through both packages' ``NumericsSentinel``: the same trips, ledger,
  events and prints, the rollback bound included;
- the guard values on bridged tier-S weights and one batch, in fp32: the
  step's grad norm against JAX's ``global_norm_f32`` of the averaged
  gradients and the parameter checksum against ``make_param_norm_fn``
  (rtol 1e-5), in one process per arm and over two gloo ranks under ddp,
  FSDP2 and zero2 (``tests/torch_sentinel_worker.py``);
- the corruption hooks: ``bitflip`` / ``grad-explode`` write the leaf and
  element JAX's injector writes (the poisoned trees equal, bit for bit),
  on one rank or the shard's owner; ``opt-moments`` scales every moment as
  JAX's does, or says it is inert;
- end to end at tier S: bitflip heals with one rollback and no saved step
  holds the poison, grad-explode heals through the loss envelope,
  opt-moments trips the grad-norm guard first, a run with no checkpoint
  heals from the in-memory snapshot, an unhealable trip fails loudly (exit
  1 through the harness), both ranks of a group roll back at the same step;
  the rows pass JAX's ``validate_results``.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distributed_llm_training_benchmark_framework_tpu.analysis import validate_results as jvalid
from distributed_llm_training_benchmark_framework_tpu.data.synthetic import (
    SyntheticDataset as JaxSyntheticDataset,
)
from distributed_llm_training_benchmark_framework_tpu.faults import injection as jinj
from distributed_llm_training_benchmark_framework_tpu.faults import sentinel as jsent
from distributed_llm_training_benchmark_framework_tpu.models import llama as jllama
from distributed_llm_training_benchmark_framework_tpu.models import tinygpt as jtiny
from distributed_llm_training_benchmark_framework_tpu.parallel import make_mesh as jmake_mesh
from distributed_llm_training_benchmark_framework_tpu.parallel import strategies as jstrat
from distributed_llm_training_benchmark_framework_tpu.train.step import (
    global_norm_f32,
    make_param_norm_fn,
)
from distributed_llm_training_benchmark_framework_tpu_torch import bridge
from distributed_llm_training_benchmark_framework_tpu_torch.faults import injection as tinj
from distributed_llm_training_benchmark_framework_tpu_torch.faults import sentinel as tsent
from distributed_llm_training_benchmark_framework_tpu_torch.faults import SentinelTripped
from distributed_llm_training_benchmark_framework_tpu_torch.models import TinyGPT, get_config
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import strategies as tstrat
from distributed_llm_training_benchmark_framework_tpu_torch.runtime.checkpoint import (
    BenchmarkCheckpointer,
    TrainState,
)
from distributed_llm_training_benchmark_framework_tpu_torch.telemetry import read_events
from distributed_llm_training_benchmark_framework_tpu_torch.train import loop as tloop
from distributed_llm_training_benchmark_framework_tpu_torch.train import run_benchmark
from distributed_llm_training_benchmark_framework_tpu_torch.train.step import TrainStep
from torch_threads import one_thread  # noqa: F401  (autouse)

sys.path.insert(0, os.path.dirname(__file__))
import torch_sentinel_worker as worker  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
CPU = torch.device("cpu")
S = 64
JAX_CONFIG = {"tinygpt": jtiny.get_model_config, "llama": jllama.get_llama_config}
# Tier S through run_benchmark, fenced every 2 steps (the validator's
# step-time CV envelope holds per-step-synced rows to device stability).
SMALL = dict(tier="S", seq_len=32, warmup_steps=2, device="cpu", sync_every=2,
             per_device_batch=1, grad_accum=1, heartbeat_sec=0)
ARM = "zero2_ws1_seq32_tierS"


# -- the guards: JAX's cases through both sentinels ----------------------------


class _Rec:
    def __init__(self):
        self.events = []

    def note(self, event, **fields):
        self.events.append((event, fields))


def _warm(s, n=6, loss=5.5, gnorm=1.0):
    return [s.observe(i, loss, gnorm) for i in range(n)]


def _descent(s):
    loss, out = 5.6, []
    for i in range(100):
        out.append(s.observe(i, loss, 1.0 + 0.01 * (i % 7)))
        loss = max(1.0, loss - 0.05)
    return out


def _ledger(s):
    out = _warm(s) + [s.observe(6, float("nan")), s.rollback_allowed]
    s.note_rollback(from_step=6, to_step=4)
    out += [s.trip, s.observe(8, float("nan")), s.rollback_allowed]
    s.note_rollback(from_step=8, to_step=4)
    return out + [s.rollback_allowed, s._last_pnorm]


CASES = {
    "nan_loss": lambda s: _warm(s) + [s.observe(6, float("nan")), s.observe(7, float("nan"))],
    "loss_spike": lambda s: _warm(s) + [s.observe(6, 50.0)],
    "loss_collapse": lambda s: _warm(s) + [s.observe(6, 0.01)],
    "descent": _descent,
    "grad_explode": lambda s: _warm(s) + [s.observe(6, 5.5, 1.0 * jsent.GRAD_SPIKE_FACTOR * 2)],
    "grad_nonfinite": lambda s: _warm(s) + [s.observe(6, 5.5, float("inf"))],
    "checksum_sdc": lambda s: [s.observe_param_checksum(4, 28.7),
                               s.observe_param_checksum(8, 28.9),
                               s.observe_param_checksum(12, 7242.0)],
    "checksum_inf": lambda s: [s.observe_param_checksum(4, 28.7),
                               s.observe_param_checksum(8, float("inf"))],
    "rollback_bound": _ledger,
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_guards_match_jax(case, capsys):
    kw = {"max_rollbacks": 2} if case == "rollback_bound" else {}
    runs = []
    for mod in (jsent, tsent):
        rec = _Rec()
        s = mod.NumericsSentinel(recorder=rec, **kw)
        out = CASES[case](s)
        runs.append((out, rec.events, capsys.readouterr().out,
                     (s.n_trips, s.n_rollbacks, s.rollback_steps_replayed, s.data_reseeds)))
    assert runs[0] == runs[1]
    assert any(runs[0][0]) or case == "descent"


def test_constants_match_jax():
    for name in ("LOSS_ENVELOPE_NATS", "LOSS_SPIKE_FACTOR", "GRAD_SPIKE_FACTOR",
                 "PARAM_NORM_JUMP_FRAC", "MIN_HISTORY", "WINDOW", "MAX_ROLLBACKS"):
        assert getattr(tsent, name) == getattr(jsent, name), name
    for name in ("BITFLIP_VALUE", "GRAD_EXPLODE_SCALE", "MOMENT_COLLAPSE_SCALE",
                 "MOMENT_BURST_SCALE"):
        assert getattr(tinj, name) == getattr(jinj, name), name
    err = SentinelTripped("sdc", 7, "why")
    assert str(err) == str(jsent.SentinelTripped("sdc", 7, "why")) and err.step == 7


# -- the guard values against JAX ----------------------------------------------


def _jax_params(family="tinygpt"):
    jc = JAX_CONFIG[family]("S", S, dropout=0.0, compute_dtype=jnp.float32,
                            attention_impl="flash")
    return jc, jtiny.init_params(jc, jax.random.key(0))


ACCUM, GLOBAL_MICRO = 2, 2  # one process: micro 2; two ranks: micro 1 each


@pytest.fixture(scope="module")
def jax_ref():
    """JAX's step 0 on the global batch of the bridged tier-S weights:
    (config, params, table, averaged grads)."""
    jc, params = _jax_params()
    table = JaxSyntheticDataset(jc.vocab_size, S, size=10, seed=42).data
    grad_fn = jax.jit(jax.value_and_grad(lambda p, b: jtiny.loss_fn(jc, p, b, b)))
    rows = np.arange(ACCUM * GLOBAL_MICRO) % table.shape[0]
    batch = jnp.asarray(table[rows].reshape(ACCUM, GLOBAL_MICRO, S))
    grads = jax.tree.map(jnp.zeros_like, params)
    for j in range(ACCUM):
        grads = jax.tree.map(jnp.add, grads, grad_fn(params, batch[j])[1])
    return jc, params, table, jax.tree.map(lambda g: g / ACCUM, grads)


def _jax_after(params, grads, strategy):
    """The params after JAX's update of ``grads`` under ``strategy``."""
    tx = jstrat.make_optimizer(strategy)
    updates, _ = tx.update(grads, tx.init(params), params)
    return optax.apply_updates(params, updates)


def _jax_checksum(params):
    return float(make_param_norm_fn(jmake_mesh((1,), ("data",), jax.devices()[:1]))(params))


ONE_PROCESS = {"ddp": dict(arm="ddp"), "zero2": dict(arm="zero2"),
               "no_clip": dict(arm="zero2", grad_clip=None)}


@pytest.mark.parametrize("label", sorted(ONE_PROCESS))
def test_grad_norm_and_checksum_match_jax_in_one_process(jax_ref, label):
    spec = dict(ONE_PROCESS[label])
    arm = spec.pop("arm")
    strat = dataclasses.replace(tstrat.get_strategy(arm), precision="f32", **spec)
    jc, params, table, grads = jax_ref
    after = _jax_after(params, grads, jstrat.StrategyConfig(
        **{f.name: getattr(strat, f.name) for f in dataclasses.fields(jstrat.StrategyConfig)
           if hasattr(strat, f.name)}))
    model = TinyGPT(get_config("tinygpt", "S", S, dropout=0.0, compute_dtype=torch.float32,
                               attention_impl="flash"))
    bridge.load_jax_params(model, jax.tree.map(np.asarray, params))
    step_fn = TrainStep(model, tstrat.make_optimizer(strat, model.parameters()),
                        grad_accum=ACCUM, micro_batch=GLOBAL_MICRO, seed=0, device=CPU,
                        sentinel=True)
    np.testing.assert_allclose(float(step_fn.param_checksum()), _jax_checksum(params),
                               rtol=1e-5)
    step_fn(torch.from_numpy(table.astype(np.int64)), 0)
    g_norm = step_fn.optimizer.grad_norm
    assert g_norm.dtype == torch.float32 and g_norm.dim() == 0
    np.testing.assert_allclose(float(g_norm), float(global_norm_f32(grads)),
                               rtol=1e-5)
    np.testing.assert_allclose(float(step_fn.param_checksum()), _jax_checksum(after),
                               rtol=1e-5)


def test_bf16_grads_take_one_fp32_pass_like_global_norm_f32():
    """bf16 parameters: the clip's norm is bf16, the sentinel's is the fp32
    norm of the same bf16 gradients (JAX's ``global_norm_f32``)."""
    strat = dataclasses.replace(tstrat.get_strategy("zero2"), precision="f32",
                                param_dtype="bf16")
    model = TinyGPT(get_config("tinygpt", "S", S, dropout=0.0, compute_dtype=torch.float32,
                               param_dtype=torch.bfloat16, attention_impl="flash"))
    model.init_weights(torch.Generator().manual_seed(0))
    opt = tstrat.make_optimizer(strat, model.parameters())
    step_fn = TrainStep(model, opt, grad_accum=2, micro_batch=1, seed=0, device=CPU,
                        sentinel=True)
    table = torch.randint(0, model.config.vocab_size, (4, S), generator=torch.Generator()
                          .manual_seed(1))
    step_fn.accumulate(table, 0)
    grads = {str(i): jnp.asarray(p.grad.float().numpy()).astype(jnp.bfloat16)
             for i, p in enumerate(model.parameters())}
    opt.step()
    assert opt._clip_norm().dtype == torch.bfloat16
    np.testing.assert_allclose(float(opt.grad_norm), float(global_norm_f32(grads)), rtol=1e-5)


def test_pipelined_steps_return_no_grad_norm():
    class _Pipe:  # only its presence matters to the flag
        pass

    model = TinyGPT(get_config("tinygpt", "S", S))
    opt = tstrat.make_optimizer(tstrat.get_strategy("zero2"), model.parameters())
    TrainStep(model, opt, grad_accum=1, micro_batch=1, seed=0, device=CPU, sentinel=True,
              pipeline=_Pipe())
    assert opt.track_grad_norm is False


# -- the corruption hooks against JAX's ------------------------------------------


def _poisoned_pair(family, kind):
    jc, params = _jax_params(family)
    want = jinj.FaultInjector(jinj.parse_fault_spec(f"{kind}@3"), is_main=False) \
        .corrupt_params(3, params)
    model = TinyGPT(get_config(family, "S", S, dropout=0.0, compute_dtype=torch.float32,
                               attention_impl="flash"))
    bridge.load_jax_params(model, jax.tree.map(np.asarray, params))
    chaos = tinj.FaultInjector(tinj.parse_fault_spec(f"{kind}@3"), is_main=False)
    chaos.corrupt_params(2, model)
    assert not chaos.fired  # not its step
    chaos.corrupt_params(3, model)
    return jax.tree.map(np.asarray, want), bridge.export_params(model)


@pytest.mark.parametrize("kind", ["bitflip", "grad-explode"])
@pytest.mark.parametrize("family", ["tinygpt", "llama"])
def test_corruption_hooks_write_jax_leaf_and_element(family, kind):
    want, got = _poisoned_pair(family, kind)
    flat_w, flat_g = jax.tree_util.tree_flatten_with_path(want)[0], jax.tree.leaves(got)
    changed = 0
    for (path, w), g in zip(flat_w, flat_g):
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(path))
        changed += int((w == tinj.BITFLIP_VALUE).sum())
    assert changed == (1 if kind == "bitflip" else 0)


@pytest.mark.parametrize("where", ["device", "offload"])
def test_opt_moments_scales_every_moment_like_jax(where):
    strat = dataclasses.replace(tstrat.get_strategy("zero2"), precision="f32",
                                offload_opt_state=where == "offload")
    model = TinyGPT(get_config("tinygpt", "S", S, dropout=0.0))
    model.init_weights(torch.Generator().manual_seed(0))
    opt = tstrat.make_optimizer(strat, model.parameters())
    step_fn = TrainStep(model, opt, grad_accum=1, micro_batch=1, seed=0, device=CPU)
    adamw = opt.host.adamw if opt.host is not None else opt.adamw
    inert = tinj.FaultInjector(tinj.parse_fault_spec("opt-moments@0"), is_main=False)
    rec = _Rec()
    inert.recorder = rec
    if where == "device":  # AdamW makes its state at the first step: nothing yet
        inert.corrupt_opt_state(0, opt)
        assert "fault inert" in rec.events[0][1]["detail"]
    table = torch.randint(0, 512, (4, S), generator=torch.Generator().manual_seed(1))
    step_fn(table, 0)
    before = [{k: v.clone() for k, v in st.items()} for st in adamw.state.values()]
    tinj.FaultInjector(tinj.parse_fault_spec("opt-moments@1"), is_main=False) \
        .corrupt_opt_state(1, opt)
    for st, old in zip(adamw.state.values(), before):
        assert torch.equal(st["exp_avg_sq"], old["exp_avg_sq"] * tinj.MOMENT_COLLAPSE_SCALE)
        assert torch.equal(st["exp_avg"], old["exp_avg"] * tinj.MOMENT_BURST_SCALE)
        assert torch.equal(st["step"], old["step"])
    # JAX's hook scales optax's mu / nu fields by the same constants.
    jc, params = _jax_params()
    tx = jstrat.make_optimizer(jstrat.get_strategy("zero2"))
    state = tx.init(params)
    ones = jax.tree.map(jnp.ones_like, params)
    state = tx.update(ones, state, params)[1]
    poisoned = jinj.FaultInjector(jinj.parse_fault_spec("opt-moments@1"), is_main=False) \
        .corrupt_opt_state(1, state)
    for field, scale in (("nu", tinj.MOMENT_COLLAPSE_SCALE), ("mu", tinj.MOMENT_BURST_SCALE)):
        pairs = list(zip(_moments(state, field), _moments(poisoned, field)))
        assert pairs, field
        for a, b in pairs:
            np.testing.assert_array_equal(b, a * jnp.float32(scale))


def _moments(tree, field):
    return [leaf for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]
            if any(getattr(e, "name", None) == field for e in path)]


# -- two gloo ranks ----------------------------------------------------------------


@pytest.fixture(scope="module")
def group(tmp_path_factory, jax_ref):
    """Both ranks of ``tests/torch_sentinel_worker.py`` and JAX's values on
    the same weights and global batch (per-device batch 1 x 2 ranks)."""
    assert (worker.ACCUM, 2 * worker.MICRO) == (ACCUM, GLOBAL_MICRO)
    out = tmp_path_factory.mktemp("sentinel_group")
    jc, params, table, grads = jax_ref
    inputs = out / "inputs.npz"
    flat = {k: np.asarray(v) for k, v in params.items() if k != "blocks"}
    flat.update({f"blocks.{k}": np.asarray(v) for k, v in params["blocks"].items()})
    np.savez(inputs, table=table, **flat)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT",
                "INJECT_FAULT"):
        env.pop(var, None)
    procs = [subprocess.Popen([sys.executable, worker.__file__, str(r), "2", str(port),
                               str(inputs), str(out / "out")], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in range(2)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-3000:]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = [json.loads((out / f"out.rank{r}.json").read_text()) for r in range(2)]
    arrays = np.load(out / "out.rank0.npz")
    return params, grads, ranks, arrays, out


@pytest.mark.parametrize("arm", worker.ARMS)
def test_norms_over_two_ranks_match_jax(group, arm):
    params, grads, ranks, _arrays, _out = group
    after = _jax_after(params, grads, jstrat.get_strategy(arm))
    want = {"checksum_before": _jax_checksum(params), "grad_norm": float(global_norm_f32(grads)),
            "checksum_after": _jax_checksum(after)}
    for res in ranks:
        for key, value in want.items():
            np.testing.assert_allclose(res["norms"][arm][key], value, rtol=1e-5, err_msg=key)
    # Every rank reads the same all-reduced floats: the guards agree.
    assert [{k: r["norms"][arm][k] for k in want} for r in ranks][0] == \
        {k: ranks[1]["norms"][arm][k] for k in want}


@pytest.mark.parametrize("kind", ["bitflip", "grad-explode"])
@pytest.mark.parametrize("arm", worker.ARMS)
def test_corruption_over_two_ranks_writes_jax_element_once(group, arm, kind):
    params, _grads, ranks, arrays, _out = group
    want = jinj.FaultInjector(jinj.parse_fault_spec(f"{kind}@0"), is_main=False) \
        .corrupt_params(0, params)
    flat = {k: np.asarray(v) for k, v in want.items() if k != "blocks"}
    flat.update({f"blocks.{k}": np.asarray(v) for k, v in want["blocks"].items()})
    for key, value in flat.items():
        np.testing.assert_array_equal(arrays[f"{arm}.{kind}.{key}"], value, err_msg=key)
    changed = [res["norms"][arm][f"{kind}_changed_here"] for res in ranks]
    if kind == "bitflip":
        # FSDP2 shards the leaf: its owner alone writes the element; ddp and
        # zero2 hold replicas, each written as JAX writes its global array.
        assert changed == ([1, 0] if arm == "fsdp" else [1, 1])
    else:
        assert all(n > 0 for n in changed)


@pytest.mark.parametrize("arm", worker.HEAL_ARMS)
def test_both_ranks_roll_back_at_the_same_step(group, arm):
    _params, _grads, ranks, _arrays, out = group
    rows = [res["heal"][arm]["row"] for res in ranks]
    assert [r["n_rollbacks"] for r in rows] == [1, 1]
    events = [res["heal"][arm]["events"] for res in ranks]
    strip = [[{k: v for k, v in e.items() if k not in ("ts", "rel", "rank")} for e in ev]
             for ev in events]
    assert strip[0] == strip[1] and [e["event"] for e in strip[0]] == ["sentinel_trip",
                                                                       "rollback"]
    assert rows[0]["rollback_steps_replayed"] == rows[1]["rollback_steps_replayed"] >= 1
    row = json.loads(next((out / f"heal_{arm}").glob("result_*.json")).read_text())
    assert jvalid.validate_result(row, arm) == []


# -- end to end at tier S -------------------------------------------------------------


def _events(results):
    return read_events(str(Path(results) / f"telemetry_{ARM}.jsonl"))


def _trips(results):
    return [(e["kind"], e["step"]) for e in _events(results) if e["event"] == "sentinel_trip"]


@pytest.fixture(scope="module")
def heals(tmp_path_factory):
    out = tmp_path_factory.mktemp("heals")
    runs = {}
    for name, kw in {
        "bitflip": dict(checkpoint_dir=str(out / "ck_bitflip"), checkpoint_every=4,
                        sentinel_checksum_every=4, inject_fault="bitflip@9"),
        "grad_explode": dict(checkpoint_dir=str(out / "ck_explode"), checkpoint_every=4,
                             inject_fault="grad-explode@9"),
        "opt_moments": dict(checkpoint_dir=str(out / "ck_moments"), checkpoint_every=4,
                            inject_fault="opt-moments@9"),
        "snapshot": dict(inject_fault="grad-explode@9"),
    }.items():
        log = {}
        row = run_benchmark(steps=14, sentinel=True, results_dir=str(out / name),
                            runtime_log=log, **kw, **SMALL)
        runs[name] = (row, log)
    return out, runs


def test_bitflip_heals_and_no_saved_step_holds_the_poison(heals):
    out, runs = heals
    row, log = runs["bitflip"]
    assert (row.n_rollbacks, row.resumed) == (1, False) and row.rollback_steps_replayed >= 1
    assert _trips(out / "bitflip")[0][0] == "sdc"
    rb = [e for e in _events(out / "bitflip") if e["event"] == "rollback"]
    assert len(rb) == 1 and rb[0]["data_reseeds"] == 1
    assert log["checksum_ms"] and len(log["restore_wall_ms"]) == 1
    ckpt = BenchmarkCheckpointer(str(out / "ck_bitflip"))
    assert ckpt.all_steps()
    for step in ckpt.all_steps():
        model = TinyGPT(get_config("tinygpt", "S", 32))
        opt = tstrat.make_optimizer(tstrat.get_strategy("zero2"), model.parameters())
        state = TrainState(model, opt, TrainStep(model, opt, grad_accum=1, micro_batch=1,
                                                 seed=0, device=CPU))
        assert ckpt.validate_step(step)[0] == "ok"
        ckpt.restore(state, step)
        assert max(p.abs().max().item() for p in model.parameters()) < 1e3, step
    path = out / "bitflip" / f"result_{ARM}.json"
    assert jvalid.validate_result(row.to_dict(), "bitflip") == []
    assert jvalid.validate_telemetry(str(path), json.loads(path.read_text()), "bitflip") == []


def test_grad_explode_heals_through_the_envelope(heals):
    out, runs = heals
    row, _ = runs["grad_explode"]
    assert row.n_rollbacks == 1 and row.rollback_steps_replayed >= 1
    kinds = [k for k, _ in _trips(out / "grad_explode")]
    assert kinds and kinds[0] in ("loss_collapse", "loss_spike", "grad_explode"), kinds
    assert jvalid.validate_result(row.to_dict(), "grad_explode") == []


def test_opt_moments_trips_the_grad_norm_guard_first(heals):
    out, runs = heals
    row, _ = runs["opt_moments"]
    assert row.n_rollbacks == 1
    # The corrupted step's own loss and grads are healthy: the next step's
    # grad norm is the first symptom.
    assert _trips(out / "opt_moments")[0] == ("grad_explode", 10)
    faults = [e for e in _events(out / "opt_moments") if e["event"] == "fault_injected"]
    assert "collapsing" in faults[0]["detail"]


def test_a_run_without_checkpoints_heals_from_the_snapshot(heals):
    out, runs = heals
    row, log = runs["snapshot"]
    assert row.n_rollbacks == 1 and row.rollback_steps_replayed >= 9
    rb = [e for e in _events(out / "snapshot") if e["event"] == "rollback"]
    assert len(rb) == 1 and rb[0]["to_step"] == -1
    restored = [e for e in _events(out / "snapshot") if e["event"] == "checkpoint_restored"]
    assert restored[0]["source"] == "memory" and log["restore_wall_ms"]
    assert (out / "snapshot" / f"result_{ARM}.json").exists()


def test_replayed_synthetic_steps_draw_fresh_rows_and_masks(tmp_path):
    """After a rollback the synthetic path folds the replay count into the
    row index and reseeds both generators: the replay's losses differ
    from the first pass's at dropout 0.1."""
    straight, healed = [], []
    run_benchmark(steps=8, dropout=0.1, loss_log=straight, telemetry=False, **SMALL)
    row = run_benchmark(steps=8, dropout=0.1, loss_log=healed, sentinel=True, telemetry=False,
                        checkpoint_dir=str(tmp_path), checkpoint_every=2,
                        inject_fault="grad-explode@4", **SMALL)
    assert row.n_rollbacks == 1 and len(healed) == len(straight) == 8
    # Restored at step 2: the steps before it are the straight run's.
    assert healed[:3] == straight[:3] and all(a != b for a, b in zip(healed[3:], straight[3:]))


def test_max_rollbacks_spent_fails_loudly(tmp_path, monkeypatch):
    class NoHeal(tsent.NumericsSentinel):
        @property
        def rollback_allowed(self):
            return False

    monkeypatch.setattr(tloop, "NumericsSentinel", NoHeal)
    with pytest.raises(SentinelTripped, match="rollback"):
        run_benchmark(steps=14, sentinel=True, results_dir=str(tmp_path),
                      inject_fault="grad-explode@9", **SMALL)
    assert not (tmp_path / f"result_{ARM}.json").exists()


def _harness(args):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    env.pop("INJECT_FAULT", None)
    cmd = [sys.executable, "-m", "distributed_llm_training_benchmark_framework_tpu_torch.train"
           ".harness", "--device", "cpu", "--strategy", "zero2", "--world-size", "1", "--tier",
           "S", "--seq-len", "32", "--per-device-batch", "1", "--grad-accum", "1",
           "--warmup-steps", "2", "--sync-every", "2", "--heartbeat-sec", "0"]
    return subprocess.run(cmd + args, capture_output=True, text=True, timeout=180, cwd=REPO,
                          env=env)


def test_harness_heals_a_bitflip_and_refuses_an_unhealable_trip(tmp_path):
    ok = _harness(["--steps", "12", "--results-dir", str(tmp_path / "r"), "--checkpoint-dir",
                   str(tmp_path / "ck"), "--checkpoint-every", "4", "--sentinel", "on",
                   "--sentinel-checksum-every", "4", "--inject-fault", "bitflip@7"])
    assert ok.returncode == 0, ok.stderr[-3000:]
    row = json.loads((tmp_path / "r" / f"result_{ARM}.json").read_text())
    assert row["n_rollbacks"] == 1 and jvalid.validate_result(row, "harness") == []
    # No checkpoint committed before the trip, and a cadence rules out the
    # snapshot: nothing to roll back to.
    bad = _harness(["--steps", "12", "--results-dir", str(tmp_path / "u"), "--checkpoint-dir",
                    str(tmp_path / "ck_u"), "--checkpoint-every", "6", "--sentinel", "on",
                    "--inject-fault", "bitflip@1"])
    assert bad.returncode == 1, bad.stderr[-3000:]
    assert "numerics sentinel tripped" in bad.stderr
    assert "no validated checkpoint committed yet" in bad.stderr
    assert not (tmp_path / "u" / f"result_{ARM}.json").exists()


def test_checksum_cadence_needs_the_sentinel():
    with pytest.raises(ValueError, match="--sentinel-checksum-every needs --sentinel on"):
        run_benchmark(steps=4, sentinel_checksum_every=2, **SMALL)
