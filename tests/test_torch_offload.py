"""The host-offload arm and bf16 parameter storage against the JAX package.

Every run is tier S TinyGPT at S 64, fp32 compute, flash attention (its plain
versions on the CPU), dropout 0, per-device batch 1 x grad-accum 2, in one
process, at bf16 parameters (JAX's ``_resolve_model_config`` under the same
strategy), over one batch table. JAX's gradients are its own ``loss_fn``'s
at those bf16 parameters, summed over the micro-batches in bf16 and divided
by accum, as its ``one_micro`` accumulates them. They are compiled with
XLA's excess precision off (``xla_allow_excess_precision``): with it on,
XLA's fusion keeps bf16 intermediates (the cotangents of the ``astype``
casts) in fp32, which puts 30-50% of the bf16 gradient elements one bf16
step from a per-op evaluation; with it off, JAX rounds where the port's
eager autograd rounds (as JAX does op by op), and the two agree but for
about 0.1% of the elements, one bf16 step apart.

- **Serial offload** against the body of JAX's ``host_math`` (its
  ``_adamw_only``, ``optax.apply_updates`` and the clip scale ``c /
  max(g_norm, c)``) for 3 steps, from JAX's init. JAX's own
  ``offload_update_and_apply`` cannot take the serial arm on the CPU (it
  places the gradients in host memory, which XLA:CPU refuses to add to
  device arrays).
- **Delayed offload** against JAX's own ``offload_update_and_apply`` on a
  one-device CPU mesh, its optimizer state put back in device memory after
  each call, from JAX's init; step 0 applies the zero slot: with zero2's
  warmup the masters stay as they were, with ddp's bare AdamW they take
  one decay-only step.
- **The serial -> delayed switch** (``offload_dpu_start_step``) from the
  port's seeded init and table (``build_run``): JAX's serial body for k
  steps, then its delayed update from a zero pending slot (its loop's
  transition); the port through ``build_run`` and the optimizer's
  ``begin_delayed`` (what the loop calls), and through ``run_benchmark``,
  whose losses must equal that run's. Then JAX's four refusals.
- **bf16 parameters** (no offload) against JAX's optimizer on bf16
  parameters, applied op by op: accumulators and AdamW moments are bf16 on
  both sides.

Tolerances, each from the dtype that sets it:

- losses 1e-4 relative: the forward runs on equal bf16 parameters (step 0)
  or on parameters a bf16 step apart here and there;
- masters (fp32) 1e-5 relative plus ``LR_SHARE`` = 2^-5 of the learning
  rates taken so far, absolute. A gradient element one bf16 step apart
  differs by at most 2^-7 of itself. Adam's first update, lr * g / (|g| +
  eps), does not see that; a later one, through the moments, moves by at
  most about twice that share of its lr, 2^-6; once the compute copies
  differ by a bf16 step here and there, every later gradient does a little,
  so each update may add its share: 2^-5 of the lr sum keeps a factor 2.
  Adam divides each element by its own running RMS, so an element whose two
  gradients differ by more than a bf16 step, or have stayed under 10 Adam
  eps, moves by up to lr either way: such elements, found from the two
  sides' gradients of every update consumed, are held to lr per step taken
  (``tests/test_torch_tp.py``'s rule);
- the offload arm's bf16 compute copies are bf16(master) exactly (checked),
  so within the masters' limits plus one bf16 step (2^-7 of the value);
- bf16 parameters: within one bf16 step of JAX's value per update taken
  plus ``BF16_LR_SHARE`` = 2^-4 of the lr sum, the Adam-bound elements
  within lr per step plus a bf16 step. An update of lr 1e-4 at a weight of
  0.02 is about one bf16 step, and each update rounds the weight once, so
  each side may land it on a neighbouring value; the update itself, a chain
  of about six bf16 roundings (the moments, their bias corrections, the
  square root, the quotient), carries up to about 6 * 2^-8 of lr, under
  2^-4, which is what a weight near zero (a bias, whose bf16 step is tiny)
  sees.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_llm_training_benchmark_framework_tpu.data.synthetic import (
    SyntheticDataset as JaxSyntheticDataset,
)
from distributed_llm_training_benchmark_framework_tpu.models import tinygpt as jtiny
from distributed_llm_training_benchmark_framework_tpu.parallel import make_mesh as jmake_mesh
from distributed_llm_training_benchmark_framework_tpu.parallel import strategies as jstrat
from distributed_llm_training_benchmark_framework_tpu.train.step import _resolve_model_config
from distributed_llm_training_benchmark_framework_tpu.utils import memory as jmemory
from distributed_llm_training_benchmark_framework_tpu_torch import bridge
from distributed_llm_training_benchmark_framework_tpu_torch.models import TinyGPT, get_config
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import make_mesh
from distributed_llm_training_benchmark_framework_tpu_torch.parallel.mesh import Mesh
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import strategies as tstrat
from distributed_llm_training_benchmark_framework_tpu_torch.train import loop as tloop
from distributed_llm_training_benchmark_framework_tpu_torch.train.step import TrainStep
from distributed_llm_training_benchmark_framework_tpu_torch.utils import memory as tmemory

from test_torch_arms_worker import master_tree
from torch_threads import one_thread  # noqa: F401  (autouse)

S, MICRO, ACCUM, STEPS = 64, 1, 2, 3
CPU = torch.device("cpu")
NEAR_EPS = 10 * 1e-8  # 10 Adam eps
LOSS_RTOL = 1e-4
MASTER_RTOL, LR_SHARE = 1e-5, 2 ** -5
BF16_LR_SHARE = 2 ** -4


def _strategy(arm, **change):
    return dataclasses.replace(tstrat.get_strategy(arm), precision="f32", **change)


def _jstrategy(arm, **change):
    return dataclasses.replace(jstrat.get_strategy(arm), precision="f32", **change)


def _jax_config(strategy):
    jc = jtiny.get_model_config("S", S, dropout=0.0, compute_dtype=jnp.float32,
                                attention_impl="flash")
    mesh = jmake_mesh((1,), ("data",), devices=jax.devices()[:1])
    return _resolve_model_config(jc, strategy, mesh), mesh


class JaxSide:
    """JAX's bf16 gradients of a step (``one_micro``'s bf16 accumulation),
    without excess precision (see the module docstring)."""

    def __init__(self, rc, table):
        self.table = table
        self.fn = jax.value_and_grad(lambda p, b: jtiny.loss_fn(rc, p, b, b))
        self.compiled = None

    def grads(self, params, step):
        G = ACCUM * MICRO
        rows = (step * G + np.arange(G)) % self.table.shape[0]
        batch = jnp.asarray(self.table[rows].reshape(ACCUM, MICRO, S))
        if self.compiled is None:
            self.compiled = jax.jit(self.fn).lower(params, batch[0]).compile(
                compiler_options={"xla_allow_excess_precision": False})
        acc = jax.tree.map(lambda p: jnp.zeros(p.shape, p.dtype), params)
        loss_sum = 0.0
        for j in range(ACCUM):
            loss, g = self.compiled(params, batch[j])
            loss_sum += float(loss)
            acc = jax.tree.map(jnp.add, acc, g)
        return loss_sum / ACCUM, jax.tree.map(lambda g: g / ACCUM, acc)


def clip_scale(strategy, grads):
    """JAX's device-side clip of the offload arm (``strategies.py:509-518``)."""
    if strategy.grad_clip is None:
        return jnp.float32(1.0)
    gnorm = optax.global_norm(jax.tree.map(lambda g: g.astype(jnp.float32), grads))
    limit = jnp.float32(strategy.grad_clip)
    return limit / jnp.maximum(gnorm, limit)


def host_math_fn(strategy):
    """The body of JAX's ``host_math`` (``strategies.py:536-545``), jitted
    as JAX jits it."""
    adamw = jstrat._adamw_only(strategy)

    def host_math(g, s, master, adamw_state):
        g32 = jax.tree.map(lambda x: x.astype(jnp.float32) * s, g)
        u, adamw_state2 = adamw.update(g32, adamw_state, master)
        master2 = optax.apply_updates(master, u)
        return jax.tree.map(lambda m: m.astype(jnp.bfloat16), master2), master2, adamw_state2

    return adamw, jax.jit(host_math)


def _lr(strategy, count):
    w = strategy.warmup_steps
    return strategy.learning_rate * (min(1.0, count / w) if w else 1.0)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def jax_serial(strategy, side, params, steps):
    """Serial host updates from ``params``: per step (loss, bf16 params
    after, fp32 masters after, the step's gradients), and the end state."""
    adamw, host_math = host_math_fn(strategy)
    master = jax.tree.map(lambda p: p.astype(jnp.float32), params)
    state = adamw.init(master)
    out = []
    for step in range(steps):
        loss, g = side.grads(params, step)
        params, master, state = host_math(g, clip_scale(strategy, g), master, state)
        out.append((loss, _np(params), _np(master), _np(g)))
    return out, (params, master, state)


def jax_delayed(strategy, side, params, steps, mesh, state=None, first=0):
    """JAX's own ``offload_update_and_apply`` (delayed) on a one-device
    mesh, its state put back in device memory after each call; per step as
    ``jax_serial``. Step t's update consumes step t-1's gradients (the zero
    slot at the first)."""
    state = jstrat.make_optimizer(strategy).init(params) if state is None else state
    specs = jax.tree.map(lambda _: P(), params)
    dev = jax.sharding.SingleDeviceSharding(jax.devices()[0])
    out = []
    for step in range(first, first + steps):
        loss, g = side.grads(params, step)
        params, state = jstrat.offload_update_and_apply(strategy, g, state, params, mesh,
                                                        specs, specs)
        state = jax.device_put(state, dev)
        out.append((loss, _np(params), _np(state[0]), _np(g)))
    return out


def _leaves(tree):
    return [(k, v) for k, v in tree.items() if k != "blocks"] + [
        (f"blocks.{k}", v) for k, v in tree["blocks"].items()]


def _get(tree, key):
    return tree["blocks"][key.split(".", 1)[1]] if key.startswith("blocks.") else tree[key]


def bf16_steps_apart(a, b):
    """Elementwise distance of two bf16 arrays in bf16 steps of the larger."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    ulp = np.exp2(np.floor(np.log2(np.maximum(np.abs(a), np.abs(b)) + 1e-30)) - 7)
    return np.abs(a - b) / ulp


def adam_bound(port_g, jax_g):
    """Elements whose update only Adam's lr bounds (see the module
    docstring): gradients more than a bf16 step apart, or under 10 eps."""
    def one(a, b):
        fa, fb = np.asarray(a, np.float32), np.asarray(b, np.float32)
        return ((bf16_steps_apart(a, b) > 1) | (np.abs(fa) < NEAR_EPS)
                | (np.abs(fb) < NEAR_EPS))
    return jax.tree.map(one, port_g, jax_g)


def _or(a, b):
    return jax.tree.map(np.logical_or, a, b)


def port_grads(model, tensors):
    """``tensors`` (one per parameter, in order) as JAX leaves."""
    twin = TinyGPT(model.config)
    with torch.no_grad():
        for t, v in zip(twin.parameters(), tensors):
            t.copy_(v.view(t.shape))
    return bridge.export_params(twin)


def assert_masters(got, want, loose, lr_sum, msg):
    for key, leaf in _leaves(want):
        g = np.asarray(_get(got, key), np.float32)
        tiny = _get(loose, key)
        np.testing.assert_allclose(g[~tiny], leaf[~tiny], rtol=MASTER_RTOL,
                                   atol=LR_SHARE * lr_sum + 1e-7, err_msg=f"{key}, {msg}")
        assert (np.abs(g[tiny] - leaf[tiny]) <= lr_sum + 1e-7).all(), f"{key}, {msg}"


def assert_compute(got, want, loose, lr_sum, msg):
    for key, leaf in _leaves(want):
        g = np.asarray(_get(got, key), np.float32)
        w = np.asarray(leaf, np.float32)
        tiny = _get(loose, key)
        bound = (np.where(tiny, lr_sum, LR_SHARE * lr_sum) + 1e-7
                 + (2 ** -7 + MASTER_RTOL) * np.abs(w))
        assert (np.abs(g - w) <= bound).all(), (key, msg)


@pytest.fixture(scope="module")
def table():
    return JaxSyntheticDataset(512, S, size=10, seed=42).data


def _port(strategy, params_np):
    mesh = make_mesh()
    cfg = get_config("tinygpt", "S", S, dropout=0.0, compute_dtype=torch.float32,
                     attention_impl="flash", param_dtype=tstrat.param_torch_dtype(strategy))
    model = TinyGPT(cfg, mesh=mesh)
    bridge.load_jax_params(model, params_np)
    model, opt = tstrat.apply_strategy(model, strategy, mesh)
    step_fn = TrainStep(model, opt, grad_accum=ACCUM, micro_batch=MICRO, seed=0, device=CPU,
                        mesh=mesh)
    return model, opt, mesh, step_fn


class Tracker:
    """The running set of Adam-bound elements and lr sum of a port run
    held against ``jax_serial`` / ``jax_delayed`` entries."""

    def __init__(self, strategy, like):
        self.strategy = strategy
        self.loose = jax.tree.map(lambda x: np.zeros(x.shape, bool), like)
        self.parked = self.loose
        self.lr_sum = 0.0
        self.losses = []

    def run(self, step_fn, model, opt, mesh, t_table, want, first=0, delayed=False):
        """Step the port through ``want`` from step ``first``; a delayed
        update consumes the previous step's gradients."""
        for step, (loss, jparams, jmaster, jg) in enumerate(want, start=first):
            got = step_fn(t_table, step).item()
            self.losses.append(got)
            np.testing.assert_allclose(got, loss, rtol=LOSS_RTOL, err_msg=f"loss, step {step}")
            noisy = adam_bound(port_grads(model, opt.host.stage_views), jg)
            self.loose = _or(self.loose, self.parked if delayed else noisy)
            self.parked = noisy
            self.lr_sum += _lr(self.strategy, opt.host.count - 1)
            masters = master_tree(model, opt, mesh)
            assert_masters(masters, jmaster, self.loose, self.lr_sum, f"step {step}")
            compute = bridge.export_params(model)
            for key, leaf in _leaves(masters):  # the device copy is bf16(master) exactly
                np.testing.assert_array_equal(
                    np.asarray(_get(compute, key), np.float32),
                    torch.from_numpy(leaf).to(torch.bfloat16).float().numpy(), err_msg=key)
            assert_compute(compute, jparams, self.loose, self.lr_sum, f"step {step}")


@pytest.mark.parametrize("arm", ["ddp", "zero2"])
def test_serial_offload_matches_jax_host_math(table, arm):
    """zero2: warmup + clip; ddp: bare AdamW, no clip (scale 1)."""
    strategy = _strategy(arm, offload_opt_state=True)
    jstrategy = _jstrategy(arm, offload_opt_state=True)
    rc, _ = _jax_config(jstrategy)
    assert rc.param_dtype == jnp.bfloat16
    params = jtiny.init_params(rc, jax.random.key(0))
    want, _ = jax_serial(jstrategy, JaxSide(rc, table), params, STEPS)
    model, opt, mesh, step_fn = _port(strategy, _np(params))
    assert opt.adamw is None and opt.host is not None and not opt.host.delayed
    Tracker(strategy, want[0][3]).run(step_fn, model, opt, mesh,
                                      torch.from_numpy(table.astype(np.int64)), want)
    assert opt.host.count == STEPS


@pytest.mark.parametrize("arm", ["zero2", "ddp"])
def test_delayed_offload_matches_jax_offload_update_and_apply(table, arm):
    """zero2 (warmup: the zero slot leaves the masters as they are) and ddp
    (bare AdamW: the zero slot is a decay-only step)."""
    strategy = _strategy(arm, offload_opt_state=True, offload_delayed_update=True)
    jstrategy = _jstrategy(arm, offload_opt_state=True, offload_delayed_update=True)
    rc, jmesh = _jax_config(jstrategy)
    params = jtiny.init_params(rc, jax.random.key(0))
    want = jax_delayed(jstrategy, JaxSide(rc, table), params, STEPS, jmesh)
    start = _np(jax.tree.map(lambda p: p.astype(jnp.float32), params))
    decay = np.float32(1.0 if strategy.warmup_steps else 1.0 - strategy.learning_rate * 0.01)
    model, opt, mesh, step_fn = _port(strategy, _np(params))
    assert opt.host.delayed
    t_table = torch.from_numpy(table.astype(np.int64))
    Tracker(strategy, want[0][3]).run(step_fn, model, opt, mesh, t_table, want[:1],
                                      delayed=True)
    # Step 0 applied the zero slot, on both sides: within two fp32
    # roundings of the decay alone (optax: u = -lr * wd * m, then m + u).
    masters = master_tree(model, opt, mesh)
    for key, leaf in _leaves(start):
        np.testing.assert_allclose(_get(want[0][2], key), leaf * decay, rtol=2.5e-7, err_msg=key)
        np.testing.assert_allclose(_get(masters, key), leaf * decay, rtol=2.5e-7, err_msg=key)
    model, opt, mesh, step_fn = _port(strategy, _np(params))
    Tracker(strategy, want[0][3]).run(step_fn, model, opt, mesh, t_table, want, delayed=True)
    assert opt.host.count == STEPS


def test_offload_dpu_switch_matches_jax_delayed_from_a_zero_slot():
    """Serial for k = 2 steps, then delayed for 2, from the port's seeded
    init and table; ``run_benchmark`` with ``offload_dpu_start_step`` 2
    gives the losses of the optimizer switched by hand."""
    k, steps = 2, 4
    strategy = _strategy("zero2", offload_opt_state=True, offload_delayed_update=True)
    kw = dict(tier="S", seq_len=S, per_device_batch=MICRO, grad_accum=ACCUM, dropout=0.0,
              attention_impl="flash", device="cpu")
    run = tloop.build_run(strategy=dataclasses.replace(strategy, offload_delayed_update=False),
                          **kw)
    params = jax.tree.map(jnp.asarray, bridge.export_params(run.model))
    jstrategy = _jstrategy("zero2", offload_opt_state=True, offload_delayed_update=True)
    rc, jmesh = _jax_config(jstrategy)
    side = JaxSide(rc, run.table.numpy())
    serial, (jparams, master, adamw_state) = jax_serial(
        dataclasses.replace(jstrategy, offload_delayed_update=False), side, params, k)
    # JAX's loop transition: the serial state plus an empty pending slot.
    state = (master, (optax.EmptyState(), adamw_state),
             (jax.tree.map(jnp.zeros_like, jparams), jnp.zeros((), jnp.float32)))
    delayed = jax_delayed(jstrategy, side, jparams, steps - k, jmesh, state=state, first=k)
    opt = run.step_fn.optimizer
    track = Tracker(strategy, serial[0][3])
    track.run(run.step_fn, run.model, opt, run.mesh, run.table, serial)
    opt.host.begin_delayed()
    track.run(run.step_fn, run.model, opt, run.mesh, run.table, delayed, first=k, delayed=True)
    losses = []
    row = tloop.run_benchmark(strategy=strategy, steps=steps, warmup_steps=k,
                              offload_dpu_start_step=k, loss_log=losses, **kw)
    assert losses == track.losses
    assert (row.offload_opt_state, row.offload_delayed_update, row.offload_dpu_start_step,
            row.param_dtype) == (True, True, k, "f32")


@pytest.mark.parametrize("start,change,match", [
    (-1, {}, "--offload-dpu-start-step must be >= 0, got -1"),
    (1, {"offload_delayed_update": False},
     "--offload-dpu-start-step requires --offload-delayed-update"),
    (3, {}, "--offload-dpu-start-step 3 >= --steps 3: the delayed phase would never begin"),
])
def test_offload_dpu_start_step_refusals_are_jaxs(start, change, match):
    strategy = _strategy("zero2", offload_opt_state=True,
                         **{"offload_delayed_update": True, **change})
    with pytest.raises(ValueError, match=match):
        tloop.run_benchmark(strategy=strategy, tier="S", seq_len=S, steps=3, warmup_steps=1,
                            offload_dpu_start_step=start, device="cpu")


def test_offload_dpu_start_after_warmup_warns_as_jax(capsys):
    strategy = _strategy("zero2", offload_opt_state=True, offload_delayed_update=True)
    row = tloop.run_benchmark(strategy=strategy, tier="S", seq_len=S, steps=3, warmup_steps=1,
                              offload_dpu_start_step=2, device="cpu")
    out = capsys.readouterr().out
    assert ("WARNING: --offload-dpu-start-step 2 > --warmup-steps 1: timed windows will mix "
            "serial and delayed step times into one result row") in out
    assert "[Step 0002] delayed-update phase begins" in out
    assert row.offload_dpu_start_step == 2


@pytest.mark.parametrize("arm", ["ddp", "zero2"])
def test_bf16_params_match_jax_bf16_step(table, arm):
    """``param_dtype`` bf16 without offload: optax's chain on bf16
    parameters and gradients (its moments follow them), applied op by op as
    the port's eager AdamW applies it; torch's moments are bf16 too."""
    strategy = _strategy(arm, param_dtype="bf16")
    jstrategy = _jstrategy(arm, param_dtype="bf16")
    rc, _ = _jax_config(jstrategy)
    params = jtiny.init_params(rc, jax.random.key(0))
    side = JaxSide(rc, table)
    tx = jstrat.make_optimizer(jstrategy)
    state = tx.init(params)
    model, opt, mesh, step_fn = _port(strategy, _np(params))
    assert opt.host is None and {p.dtype for p in model.parameters()} == {torch.bfloat16}
    t_table = torch.from_numpy(table.astype(np.int64))
    loose = jax.tree.map(lambda p: np.zeros(p.shape, bool), _np(params))
    lr_sum = 0.0
    clip = optax.clip_by_global_norm(jstrategy.grad_clip) if jstrategy.grad_clip else None
    for step in range(STEPS):
        loss, g = side.grads(params, step)
        updates, state = tx.update(g, state, params)
        params = optax.apply_updates(params, updates)
        got = step_fn(t_table, step).item()
        np.testing.assert_allclose(got, loss, rtol=LOSS_RTOL, err_msg=f"loss, step {step}")
        moments = [st[k] for st in opt.adamw.state.values() for k in ("exp_avg", "exp_avg_sq")]
        assert {m.dtype for m in moments} == {torch.bfloat16}
        lr_sum += _lr(strategy, step)
        # The gradients AdamW took on each side (after the clip, in place on
        # the port's .grad).
        taken = clip.update(g, clip.init(params))[0] if clip else g
        loose = _or(loose, adam_bound(port_grads(model, [p.grad for p in model.parameters()]),
                                      _np(taken)))
        got_p = bridge.export_params(model)
        for key, leaf in _leaves(_np(params)):
            mine = _get(got_p, key)
            assert mine.dtype == leaf.dtype, key
            w = np.abs(np.asarray(leaf, np.float32))
            diff = np.abs(np.asarray(mine, np.float32) - np.asarray(leaf, np.float32))
            one_step = np.exp2(np.floor(np.log2(w + 1e-30)) - 7)
            bound = np.where(_get(loose, key), lr_sum + one_step,
                             (step + 1) * one_step + BF16_LR_SHARE * lr_sum)
            assert (diff <= bound).all(), (key, step, float((diff / bound).max()))


def test_offload_state_lives_on_the_host():
    """The host state of one process's arm: fp32 masters upcast from the
    bf16 parameters (so bf16-rounded), flat, with AdamW's moments beside
    them, pageable where the device is the CPU, and no device AdamW."""
    strategy = _strategy("zero2", offload_opt_state=True)
    cfg = get_config("tinygpt", "S", S, param_dtype=torch.bfloat16)
    model = TinyGPT(cfg).init_weights(torch.Generator().manual_seed(0))
    model, opt = tstrat.apply_strategy(model, strategy, make_mesh())
    host = opt.host
    n = sum(p.numel() for p in model.parameters())
    assert opt.adamw is None and host.master.dtype == torch.float32 and host.master.numel() == n
    for p, m in zip(model.parameters(), host.master_views):
        assert torch.equal(m, p.float())
    state = host.adamw.state[host.master]
    assert state["exp_avg"].shape == state["exp_avg_sq"].shape == (n,)
    assert not host.master.is_pinned() and not host.cuda
    assert host.host_bytes == 4 * n * 4 + 2 * n * 2 + 4  # masters, grads, moments; slot, upload
    stats = host.stats()
    assert (stats["pinned"], stats["elements"], stats["host_bytes"]) == (False, n, host.host_bytes)


def test_a_bf16_jax_leaf_goes_in_and_out_exactly():
    jstrategy = _jstrategy("zero2", param_dtype="bf16")
    rc, _ = _jax_config(jstrategy)
    params = _np(jtiny.init_params(rc, jax.random.key(1)))
    model = TinyGPT(get_config("tinygpt", "S", S, param_dtype=torch.bfloat16))
    bridge.load_jax_params(model, params)
    back = bridge.export_params(model)
    for key, leaf in _leaves(params):
        got = _get(back, key)
        assert got.dtype == leaf.dtype and got.shape == leaf.shape, key
        np.testing.assert_array_equal(got.view(np.uint16), leaf.view(np.uint16), err_msg=key)


def _jmesh(data, model):
    return jmake_mesh((data, 1, model), ("data", "seq", "model"),
                      devices=jax.devices()[:data * model])


def _jax_moment_bytes(jcfg, jstrategy, jmesh, est):
    """JAX's optimizer-state bytes less its scalar leaves (optax counters),
    which the port does not count; 0 under offload, where JAX counts none."""
    if jstrategy.offload_opt_state:
        return est.opt_state
    shapes = jax.eval_shape(lambda: jtiny.init_params(jcfg, jax.random.key(0)))
    opt = jstrat.make_optimizer(jstrategy)
    scalars = sum(np.dtype(x.dtype).itemsize for x in
                  jax.tree_util.tree_leaves(jax.eval_shape(opt.init, shapes)) if x.shape == ())
    return est.opt_state - scalars


@pytest.mark.parametrize("change", [{"param_dtype": "bf16"}, {"offload_opt_state": True}])
@pytest.mark.parametrize("data,model", [(1, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("arm", sorted(jstrat.STRATEGIES))
def test_estimate_hbm_under_bf16_and_offload_is_jaxs(arm, data, model, change):
    """Without a group and under ``model`` the port's state terms are JAX's
    spec rule: bf16 parameters, gradients and (without offload) moments;
    no optimizer state on the device under offload."""
    jstrategy = dataclasses.replace(jstrat.get_strategy(arm), **change)
    jmesh = _jmesh(data, model)
    jcfg = _resolve_model_config(jtiny.get_model_config("A", 2048, scan_layers=False),
                                 jstrategy, jmesh)
    want = jmemory.estimate_hbm(jcfg, jstrategy, jmesh, 1, 2048)
    strategy = dataclasses.replace(tstrat.get_strategy(arm), **change)
    cfg = get_config("tinygpt", "A", 2048, remat=strategy.remat,
                     param_dtype=tstrat.param_torch_dtype(strategy))
    mesh = make_mesh() if model == 1 and data == 1 else Mesh({"data": data, "model": model})
    got = tmemory.estimate_hbm(cfg, strategy, mesh, 1, 2048)
    assert (got.params, got.grads, got.activations, got.logits) == (
        want.params, want.grads, want.activations, want.logits)
    assert got.opt_state == _jax_moment_bytes(jcfg, jstrategy, jmesh, want)
    if strategy.offload_opt_state:
        assert got.opt_state == 0


def test_tier_b_zero3_offload_drops_the_optimizer_state():
    """JAX's ``tests/test_memory.py::test_offload_opt_state_excluded_from_hbm_estimate``
    on the port: tier B at S 1024 under zero3 with host offload holds bf16
    parameters and gradients and no optimizer state; the fp32 arm holds
    params, grads and two moments, all fp32."""
    strategy = dataclasses.replace(tstrat.get_strategy("zero3"), offload_opt_state=True,
                                   remat="full")
    jstrategy = dataclasses.replace(jstrat.get_strategy("zero3"), offload_opt_state=True,
                                    remat="full")
    jmesh = _jmesh(1, 1)
    jcfg = _resolve_model_config(jtiny.get_model_config("B", 1024, attention_impl="flash"),
                                 jstrategy, jmesh)
    want = jmemory.estimate_hbm(jcfg, jstrategy, jmesh, 1, 1024, dataset_size=128)
    cfg = get_config("tinygpt", "B", 1024, attention_impl="flash", remat="full",
                     param_dtype=torch.bfloat16)
    got = tmemory.estimate_hbm(cfg, strategy, make_mesh(), 1, 1024, dataset_size=128)
    assert got.opt_state == want.opt_state == 0
    assert (got.params, got.grads, got.activations, got.logits) == (
        want.params, want.grads, want.activations, want.logits)
    plain = dataclasses.replace(tstrat.get_strategy("zero3"), remat="full")
    f32 = tmemory.estimate_hbm(get_config("tinygpt", "B", 1024, attention_impl="flash",
                                          remat="full"), plain, make_mesh(), 1, 1024,
                               dataset_size=128)
    assert f32.params == 2 * got.params and f32.opt_state == 2 * f32.params
    assert got.total < 12 * 1024**3 < 16 * 1024**3 < f32.total
