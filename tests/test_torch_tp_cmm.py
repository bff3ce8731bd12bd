"""Collective matmul (``ops/collective_matmul.py``) over two gloo ranks on the
CPU: the tensor-parallel model with ``tp_collective_matmul`` against the
plain tensor-parallel model and against JAX's collective matmul (JAX's
``tests/test_overlap.py::test_cmm_matches_plain_tp_forward_and_grads``), and
the global ``ag_proj`` / ``rs_proj`` against the plain product and JAX's.

A module fixture starts two ranks once (``tests/torch_tp_worker.py``, ``cmm``
mode), laid out (model 2): for TinyGPT (fused q/k/v, GELU MLP) and Llama
tier S (split q and kv projections, kv replicated over ``model``: its one kv
head does not split), fp32, dropout 0, S 64, from the JAX init, the loss and
every gradient of one forward and backward on one batch of B 2, with and
without the collective matmul; and zero2 trained 3 steps both ways. The JAX
side runs ``tinygpt.loss_fn`` with and without ``tp_collective_matmul`` on
a (1, 1, 2) mesh of the conftest's virtual devices. JAX's own bar: loss
within 1e-5, every gradient within 1e-5 absolute; trained losses within
``tests/test_torch_arms.py``'s 1e-5 relative.
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_llm_training_benchmark_framework_tpu.data.synthetic import (
    SyntheticDataset as JaxSyntheticDataset,
)
from distributed_llm_training_benchmark_framework_tpu.models import tinygpt as jtiny
from distributed_llm_training_benchmark_framework_tpu.ops import collective_matmul as jcm
from distributed_llm_training_benchmark_framework_tpu.parallel import make_mesh as jmake_mesh
from distributed_llm_training_benchmark_framework_tpu_torch import bench as tbench

from test_torch_tp import jax_config, write_inputs
from torch_tp_worker import S, TP, spawn_ranks, wait_ranks

FAMILIES = ("tinygpt", "llama")
B = 2


def _jax_loss_and_grads(family, batch, init, cmm):
    jc = dataclasses.replace(jax_config(family, attention_impl="flash"),
                             tp_collective_matmul=cmm)
    mesh = jmake_mesh((1, 1, TP), ("data", "seq", "model"), devices=jax.devices()[:TP])
    params = jax.tree.map(jnp.asarray, init)
    with jax.set_mesh(mesh):
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jtiny.loss_fn(jc, p, jnp.asarray(batch), jnp.asarray(batch))))(params)
    return float(loss), jax.tree.map(np.asarray, grads)


def _jax_forms(x, w1, y, w2, wkv):
    """JAX's ag_proj / rs_proj on a (model 2) mesh: outputs and the
    gradients of their sums."""
    mesh = jmake_mesh((1, 1, TP), ("data", "seq", "model"), devices=jax.devices()[:TP])
    out = {}
    with jax.set_mesh(mesh):
        for name, fn, args in (
                ("ag", lambda a, b: jcm.ag_proj(a, b), (x, w1)),
                ("rs", lambda a, b: jcm.rs_proj(a, b), (y, w2)),
                ("ag_kv", lambda a, b: jcm.ag_proj(a, b, aligned_units=1), (x, wkv))):
            val, grads = jax.jit(jax.value_and_grad(lambda a, b: fn(a, b).sum(),
                                                    argnums=(0, 1)))(*args)
            out[name] = (np.asarray(jax.jit(fn)(*args)), [np.asarray(g) for g in grads])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cmm")
    table = JaxSyntheticDataset(512, S, size=10, seed=42).data
    rng = np.random.default_rng(0)
    batch = rng.integers(0, 512, size=(B, S)).astype(np.int32)
    forms = {"x": rng.standard_normal((B, S, 16), np.float32),
             "w1": rng.standard_normal((16, 12), np.float32),
             "y": rng.standard_normal((B, S, 12), np.float32),
             "w2": rng.standard_normal((12, 16), np.float32),
             "wkv": rng.standard_normal((16, 2, 6), np.float32)}
    init = write_inputs(tmp / "inputs.npz", FAMILIES, table, cmm_batch=batch, **forms)
    procs = spawn_ranks(TP, tmp / "inputs.npz", tmp / "w", "cmm")
    jax_runs = {(f, on): _jax_loss_and_grads(f, batch, init[f], on)
                for f in FAMILIES for on in (False, True)}
    jax_forms = _jax_forms(*(forms[k] for k in ("x", "w1", "y", "w2", "wkv")))
    wait_ranks(procs)
    ranks = [json.loads((tmp / f"w.rank{r}.json").read_text()) for r in range(TP)]
    return ranks, [np.load(tmp / f"w.rank{r}.npz") for r in range(TP)], jax_runs, jax_forms, forms


def _grad_leaves(arrays, label):
    return {k[len(label) + 1:]: arrays[k] for k in arrays.files if k.startswith(label + ".")}


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("against", ["plain tp", "jax cmm", "jax plain"])
def test_loss_and_grads_match(runs, family, against):
    ranks, arrays, jax_runs = runs[0], runs[1][0], runs[2]
    loss = ranks[0]["loss"][f"{family}.True"]
    got = _grad_leaves(arrays, f"grad.{family}.True")
    if against == "plain tp":
        want_loss = ranks[0]["loss"][f"{family}.False"]
        want = _grad_leaves(arrays, f"grad.{family}.False")
    else:
        want_loss, tree = jax_runs[family, against == "jax cmm"]
        want = {k: v for k, v in tree.items() if k != "blocks"}
        want.update({f"blocks.{k}": v for k, v in tree["blocks"].items()})
    assert abs(loss - want_loss) < 1e-5
    assert set(got) == set(want)
    for k, v in want.items():
        assert np.abs(got[k] - v).max() < 1e-5, k


@pytest.mark.parametrize("family", FAMILIES)
def test_trained_losses_equal_the_plain_tp_path(runs, family):
    ranks = runs[0]
    np.testing.assert_allclose(ranks[0]["losses"][f"{family}.True"],
                               ranks[0]["losses"][f"{family}.False"], rtol=1e-5)
    assert ranks[1]["losses"] == ranks[0]["losses"]


@pytest.mark.parametrize("name", ["ag", "rs", "ag_kv"])
def test_global_forms_match_jax_and_the_plain_product(runs, name):
    """``ag_proj`` (feature-sharded weight, and a kv weight kept replicated by
    ``aligned_units``) and ``rs_proj`` over the ring: outputs and the
    gradients of their sums against JAX's and against the plain product;
    every rank returns the whole result."""
    arrays, (want_out, want_grads), forms = runs[1], runs[3][name], runs[4]
    x, w = {"ag": ("x", "w1"), "rs": ("y", "w2"), "ag_kv": ("x", "wkv")}[name]
    plain = np.einsum("bsd,d...->bs...", forms[x], forms[w])
    for rank in arrays:
        np.testing.assert_allclose(rank[f"{name}.out"], want_out, atol=1e-5)
        np.testing.assert_allclose(rank[f"{name}.out"], plain, atol=1e-5)
    for key, g in zip((x, w), want_grads):
        # Each rank's gradient of the sum of the whole output, as JAX's.
        np.testing.assert_allclose(arrays[0][f"{name}.d{key}"], g, atol=1e-4)


@pytest.mark.parametrize("cmm", [False, True])
@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_recomputes_the_collectives_and_reduces_each_gradient_once(runs, cmm, remat):
    """A checkpointed block runs its forward collectives again in the
    recompute (same values); a gradient's all-reduce runs in the backward
    only. At dropout 0.1, remat dots and full give remat none's loss and
    gradients bit for bit (tests/test_torch_remat.py's bar), on both
    ranks."""
    for r, arrays in enumerate(runs[1]):
        assert runs[0][r]["remat"][f"{cmm}.{remat}"] == runs[0][r]["remat"][f"{cmm}.none"]
        got = _grad_leaves(arrays, f"remat.{cmm}.{remat}")
        want = _grad_leaves(arrays, f"remat.{cmm}.none")
        assert set(got) == set(want)
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)


def test_without_a_group_ag_proj_is_the_plain_product(runs):
    arrays, forms = runs[1][0], runs[4]
    np.testing.assert_allclose(arrays["ag_plain.out"],
                               np.einsum("bsd,df->bsf", forms["x"], forms["w1"]), atol=1e-5)


def test_bench_stamps_the_inert_knob_at_model_width_1(capsys):
    """JAX's bench: ``--tp-collective-matmul`` without tensor parallelism
    changes nothing and is recorded on the line; the default line has no
    such key."""
    args = ["--device", "cpu", "--tier", "S", "--seq-len", "64", "--steps", "2",
            "--warmup-steps", "1", "--flagship", "off", "--skip-preflight"]
    (off,) = tbench.main(args)
    off_line = json.loads(capsys.readouterr().out.strip())
    (on,) = tbench.main(args + ["--tp-collective-matmul"])
    on_line = json.loads(capsys.readouterr().out.strip())
    assert "tp_collective_matmul" not in off_line and on_line["tp_collective_matmul"] is True
    assert (on.tp_collective_matmul, on.tensor_parallel, on.mean_loss) == (
        True, 1, off.mean_loss)
