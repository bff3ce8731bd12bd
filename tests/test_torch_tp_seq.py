"""Tensor parallelism with sequence parallelism: the trainer over four gloo
ranks laid out (data 1, seq 2, model 2), ring and Ulysses attention, against
JAX's train step on a mesh of the same widths (JAX's
``tests/test_tp_sp.py``, dp x sp x tp, does the same for JAX against its
own ddp run).

A module fixture starts the ranks once (``tests/torch_tp_worker.py``,
``seq`` mode): TinyGPT and Llama at 4 query / 2 kv heads (tier S's 2 query
heads over ``model`` 2 leave one head per rank, which Ulysses cannot split
over ``seq`` 2, in JAX as here), tier S at S 64, fp32 compute, dropout 0,
zero2, per-device batch 1 x accum 2, from the JAX init, 3 steps. Each rank
holds S/2 of the sequence and H/2 of the heads: the ring keys its mask by
the global head ids (JAX's ``_ring_offsets`` with ``heads_axis``), Ulysses
folds the ``model`` index into its seed (JAX's ``_global_shard_index``).
The JAX side is ``tests/test_torch_tp.py``'s composed recipe on a (1, 2, 2)
mesh, its params laid out by JAX's specs. Tolerances are that file's.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from distributed_llm_training_benchmark_framework_tpu.data.synthetic import (
    SyntheticDataset as JaxSyntheticDataset,
)
from distributed_llm_training_benchmark_framework_tpu.ops import ring_attention as jra
from distributed_llm_training_benchmark_framework_tpu.ops import ulysses_attention as jua
from distributed_llm_training_benchmark_framework_tpu.parallel import make_mesh as jmake_mesh
from distributed_llm_training_benchmark_framework_tpu_torch.train import run_benchmark

from test_torch_tp import assert_params_match, jax_recipes, write_inputs
from torch_tp_worker import (
    ACCUM,
    ATTENTION_SEED,
    F32_ZERO2,
    IMPLS,
    S,
    SEQ_FAMILIES,
    STEPS,
    TP,
    spawn_ranks,
    wait_ranks,
)

SP, WORLD = 2, 4
NAMES = ("out", "dq", "dk", "dv")


def _jax_attention(form, q, k, v, do):
    """JAX's ring / Ulysses at dropout 0.1 on a (data 1, seq 2, model 2) mesh
    (heads over ``model``): output and the gradients of sum(out * do)."""
    mesh = jmake_mesh((1, SP, TP), ("data", "seq", "model"), devices=jax.devices()[:WORLD])
    fn = {"ulysses": jua.ulysses_attention, "ring": jra.ring_attention}[form]

    def f(q, k, v, do):
        out, vjp = jax.vjp(lambda a, b, c: fn(a, b, c, mesh=mesh, dropout_rate=0.1,
                                              dropout_seed=jnp.uint32(ATTENTION_SEED)),
                           q, k, v)
        return out, vjp(do)

    with jax.set_mesh(mesh):
        out, grads = jax.jit(f)(*(jnp.asarray(a) for a in (q, k, v, do)))
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(every rank's json, every rank's arrays, {(family, impl): the JAX
    zero2 recipe}, the one-process ring run's per-step losses at dropout
    0.1, {form: JAX's attention output and gradients})."""
    tmp = tmp_path_factory.mktemp("tpseq")
    table = JaxSyntheticDataset(512, S, size=10, seed=42).data
    rng = np.random.default_rng(0)
    att = {x: rng.standard_normal((2, S, 4, 16)).astype(np.float32)
           for x in ("q", "k", "v", "do")}
    init = write_inputs(tmp / "inputs.npz", SEQ_FAMILIES, table, **att)
    procs = spawn_ranks(WORLD, tmp / "inputs.npz", tmp / "w", "seq")
    jax_att = {form: _jax_attention(form, *(att[x] for x in ("q", "k", "v", "do")))
               for form in IMPLS}
    jax_runs = {(f, i): jax_recipes(f, (1, SP, TP), ["zero2"], table, init[f], impl=i)["zero2"]
                for f in SEQ_FAMILIES for i in IMPLS}
    one_process = []
    run_benchmark(strategy=F32_ZERO2, tier="S", seq_len=S, steps=STEPS, warmup_steps=1,
                  per_device_batch=2, grad_accum=ACCUM, dropout=0.1, attention_impl="ring",
                  sequence_parallel=SP, device="cpu", loss_log=one_process)
    wait_ranks(procs)
    ranks = [json.loads((tmp / f"w.rank{r}.json").read_text()) for r in range(WORLD)]
    arrays = [np.load(tmp / f"w.rank{r}.npz") for r in range(WORLD)]
    return ranks, arrays, jax_runs, one_process, jax_att


def test_mesh_lays_ranks_out_seq_then_model(runs):
    """Rank r sits at seq (r // tp) % sp, model r % tp (data 1)."""
    for r, res in enumerate(runs[0]):
        assert res["mesh"] == [1, (r // TP) % SP, r % TP, WORLD]


@pytest.mark.parametrize("family", SEQ_FAMILIES)
@pytest.mark.parametrize("impl", IMPLS)
def test_losses_and_params_match_jax(runs, family, impl):
    ranks, rank0 = runs[0], runs[1][0]
    label = f"{family}.{impl}"
    want_losses, params, small, lr_sum = runs[2][family, impl]
    for res in ranks:
        assert res["losses"][label] == ranks[0]["losses"][label]
    np.testing.assert_allclose(ranks[0]["losses"][label], want_losses, rtol=1e-5)
    assert_params_match(rank0, label, params, small, lr_sum)


def test_ring_dropout_run_equals_the_one_process_ring(runs):
    """At dropout 0.1 and per-device batch 2 the ring over (seq 2, model 2)
    draws the masks of the one-process ring over the same two shards: each
    rank's ids are its global batch*head ids, so the head offset and the
    batch row both key the hash as the whole-sequence run keys them."""
    np.testing.assert_allclose(runs[0][0]["dropout_losses"], runs[3], rtol=1e-5)


@pytest.mark.parametrize("form", IMPLS)
def test_attention_on_seq_and_heads_matches_jax(runs, form):
    """At dropout 0.1, rank (s, m) holds columns s and heads m: Ulysses
    folds ``model`` into its seed between ``data`` and ``seq`` (JAX's
    ``_global_shard_index`` over (batch_axis, heads_axis, seq)), the ring
    keys its hash by global head ids (JAX's ``_ring_offsets`` with
    ``heads_axis``); reassembled, outputs and gradients equal JAX's on the
    same mesh (``tests/test_torch_ulysses.py``'s tolerances)."""
    arrays, want = runs[1], runs[4][form]
    for i, name in enumerate(NAMES):
        got = np.concatenate([np.concatenate([arrays[s * TP + m][f"att.{form}.{name}"]
                                              for m in range(TP)], axis=2)
                              for s in range(SP)], axis=1)
        tol = 2e-3 if name == "out" else 5e-3
        np.testing.assert_allclose(got, want[i], rtol=tol, atol=tol, err_msg=name)
