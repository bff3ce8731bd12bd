"""The port's Ulysses attention against the JAX package's, on the CPU.

JAX runs its Ulysses under a ``seq`` mesh (and a (data, seq) one) of the
conftest's virtual CPU devices, its flash on the CPU path its own tests
take. The port holds the n shards in one process (``ulysses_attention``)
or one per gloo rank (``ulysses_attention_sharded``,
``tests/torch_seq_parallel_worker.py``), and its flash runs the plain
versions of K1-K3, because the tensors lie on the CPU. Inputs come from
``np.random.default_rng``; the dropout seed is the same uint32 on both
sides, and the per-shard masks are a pure function of (seed, shard ids),
so they agree bit for bit and a wrong fold would show as an O(1) error.

Tolerances: against JAX, those of ``tests/test_torch_ring_attention.py``'s
kernel-parity cases (2e-3 on the output, 5e-3 on gradients: two frameworks'
fp32 sums in different orders); between the port's own forms, which run the
same arithmetic on the same blocks, exact equality.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_training_benchmark_framework_tpu.models import llama as jllama
from distributed_llm_training_benchmark_framework_tpu.models import tinygpt as jtiny
from distributed_llm_training_benchmark_framework_tpu.ops import ulysses_attention as jua
from distributed_llm_training_benchmark_framework_tpu.parallel import make_mesh as jmake_mesh
from distributed_llm_training_benchmark_framework_tpu_torch import bench as tbench
from distributed_llm_training_benchmark_framework_tpu_torch import bridge
from distributed_llm_training_benchmark_framework_tpu_torch.models import TinyGPT, get_config
from distributed_llm_training_benchmark_framework_tpu_torch.ops import flash_attention as tfa
from distributed_llm_training_benchmark_framework_tpu_torch.ops import ulysses_attention as tua
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import make_mesh

from torch_seq_parallel_worker import SEED, spawn_ranks, wait_ranks
from torch_threads import one_thread  # noqa: F401  (autouse)

CASES = [(n, c, r) for n in (2, 4) for c in (False, True) for r in (0.0, 0.1)]
NAMES = ("out", "dq", "dk", "dv")


def _inputs(B=2, S=64, H=4, D=16, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(4)]


def _torch_out_and_grads(fn, q, k, v, do):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = fn(tq, tk, tv)
    grads = torch.autograd.grad((out * torch.from_numpy(do)).sum(), (tq, tk, tv))
    return [out.detach().numpy()] + [g.numpy() for g in grads]


def _jax_out_and_grads(q, k, v, do, devices, data, n, **kw):
    mesh = jmake_mesh((data, n), ("data", "seq"), devices=devices[:data * n])

    def f(q, k, v, do):
        fn = lambda a, b, c: jua.ulysses_attention(a, b, c, mesh=mesh, **kw)  # noqa: E731
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(do)

    with jax.set_mesh(mesh):
        out, grads = jax.jit(f)(*(jnp.asarray(a) for a in (q, k, v, do)))
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _assert_jax_close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=2e-3, atol=2e-3, err_msg="out")
    for a, b, name in zip(got[1:], want[1:], NAMES[1:]):
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-3, err_msg=name)


@pytest.mark.parametrize("n,causal,rate", CASES)
def test_one_process_form_matches_jax(n, causal, rate, eight_devices):
    q, k, v, do = _inputs()
    want = _jax_out_and_grads(q, k, v, do, eight_devices, 1, n, causal=causal,
                              dropout_rate=rate, dropout_seed=jnp.uint32(SEED))
    got = _torch_out_and_grads(
        lambda a, b, c: tua.ulysses_attention(a, b, c, causal=causal, dropout_rate=rate,
                                              dropout_seed=SEED, seq_shards=n),
        q, k, v, do)
    _assert_jax_close(got, want)


def test_one_process_form_folds_the_data_shard_as_jax(eight_devices):
    """JAX on a (data 2, seq 2) mesh folds each row's data index into the
    seed (shard id data * 2 + seq); the port's one-process form on each
    row at ``data_rank`` d of ``data_width`` 2 draws the same masks."""
    q, k, v, do = _inputs(seed=1)
    want = _jax_out_and_grads(q, k, v, do, eight_devices, 2, 2, dropout_rate=0.1,
                              dropout_seed=jnp.uint32(SEED))
    rows = [_torch_out_and_grads(
        lambda a, b, c: tua.ulysses_attention(a, b, c, dropout_rate=0.1, dropout_seed=SEED,
                                              seq_shards=2, data_rank=d, data_width=2),
        *(x[d:d + 1] for x in (q, k, v, do))) for d in range(2)]
    _assert_jax_close([np.concatenate(parts) for parts in zip(*rows)], want)
    # Without the fold both rows would draw row 0's mask.
    unfolded = _torch_out_and_grads(
        lambda a, b, c: tua.ulysses_attention(a, b, c, dropout_rate=0.1, dropout_seed=SEED,
                                              seq_shards=2), q[1:], k[1:], v[1:], do[1:])
    assert np.abs(unfolded[0] - want[0][1:]).max() > 1e-2


def test_shard_seed_matches_jax():
    for seed in (0, SEED, 2**32 - 1):
        for shard in range(6):
            want = int(jua._shard_seed(jnp.uint32(seed), jnp.asarray(shard, jnp.int32)))
            assert tua._shard_seed(seed, shard) == want
    assert [tua._global_shard_index(s, 2, d, 2) for d in range(2) for s in range(2)] == [0, 1, 2, 3]
    assert tua._global_shard_index(1, 4, 3, 1) == 1  # data folded only when wider than 1


@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_one_shard_is_flash_exactly(rate):
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs())
    kw = dict(causal=True, dropout_rate=rate, dropout_seed=SEED, batch_offset=3)
    torch.testing.assert_close(tua.ulysses_attention(q, k, v, seq_shards=1, **kw),
                               tfa.flash_attention(q, k, v, **kw), rtol=0, atol=0)


@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
def test_rate_0_is_flash_bit_for_bit_and_rate_01_is_not(n, causal):
    """Each head's blocks are flash's, so rate 0 gives flash's output and
    gradients exactly; at rate 0.1 the folded seeds draw another mask than
    flash's on the whole sequence (JAX ``ops/ulysses_attention.py:26-33``)."""
    q, k, v, do = _inputs(seed=2)
    for rate in (0.0, 0.1):
        kw = dict(causal=causal, dropout_rate=rate, dropout_seed=SEED)
        got = _torch_out_and_grads(
            lambda a, b, c: tua.ulysses_attention(a, b, c, seq_shards=n, **kw), q, k, v, do)
        want = _torch_out_and_grads(lambda a, b, c: tfa.flash_attention(a, b, c, **kw),
                                    q, k, v, do)
        if rate == 0.0:
            for a, b, name in zip(got, want, NAMES):
                np.testing.assert_array_equal(a, b, err_msg=name)
        else:
            assert np.abs(got[0] - want[0]).max() > 1e-2


def test_seedless_dropout_warns_and_runs_at_rate_0():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs())
    with pytest.warns(UserWarning, match="DISABLED"):
        out = tua.ulysses_attention(q, k, v, dropout_rate=0.1, seq_shards=2)
    torch.testing.assert_close(out, tfa.flash_attention(q, k, v), rtol=0, atol=0)


def test_refusals_take_jaxs_message(eight_devices):
    q = torch.zeros(1, 64, 2, 16)
    jq = jnp.zeros((1, 64, 2, 16))
    mesh = jmake_mesh((4,), ("seq",), devices=eight_devices[:4])
    with pytest.raises(ValueError, match="heads % seq_parallel == 0") as jax_err:
        jua.ulysses_attention(jq, jq, jq, mesh=mesh)
    with pytest.raises(ValueError) as port_err:
        tua.ulysses_attention(q, q, q, seq_shards=4)
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError, match="does not split"):
        tua.ulysses_attention(torch.zeros(1, 66, 4, 16), q, q, seq_shards=4)


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    """Each rank's arrays from the attention mode over 2 and 4 gloo ranks."""
    tmp = tmp_path_factory.mktemp("ulysses")
    q, k, v, do = _inputs(seed=3)
    np.savez(tmp / "inputs.npz", q=q, k=k, v=v, do=do)
    procs = {w: spawn_ranks(w, tmp / "inputs.npz", tmp / f"w{w}", "attention") for w in (2, 4)}
    out = {}
    for w, ps in procs.items():
        wait_ranks(ps)
        out[w] = [np.load(tmp / f"w{w}.rank{r}.npz") for r in range(w)]
    return (q, k, v, do), out


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_sharded_form_over_gloo_equals_one_process_form(gloo_runs, world, causal, rate):
    """Every rank a ``seq`` shard: the all-to-all hands each rank the head
    group the one-process form gives that shard, so outputs and gradients
    are equal."""
    (q, k, v, do), ranks = gloo_runs
    want = _torch_out_and_grads(
        lambda a, b, c: tua.ulysses_attention(a, b, c, causal=causal, dropout_rate=rate,
                                              dropout_seed=SEED, seq_shards=world),
        q, k, v, do)
    for w, name in zip(want, NAMES):
        got = np.concatenate([r[f"ulysses.{causal}.{rate}.{name}"] for r in ranks[world]], axis=1)
        np.testing.assert_array_equal(got, w, err_msg=name)


def test_sharded_form_over_data_and_seq_folds_the_data_shard(gloo_runs):
    """4 ranks laid out (data 2, seq 2) by ``make_mesh``: rank (d, s) holds
    row d and columns s of the batch, its ``seq`` group is ranks {2d, 2d+1},
    and its seed folds shard id 2d + s, as the one-process form at
    ``data_rank`` d does."""
    (q, k, v, do), ranks = gloo_runs
    rows = [_torch_out_and_grads(
        lambda a, b, c: tua.ulysses_attention(a, b, c, dropout_rate=0.1, dropout_seed=SEED,
                                              seq_shards=2, data_rank=d, data_width=2),
        *(x[d:d + 1] for x in (q, k, v, do))) for d in range(2)]
    for i, name in enumerate(NAMES):
        got = np.concatenate([np.concatenate([ranks[4][2 * d + s][f"dseq.ulysses.{name}"]
                                              for s in range(2)], axis=1) for d in range(2)])
        np.testing.assert_array_equal(got, np.concatenate([r[i] for r in rows]), err_msg=name)


JAX_CONFIG = {"tinygpt": jtiny.get_model_config, "llama": jllama.get_llama_config}


@pytest.mark.parametrize("family", ["tinygpt", "llama"])
def test_ulysses_model_matches_flash_model_and_jax_ulysses_model(family, eight_devices):
    """Tier S, one shard per head group in one process (4 for TinyGPT; tier
    S Llama has 2 heads), dropout 0, the bridge's weights: the port's
    Ulysses model against its flash model (bit for bit: each head's blocks
    are flash's) and against the JAX model running its Ulysses under a
    ``seq`` mesh of that width (the ring model's tolerances,
    ``tests/test_torch_ring_attention.py``); loss and every gradient."""
    S, N = 64, {"tinygpt": 4, "llama": 2}[family]
    jc = JAX_CONFIG[family]("S", S, dropout=0.0, compute_dtype=jnp.float32,
                            attention_impl="ulysses")
    params = jtiny.init_params(jc, jax.random.key(0))
    idx = np.random.default_rng(1).integers(0, jc.vocab_size, (2, S)).astype(np.int32)
    mesh = jmake_mesh((1, N, 1), ("data", "seq", "model"), devices=eight_devices[:N])

    def jloss(p):
        return jtiny.forward(jc, p, jnp.asarray(idx), jnp.asarray(idx))[1]

    with jax.set_mesh(mesh):
        j_loss, j_grads = jax.jit(jax.value_and_grad(jloss))(params)
    j_grads = jax.tree.map(np.asarray, j_grads)

    def port(impl, mesh=None):
        model = TinyGPT(get_config(family, "S", S, dropout=0.0, compute_dtype=torch.float32,
                                   attention_impl=impl), mesh=mesh)
        bridge.load_jax_params(model, jax.tree.map(np.asarray, params))
        _, loss = model(torch.from_numpy(idx).long(), torch.from_numpy(idx).long())
        loss.backward()
        return model, loss.item()

    model, loss = port("ulysses", make_mesh((N,), ("seq",)))
    assert model.attention.func is tua.ulysses_attention
    assert model.attention.keywords["seq_shards"] == N
    flash_model, flash_loss = port("flash")
    np.testing.assert_allclose(loss, float(j_loss), rtol=2e-3, atol=2e-3)
    assert loss == flash_loss
    flash_grads = dict(bridge.leaf_map(flash_model))
    for path, p in bridge.leaf_map(model):
        want = j_grads[path[0]] if len(path) == 1 else j_grads["blocks"][path[1]][path[2]]
        name = "/".join(map(str, path))
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=5e-3, atol=5e-3, err_msg=name)
        np.testing.assert_array_equal(p.grad.numpy(), flash_grads[path].grad.numpy(),
                                      err_msg=name)


def test_bench_runs_ulysses_as_flash_at_seq_width_1(capsys):
    """The bench has no sequence-parallel flag (JAX's has none), so
    ``--attention ulysses`` runs at ``seq`` width 1, where Ulysses is flash:
    the same per-step losses bit for bit, the row stamped ``ulysses``."""
    args = ["--device", "cpu", "--tier", "S", "--seq-len", "64", "--steps", "3",
            "--warmup-steps", "1", "--flagship", "off", "--skip-preflight"]
    (ulysses,) = tbench.main(args + ["--attention", "ulysses"])
    (flash,) = tbench.main(args + ["--attention", "flash"])
    line = [json.loads(ln) for ln in capsys.readouterr().out.splitlines() if ln.strip()][0]
    assert line["attention_impl"] == ulysses.attention_impl == "ulysses"
    assert ulysses.sequence_parallel == 1
    assert (ulysses.mean_loss, ulysses.loss_first_window, ulysses.loss_last_window) == (
        flash.mean_loss, flash.loss_first_window, flash.loss_last_window)
