"""The port's ring attention against the JAX package's, on the CPU.

JAX runs its ring under a 4-device ``seq`` mesh of virtual CPU devices (the
``eight_devices`` fixture, as tests/test_attention_ops.py does), on its
einsum block path. The port holds its 4 shards in one process and runs the
plain versions of its ring kernels, because the tensors lie on the CPU.
Inputs come from ``np.random.default_rng``; the dropout seed is the same
uint32 on both sides, so the masks agree bit for bit. Tolerances are JAX's
own for its ring (tests/test_attention_ops.py): 2e-3 for the output and
loss, 5e-3 for gradients.
"""

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_llm_training_benchmark_framework_tpu.analysis.validate_results import (
    validate_result,
)
from distributed_llm_training_benchmark_framework_tpu.models import llama as jllama
from distributed_llm_training_benchmark_framework_tpu.models import tinygpt as jtiny
from distributed_llm_training_benchmark_framework_tpu.ops import ring_attention as jra
from distributed_llm_training_benchmark_framework_tpu.parallel import make_mesh as jmake_mesh
from distributed_llm_training_benchmark_framework_tpu_torch import bridge
from distributed_llm_training_benchmark_framework_tpu_torch.models import TinyGPT, get_config
from distributed_llm_training_benchmark_framework_tpu_torch.ops import _build
from distributed_llm_training_benchmark_framework_tpu_torch.ops import flash_attention as tfa
from distributed_llm_training_benchmark_framework_tpu_torch.ops import ring_attention as tra
from distributed_llm_training_benchmark_framework_tpu_torch.parallel import make_mesh
from distributed_llm_training_benchmark_framework_tpu_torch.train import run_benchmark

from torch_seq_parallel_worker import spawn_ranks, wait_ranks
from torch_threads import one_thread  # noqa: F401  (autouse)

REPO = Path(__file__).resolve().parents[1]
N = 4  # sequence shards
SEED = 555
CASES = [(c, zz, r) for c in (False, True) for zz in (False, True) for r in (0.0, 0.25)]


def _inputs(B, S, H, D, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, D)).astype(np.float32) for _ in range(4)]


def _torch_out_and_grads(fn, q, k, v, do):
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = fn(tq, tk, tv)
    grads = torch.autograd.grad((out * torch.from_numpy(do)).sum(), (tq, tk, tv))
    return out.detach().numpy(), [g.numpy() for g in grads]


def _jax_ring_out_and_grads(q, k, v, do, devices, **kw):
    mesh = jmake_mesh((N,), ("seq",), devices=devices[:N])

    def f(q, k, v, do):
        ring = lambda a, b, c: jra.ring_attention(a, b, c, mesh=mesh, **kw)  # noqa: E731
        out, vjp = jax.vjp(ring, q, k, v)
        return out, vjp(do)

    with jax.set_mesh(mesh):
        out, grads = jax.jit(f)(*(jnp.asarray(a) for a in (q, k, v, do)))
    return np.asarray(out), [np.asarray(g) for g in grads]


def _assert_out_and_grads(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=2e-3, atol=2e-3, err_msg="out")
    for a, b, name in zip(got[1], want[1], ("dq", "dk", "dv")):
        np.testing.assert_allclose(a, b, rtol=5e-3, atol=5e-3, err_msg=name)


@pytest.mark.parametrize("causal,zigzag,rate", CASES)
def test_ring_matches_jax_ring(causal, zigzag, rate, eight_devices):
    q, k, v, do = _inputs(2, 64, 2, 16)
    kw = dict(causal=causal, dropout_rate=rate, zigzag=zigzag)
    want = _jax_ring_out_and_grads(q, k, v, do, eight_devices, dropout_seed=jnp.uint32(SEED),
                                   **kw)
    got = _torch_out_and_grads(
        lambda a, b, c: tra.ring_attention(a, b, c, seq_shards=N, dropout_seed=SEED, **kw),
        q, k, v, do)
    _assert_out_and_grads(got, want)


def test_ring_matches_jax_ring_with_kernel_sized_tiles(eight_devices):
    """S 512 over 4 shards: zigzag half-chunks of 64 rows, so the port passes
    64-row tile bases, as on the card."""
    q, k, v, do = _inputs(1, 512, 2, 16, seed=1)
    kw = dict(causal=True, dropout_rate=0.25)
    want = _jax_ring_out_and_grads(q, k, v, do, eight_devices, dropout_seed=jnp.uint32(SEED),
                                   **kw)
    got = _torch_out_and_grads(
        lambda a, b, c: tra.ring_attention(a, b, c, seq_shards=N, dropout_seed=SEED, **kw),
        q, k, v, do)
    _assert_out_and_grads(got, want)


@pytest.mark.parametrize("causal,zigzag,rate", CASES + [(True, None, 0.25), (False, None, 0.0)])
def test_ring_matches_port_flash(causal, zigzag, rate):
    q, k, v, do = _inputs(2, 128, 2, 32, seed=2)
    kw = dict(causal=causal, dropout_rate=rate, dropout_seed=SEED)
    got = _torch_out_and_grads(
        lambda a, b, c: tra.ring_attention(a, b, c, seq_shards=N, zigzag=zigzag, **kw),
        q, k, v, do)
    want = _torch_out_and_grads(lambda a, b, c: tfa.flash_attention_plain(a, b, c, **kw),
                                q, k, v, do)
    _assert_out_and_grads(got, want)


def test_one_shard_is_flash():
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs(1, 64, 2, 16))
    out = tra.ring_attention(q, k, v, causal=True, seq_shards=1)
    torch.testing.assert_close(out, tfa.flash_attention(q, k, v, causal=True), rtol=0, atol=0)


@pytest.mark.parametrize("n,h", [(4, 8), (3, 64)])
def test_coordinate_helpers_match_jax(n, h):
    for c in range(n):
        bases = tra._zig_chunk_bases(c, n, h)
        assert bases == tuple(int(b) for b in jra._zig_chunk_bases(c, n, h))
        for b in (1, h // 2, h):
            np.testing.assert_array_equal(tra._bases_to_tiles(bases, h, b).numpy(),
                                          np.asarray(jra._bases_to_tiles(bases, h, b)))
        np.testing.assert_array_equal(tra._bases_to_rows(bases, h).numpy(),
                                      np.asarray(jra._bases_to_rows(bases, h)))
    np.testing.assert_array_equal(tra._global_bh_vec(2, 3, 4, 1, 6).numpy(),
                                  np.asarray(jra._global_bh_vec(2, 3, 4, 1, 6)))


@pytest.mark.parametrize("shape", [(2, 4 * 6, 3), (2, 4 * 6)])
def test_zig_exchange_matches_jax(shape, eight_devices):
    """Both directions, on (BH, S, D) blocks and on (BH, S) rows (delta)."""
    x = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    mesh = jmake_mesh((N,), ("seq",), devices=eight_devices[:N])
    spec = P(None, "seq")
    ring = tra._LocalRing(N)
    for inverse in (False, True):
        body = lambda t: jra._zig_exchange(t, "seq", N, jax.lax.axis_index("seq"),  # noqa: E731
                                           inverse=inverse)
        with jax.set_mesh(mesh):
            want = jax.shard_map(body, mesh=mesh, in_specs=spec, out_specs=spec)(jnp.asarray(x))
        got = ring.join(tra._zig_exchange(ring, ring.split(torch.from_numpy(x)), inverse))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    back = tra._zig_exchange(ring, tra._zig_exchange(ring, ring.split(torch.from_numpy(x))), True)
    np.testing.assert_array_equal(ring.join(back).numpy(), x)


def test_zigzag_and_tile_checks():
    """JAX's argument checks, and the card's 64-row tile rule."""
    assert tra._resolve_zigzag(None, True, 4, 16, on_card=False)
    assert not tra._resolve_zigzag(None, False, 4, 16, on_card=False)
    assert not tra._resolve_zigzag(None, True, 4, 15, on_card=False)
    assert not tra._resolve_zigzag(True, True, 1, 16, on_card=False)
    with pytest.raises(ValueError, match="even local shard"):
        tra._resolve_zigzag(True, True, 4, 15, on_card=False)
    # On the card a chunk must hold whole 64-row tiles. Auto resolves as it
    # does on the CPU and in JAX, so a zigzag half-chunk the kernels cannot
    # tile is refused, with or without zigzag=True, and never silently swapped
    # for the contiguous layout; zigzag=False keeps the whole shard.
    with pytest.raises(ValueError, match="zigzag=False keeps whole shards"):
        tra._resolve_zigzag(None, True, 4, 192, on_card=True)
    assert not tra._resolve_zigzag(False, True, 4, 192, on_card=True)
    assert tra._resolve_zigzag(None, True, 4, 192, on_card=False)
    assert tra._resolve_zigzag(None, True, 4, 256, on_card=True)
    with pytest.raises(ValueError, match="multiple of 64"):
        tra._resolve_zigzag(True, True, 4, 192, on_card=True)
    with pytest.raises(ValueError, match="multiple of 64"):
        tra._resolve_zigzag(None, False, 4, 96, on_card=True)
    q = torch.zeros(1, 66, 2, 16)
    with pytest.raises(ValueError, match="does not split"):
        tra.ring_attention(q, q, q, seq_shards=4)


def test_ring_wrappers_refuse_non_cpu_tensors_and_count_nothing_on_cpu():
    q = torch.empty((2, 64, 64), dtype=torch.bfloat16, device="meta")
    tiles = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tra.ring_fwd_block(q, q, q, False, 0.0, 0, tiles, tiles, None)
    stats = q[..., 0].float()
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd_dq(q, q, q, q, stats, stats, False, 0.0, 0, out_dtype=torch.float32)
    tfa.reset_launch_counts()
    a, b, c, _ = (torch.from_numpy(x).requires_grad_(True) for x in _inputs(1, 64, 2, 16))
    tra.ring_attention(a, b, c, causal=True, seq_shards=N).sum().backward()
    assert tra.launch_counts() == {"ring_fwd_block": 0, "flash_bwd_dq_ring": 0,
                                   "flash_bwd_dkv_ring": 0}
    assert set(tfa.launch_counts().values()) == {0}


def test_launch_counts_have_one_record_and_one_reset():
    """The backward kernels' fp32 modes count as K2′/K3′ on the ring and not
    on the flash path; one reset zeroes every count."""
    tfa.reset_launch_counts()
    for mode in ("ring_fwd_block", "flash_bwd_dq_fp32", "flash_bwd_dkv_fp32", "flash_bwd_dkv"):
        _build.launched(mode)
    assert tra.launch_counts() == {"ring_fwd_block": 1, "flash_bwd_dq_ring": 1,
                                   "flash_bwd_dkv_ring": 1}
    assert tfa.launch_counts() == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 1}
    tfa.reset_launch_counts()
    assert set(tra.launch_counts().values()) == set(tfa.launch_counts().values()) == {0}


def test_plain_backward_writes_the_requested_dtype():
    q, k, v, do = (torch.from_numpy(a[0]).to(torch.bfloat16) for a in _inputs(1, 64, 2, 64))
    out, lse = tfa.flash_forward_plain(q, k, v, True, 0.0, 0)
    args = (q, k, v, do, lse, tfa.attention_delta(out, do), True, 0.0, 0)
    assert tfa.flash_bwd_dq(*args).dtype == torch.bfloat16
    dq32 = tfa.flash_bwd_dq(*args, out_dtype=torch.float32)
    assert dq32.dtype == torch.float32
    torch.testing.assert_close(dq32.to(torch.bfloat16), tfa.flash_bwd_dq(*args), rtol=0, atol=0)
    assert {t.dtype for t in tfa.flash_bwd_dkv(*args, out_dtype=torch.float32)} == {torch.float32}


_GLOO_WORKER = """
import sys
import numpy as np
import torch
import torch.distributed as dist
from distributed_llm_training_benchmark_framework_tpu_torch.ops.ring_attention import (
    ring_attention_sharded,
)

rank, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2, rank=rank)
data = np.load(path)
Sl = data["q"].shape[1] // 2
res = {}
for name, causal, zigzag, rate in (("zig", True, None, 0.25), ("cont", False, False, 0.25)):
    q, k, v = (torch.from_numpy(data[x][:, rank * Sl:(rank + 1) * Sl].copy()).requires_grad_(True)
               for x in "qkv")
    do = torch.from_numpy(data["do"][:, rank * Sl:(rank + 1) * Sl].copy())
    out = ring_attention_sharded(q, k, v, causal=causal, dropout_rate=rate, dropout_seed=555,
                                 zigzag=zigzag)
    grads = torch.autograd.grad((out * do).sum(), (q, k, v))
    res[name] = out.detach().numpy()
    for g, x in zip(grads, "qkv"):
        res[name + "_d" + x] = g.numpy()
dist.destroy_process_group()
np.savez(f"{path}.rank{rank}.npz", **res)
"""


def test_sharded_form_over_gloo_matches_one_process_form(tmp_path):
    """Two gloo ranks on localhost, one shard each, against the one-process
    ring over the same two shards: the zigzag exchange and every hop's
    point-to-point send must move the same blocks."""
    q, k, v, do = _inputs(1, 128, 2, 16, seed=4)
    path = tmp_path / "inputs.npz"
    np.savez(path, q=q, k=k, v=v, do=do)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO_WORKER, str(r), str(port), str(path)],
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err[-3000:]
    ranks = [np.load(f"{path}.rank{r}.npz") for r in range(2)]
    for name, causal, zigzag in (("zig", True, None), ("cont", False, False)):
        want = _torch_out_and_grads(
            lambda a, b, c: tra.ring_attention(a, b, c, causal=causal, dropout_rate=0.25,
                                               dropout_seed=SEED, seq_shards=2, zigzag=zigzag),
            q, k, v, do)
        got = (np.concatenate([r[name] for r in ranks], axis=1),
               [np.concatenate([r[f"{name}_d{x}"] for r in ranks], axis=1) for x in "qkv"])
        np.testing.assert_allclose(got[0], want[0], rtol=1e-5, atol=1e-5, err_msg=name)
        for a, b in zip(got[1], want[1]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5, err_msg=name)


JAX_CONFIG = {"tinygpt": jtiny.get_model_config, "llama": jllama.get_llama_config}


@pytest.mark.parametrize("family", ["tinygpt", "llama"])
def test_ring_model_matches_flash_model_and_jax_ring_model(family, eight_devices):
    """Tier S, 4 shards, dropout 0, the bridge's weights: the port's ring
    model against its flash model and against the JAX model running its
    ring under a 4-way ``seq`` mesh; loss and every gradient."""
    S = 64
    jc = JAX_CONFIG[family]("S", S, dropout=0.0, compute_dtype=jnp.float32,
                            attention_impl="ring")
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

    ring_model, ring_loss = port("ring", make_mesh((N,), ("seq",)))
    assert ring_model.attention.func is tra.ring_attention
    assert ring_model.attention.keywords["seq_shards"] == N
    flash_model, flash_loss = port("flash")
    np.testing.assert_allclose(ring_loss, float(j_loss), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(ring_loss, flash_loss, rtol=2e-3, atol=2e-3)
    flash_grads = dict(bridge.leaf_map(flash_model))
    for path, p in bridge.leaf_map(ring_model):
        want = j_grads[path[0]] if len(path) == 1 else j_grads["blocks"][path[1]][path[2]]
        name = "/".join(map(str, path))
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=5e-3, atol=5e-3, err_msg=name)
        np.testing.assert_allclose(p.grad.numpy(), flash_grads[path].grad.numpy(),
                                   rtol=5e-3, atol=5e-3, err_msg=name)


@pytest.mark.parametrize("family,causal,zigzag,stamp", [
    ("tinygpt", False, None, "auto"), ("tinygpt", True, False, "off"), ("llama", False, True, "on"),
])
def test_run_benchmark_ring_row_validates(family, causal, zigzag, stamp):
    # One sync window for the timed steps: a CPU host's step-time spread is
    # not the device stability that the validator's cv envelope reads.
    r = run_benchmark(tier="S", seq_len=64, steps=3, warmup_steps=1, device="cpu",
                      model_family=family, sequence_parallel=N, attention_impl="ring",
                      causal=causal, ring_zigzag=zigzag)
    row = r.to_dict()
    assert (row["attention_impl"], row["sequence_parallel"], row["ring_zigzag"]) == (
        "ring", N, stamp)
    assert row["causal"] == (causal or family == "llama")
    assert row["world_size"] == 1  # all four shards ran on one device
    assert validate_result(row, f"ring {family}") == []


@pytest.mark.parametrize("kw,match", [
    (dict(sequence_parallel=4, attention_impl="flash"), "requires attention_impl 'ring'"),
    (dict(sequence_parallel=4, attention_impl="reference"), "requires attention_impl 'ring'"),
    (dict(attention_impl="flash", ring_zigzag=True), "requires attention_impl 'ring'"),
    (dict(attention_impl="flash", ring_zigzag=False), "requires attention_impl 'ring'"),
    (dict(attention_impl="ring", ring_zigzag=True), "sequence_parallel > 1"),
    (dict(attention_impl="ring", sequence_parallel=0), ">= 1"),
])
def test_run_benchmark_refuses_what_jax_refuses(kw, match):
    with pytest.raises(ValueError, match=match):
        run_benchmark(tier="S", seq_len=64, steps=2, warmup_steps=1, device="cpu", **kw)


def test_sharded_form_over_data_and_seq_keys_the_batch_offset(tmp_path):
    """Four gloo ranks laid out (data 2, seq 2) by ``make_mesh``
    (``tests/torch_seq_parallel_worker.py``): rank (d, s) runs
    ``ring_attention_sharded`` on row d and columns s of the batch over its
    ``seq`` group, keyed by its batch offset d, at rate 0.1. Together they
    equal the one-process ring over both rows, bit for bit (the same blocks
    in the same order). This case fails on the parent tree, whose sharded
    ring keyed every rank's rows from batch index 0, so that both ``data``
    ranks drew row 0's mask."""
    q, k, v, do = _inputs(2, 64, 4, 16, seed=3)
    np.savez(tmp_path / "inputs.npz", q=q, k=k, v=v, do=do)
    wait_ranks(spawn_ranks(4, tmp_path / "inputs.npz", tmp_path / "w4", "attention"))
    ranks = [np.load(tmp_path / f"w4.rank{r}.npz") for r in range(4)]
    want = _torch_out_and_grads(
        lambda a, b, c: tra.ring_attention(a, b, c, dropout_rate=0.1, dropout_seed=SEED,
                                           seq_shards=2), q, k, v, do)
    for i, name in enumerate(("out", "dq", "dk", "dv")):
        got = np.concatenate([np.concatenate([ranks[2 * d + s][f"dseq.ring.{name}"]
                                              for s in range(2)], axis=1) for d in range(2)])
        np.testing.assert_array_equal(got, want[0] if i == 0 else want[1][i - 1], err_msg=name)
