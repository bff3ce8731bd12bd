"""The port's flash attention against the JAX package's, on the CPU.

JAX runs its Pallas kernels in interpret mode (forward, and the backward
kernels with ``pallas_backward=True``) or its blockwise einsum backward
(``False``), as tests/test_attention_ops.py runs them. The port runs with
CPU tensors, which means its plain PyTorch versions. Inputs come from
``np.random.default_rng``; the dropout seed is the same uint32 on both
sides, so the masks agree bit for bit. Tolerances are that file's: 2e-3
for an fp32 forward, 3e-2 for bf16, 5e-3 for gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_training_benchmark_framework_tpu.ops import flash_attention as jfa
from distributed_llm_training_benchmark_framework_tpu_torch.ops import flash_attention as tfa
from torch_threads import one_thread  # noqa: F401  (autouse)

B, S, H = 1, 64, 2
SEED = 0xC0FFEE
CASES = [(d, causal, rate) for d in (64, 128) for causal in (False, True) for rate in (0.0, 0.1)]


def _inputs(d, n=4, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, H, d)).astype(np.float32) for _ in range(n)]


def _jax_flash(q, k, v, causal, rate, pallas_backward=None):
    return jfa.flash_attention(
        q, k, v, causal=causal, interpret=True, block_q=32, block_k=32, block_k_bwd=32,
        pallas_backward=pallas_backward, dropout_rate=rate, dropout_seed=jnp.uint32(SEED),
    )


@pytest.mark.parametrize("d,causal,rate", CASES)
def test_forward_out_and_lse_match_jax(d, causal, rate):
    q, k, v, _ = _inputs(d)
    bhsd = lambda a: a.transpose(0, 2, 1, 3).reshape(B * H, S, d)
    j_out, j_lse = jfa._flash_forward(
        *(jnp.asarray(bhsd(a)) for a in (q, k, v)), causal, True, 32, 32, rate,
        jnp.asarray([SEED], jnp.uint32),
    )
    t_out, t_lse = tfa.flash_fwd(*(torch.from_numpy(bhsd(a)) for a in (q, k, v)),
                                 causal, rate, SEED)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(t_lse.numpy(), np.asarray(j_lse), rtol=2e-3, atol=2e-3)
    out = tfa.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)), causal=causal,
                              dropout_rate=rate, dropout_seed=SEED)
    np.testing.assert_allclose(out.numpy(), np.asarray(_jax_flash(q, k, v, causal, rate)),
                               rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("causal,rate", [(False, 0.1), (True, 0.0)])
def test_forward_bf16_matches_jax(causal, rate):
    q, k, v, _ = _inputs(64, seed=1)
    j = _jax_flash(*(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), causal, rate)
    t = tfa.flash_attention(*(torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v)),
                            causal=causal, dropout_rate=rate, dropout_seed=SEED)
    assert t.dtype == torch.bfloat16
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               rtol=3e-2, atol=3e-2)


@pytest.mark.parametrize("pallas_backward", [True, False])
@pytest.mark.parametrize("d,causal,rate", CASES)
def test_backward_matches_jax_grad(d, causal, rate, pallas_backward):
    q, k, v, do = _inputs(d, seed=2)

    def jloss(q, k, v):
        return (_jax_flash(q, k, v, causal, rate, pallas_backward) * do).sum()

    jg = jax.grad(jloss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, causal=causal, dropout_rate=rate, dropout_seed=SEED)
    (out * torch.from_numpy(do)).sum().backward()
    for t, g in zip((tq, tk, tv), jg):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=5e-3, atol=5e-3)


def test_kernel_wrappers_refuse_non_cpu_tensors_without_cuda():
    """A tensor that is not on the CPU goes to the kernel or raises; it never
    falls back to the plain version."""
    q = torch.empty((2, 64, 64), dtype=torch.bfloat16, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd(q, q, q, False, 0.0, 0)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd_dq(q, q, q, q, q[..., 0].float(), q[..., 0].float(), False, 0.0, 0)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd_dkv(q, q, q, q, q[..., 0].float(), q[..., 0].float(), False, 0.0, 0)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_attention(*(torch.empty((1, 64, 2, 64), device="meta") for _ in range(3)))


def test_launch_counters_do_not_move_on_the_cpu_path():
    tfa.reset_launch_counts()
    q, k, v, _ = _inputs(64)
    tfa.flash_attention(*(torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)),
                        causal=True).sum().backward()
    assert tfa.launch_counts() == {"flash_fwd": 0, "flash_bwd_dq": 0, "flash_bwd_dkv": 0}


def test_plain_backward_honours_tile_offsets():
    """Global tile bases and bh ids (the ring-attention arguments) shift the
    causal mask and the hash exactly like a slice of a longer sequence."""
    rng = np.random.default_rng(3)
    BH, S_full, d = 2, 128, 64
    q, k, v, do = (torch.from_numpy(rng.standard_normal((BH, S_full, d)).astype(np.float32))
                   for _ in range(4))
    out, lse = tfa.flash_forward_plain(q, k, v, True, 0.1, SEED)
    delta = tfa.attention_delta(out, do)
    full = tfa.flash_bwd_dq_plain(q, k, v, do, lse, delta, True, 0.1, SEED)
    # Rows 64..127 as a ring step would see them: one q tile at base 64,
    # against each 64-column k/v block at its own base; dq sums the two.
    half = slice(64, 128)
    part = sum(
        tfa.flash_bwd_dq_plain(
            q[:, half], k[:, cols], v[:, cols], do[:, half], lse[:, half], delta[:, half],
            True, 0.1, SEED, qoff=torch.tensor([64]), koff=torch.tensor([cols.start]),
        ).float()
        for cols in (slice(0, 64), slice(64, 128))
    )
    np.testing.assert_allclose(part.numpy(), full[:, half].numpy(), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("given", ["identity", "ring vectors"])
def test_offset_args_make_the_identity_once_and_pass_ring_vectors_through(given):
    """The kernels' int32 tile bases and batch*head ids: plain flash's
    identity is made once per shape and device (a launch adds no device
    operation for it), the ring's vectors go through as int32, and a
    vector of the wrong length is refused."""
    q = torch.zeros(3, 128, 64, dtype=torch.bfloat16)
    if given == "identity":
        first = tfa._offset_args(q, None, None, None)
        again = tfa._offset_args(q, None, None, None)
        assert [t.tolist() for t in first] == [[0, 64], [0, 64], [0, 1, 2]]
        assert all(a is b for a, b in zip(first, again))
    else:
        qoff, koff, bhv = torch.tensor([128, 192]), torch.tensor([0, 320]), torch.tensor([5, 6, 7])
        out = tfa._offset_args(q, qoff, koff, bhv)
        assert [t.dtype for t in out] == [torch.int32] * 3
        assert [t.tolist() for t in out] == [[128, 192], [0, 320], [5, 6, 7]]
    with pytest.raises(ValueError, match="offset vector"):
        tfa._offset_args(q, None, None, torch.arange(4, dtype=torch.int32))


@pytest.mark.parametrize("causal", [False, True])
def test_batch_offset_keys_the_mask_by_global_batch_head(causal):
    """A data-parallel rank's rows with ``batch_offset`` = its first global
    row drop exactly what one process drops on the whole batch: forward,
    and (through the autograd function, K2 / K3's plain versions with the
    global ids) every gradient."""
    rng = np.random.default_rng(5)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((4, S, H, 64)).astype(np.float32))
                   for _ in range(4))
    whole = tfa.flash_attention_plain(q, k, v, causal=causal, dropout_rate=0.1,
                                      dropout_seed=SEED)
    qw, kw, vw = (t.clone().requires_grad_(True) for t in (q, k, v))
    out_w = tfa.flash_attention(qw, kw, vw, causal=causal, dropout_rate=0.1, dropout_seed=SEED)
    grads_w = torch.autograd.grad(out_w, (qw, kw, vw), do)
    pd = 2
    for r in range(2):
        rows = slice(r * pd, (r + 1) * pd)
        part = tfa.flash_attention_plain(q[rows], k[rows], v[rows], causal=causal,
                                         dropout_rate=0.1, dropout_seed=SEED,
                                         batch_offset=r * pd)
        assert torch.equal(part, whole[rows])
        qr, kr, vr = (t[rows].clone().requires_grad_(True) for t in (q, k, v))
        out_r = tfa.flash_attention(qr, kr, vr, causal=causal, dropout_rate=0.1,
                                    dropout_seed=SEED, batch_offset=r * pd)
        assert torch.equal(out_r, out_w[rows])
        for g, gw in zip(torch.autograd.grad(out_r, (qr, kr, vr), do[rows]), grads_w):
            torch.testing.assert_close(g, gw[rows], rtol=1e-6, atol=1e-7)
    other = tfa.flash_attention_plain(q[2:], k[2:], v[2:], causal=causal, dropout_rate=0.1,
                                      dropout_seed=SEED)
    assert not torch.equal(other, whole[2:])  # without the offset rank 1 drops rank 0's mask


def test_k1_offset_seed_keys_local_ids_as_global_ones():
    """K1 takes no batch*head vector: it runs on ``offset_seed(seed, o)``,
    which must key local id bh exactly as the plain version keys bh + o."""
    q, k, v = (torch.from_numpy(a[0].transpose(1, 0, 2).copy()) for a in _inputs(64, 3))
    for o in (0, 2, 7, 2**31 + 5):
        direct, lse = tfa.flash_forward_plain(q, k, v, False, 0.25, SEED, bh_offset=o)
        folded, lse_f = tfa.flash_forward_plain(q, k, v, False, 0.25, tfa.offset_seed(SEED, o))
        assert torch.equal(direct, folded) and torch.equal(lse, lse_f)
    bh = torch.arange(6)[:, None, None]
    rows = torch.arange(8)[None, :, None]
    cols = torch.arange(8)[None, None, :]
    thr = tfa.dropout_threshold(0.5)
    for o in (1, 3, 1000):
        assert torch.equal(tfa.dropout_keep(SEED, bh + o, rows, cols, thr),
                           tfa.dropout_keep(tfa.offset_seed(SEED, o), bh, rows, cols, thr))
