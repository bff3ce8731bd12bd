"""The dropout mask read back out of the attention's plain versions is the hash.

The probe of ``tests/torch_dropout_probe.py`` (q = k = 0, v the identity on
one 64-key tile, Dh 64) turns the unnormalized accumulator into the dropped
p of every (row, col): bf16(1 / (1 - rate)) where the element is live and
kept, else exactly 0. Here it runs through ``flash_forward_plain`` (K1's
plain version, reached through ``flash_fwd`` on CPU tensors) and
``_block_stats_plain`` (K4's, through ``ring_fwd_block``) at the global
coordinates the card tests use, and the mask it reads is compared bit for
bit with the port's ``dropout_keep`` and the JAX package's ``_dropout_keep``
on the same coordinates. The backward probes (lse = delta = 0, q = 0; dO the
identity on one q tile for dk/dv, k the identity on one key tile with dp = 1
for dq) read the dropped p^T out of dv and the dropped ds out of dq through
``flash_bwd_dkv_plain`` and ``flash_bwd_dq_plain`` (K3's and K2's plain
versions, through the wrappers), with identity offsets and with the ring's.
``tests/test_torch_kernels_cuda.py`` applies the same extraction to the
kernels on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_dropout_probe as probe
from distributed_llm_training_benchmark_framework_tpu.ops import flash_attention as jfa
from distributed_llm_training_benchmark_framework_tpu_torch.ops import flash_attention as tfa
from distributed_llm_training_benchmark_framework_tpu_torch.ops import ring_attention as ra

CPU = torch.device("cpu")


def _jax_keep(seed, bh, rows, cols, rate):
    """JAX's mask on (bh, row, col) = (bh[:, None, None], rows[None, :, None],
    cols[None, None, :]) as a torch bool tensor."""
    keep = jfa._dropout_keep(
        jnp.uint32(seed), jnp.asarray(bh.numpy()[:, None, None], jnp.int32),
        jnp.asarray(rows.numpy()[None, :, None], jnp.int32),
        jnp.asarray(cols.numpy()[None, None, :], jnp.int32), jfa._dropout_threshold(rate),
    )
    return torch.from_numpy(np.array(keep))


def _masks(seed, bh, rows, cols, rate, causal):
    """(port's keep & live, JAX's keep & live)."""
    live = probe.live_mask(rows, cols, causal)
    port = tfa.dropout_keep(seed, bh[:, None, None], rows[None, :, None], cols[None, None, :],
                            tfa.dropout_threshold(rate))
    return port & live, _jax_keep(seed, bh, rows, cols, rate) & live


@pytest.mark.parametrize("s,causal,rate", [(64, False, 0.1), (64, True, 0.1), (64, False, 0.5),
                                           (64, True, 0.5), (128, True, 0.3)])
def test_flash_plain_dropout_mask_reads_back_as_the_hash(s, causal, rate):
    seed, bh = 0x2545F491, 3
    tiles = torch.arange(s // 64) * 64
    bh_ids = torch.arange(bh)
    for t in range(s // 64):
        out, l = probe.flash_probe(bh, s, t, causal, rate, seed, CPU)
        rows, cols, all_cols = probe.coords(tiles, tiles, t, CPU)
        want, want_jax = _masks(seed, bh_ids, rows, cols, rate, causal)
        assert torch.equal(want, want_jax)
        assert torch.equal(out != 0, want)
        want_l = probe.live_mask(rows, all_cols, causal).sum(-1).float().expand(bh, s)
        torch.testing.assert_close(l, want_l, rtol=1e-5, atol=0)
        o = out.float() * l[..., None]
        torch.testing.assert_close(o, want * probe.kept_value(rate), rtol=2 ** -7, atol=0)
        assert 0 < int(want.sum()) < want.numel()


RING_CASES = {
    # (qoff, koff) of 4 shards of 128 rows: (contiguous?, my shard, source shard)
    "contiguous past shard": (False, 2, 1),
    "zigzag half-chunk pair": (True, 1, 2),
    "diagonal": (False, 2, 2),
    "wholly in the future": (False, 0, 3),
}


@pytest.mark.parametrize("name", list(RING_CASES))
@pytest.mark.parametrize("causal,rate", [(True, 0.1), (True, 0.5), (False, 0.3)])
def test_ring_plain_dropout_mask_reads_back_as_the_hash(name, causal, rate):
    seed = 0x9E3779B9
    zig, my, src = RING_CASES[name]
    tiles = ra._shard_tiles(4, 128, zig, CPU)
    qo, ko = tiles[my], tiles[src]
    bhv = ra._global_bh_vec(1, 3, 1, 2, 8)  # global batch*head ids 10, 11, 12
    for t in range(ko.numel()):
        m, l, o = probe.ring_probe(qo, ko, bhv, t, causal, rate, seed, CPU)
        rows, cols, all_cols = probe.coords(qo, ko, t, CPU)
        want, want_jax = _masks(seed, bhv.long(), rows, cols, rate, causal)
        assert torch.equal(want, want_jax)
        assert torch.equal(o, want * probe.kept_value(rate))
        row_live = probe.live_mask(rows, all_cols, causal)
        assert torch.equal(l, row_live.sum(-1).float().expand_as(l))
        assert torch.equal(m, torch.where(row_live.any(-1), 0.0, ra.NEG_INF).expand_as(m))
    if name == "wholly in the future" and causal:
        assert m.eq(ra.NEG_INF).all() and l.eq(0).all() and o.eq(0).all()


def _bwd_masks(kernel, seed, bh, qoff, koff, tile, rate, causal):
    """(port's, JAX's) keep & live mask in the layout of the probe's read-back."""
    rows, cols, transposed = probe.bwd_coords(kernel, qoff, koff, tile, CPU)
    port, jax_ = _masks(seed, bh, rows, cols, rate, causal)
    return (port.transpose(1, 2), jax_.transpose(1, 2)) if transposed else (port, jax_)


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("s,causal,rate", [(64, False, 0.1), (64, True, 0.1), (64, False, 0.5),
                                           (64, True, 0.5), (128, True, 0.3), (128, False, 0.1)])
def test_flash_bwd_plain_dropout_mask_reads_back_as_the_hash(kernel, s, causal, rate):
    seed, bh = 0x2545F491, 3
    tiles = torch.arange(s // 64) * 64
    for t in range(s // 64):
        got, value, dk = probe.bwd_probe(kernel, bh, s, t, causal, rate, seed, CPU)
        want, want_jax = _bwd_masks(kernel, seed, torch.arange(bh), tiles, tiles, t, rate, causal)
        assert torch.equal(want, want_jax)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.float(), want * value)
        assert dk is None or dk.eq(0).all()
        assert 0 < int(want.sum()) < want.numel()


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("name", list(RING_CASES))
@pytest.mark.parametrize("causal,rate", [(True, 0.1), (True, 0.5), (False, 0.3)])
def test_ring_bwd_plain_dropout_mask_reads_back_as_the_hash(kernel, name, causal, rate):
    seed = 0x9E3779B9
    zig, my, src = RING_CASES[name]
    tiles = ra._shard_tiles(4, 128, zig, CPU)
    qo, ko = tiles[my], tiles[src]
    bhv = ra._global_bh_vec(1, 3, 1, 2, 8)  # global batch*head ids 10, 11, 12
    for t in range(2):
        got, value, dk = probe.bwd_probe(kernel, 3, 128, t, causal, rate, seed, CPU,
                                         (qo, ko, bhv), torch.float32)
        want, want_jax = _bwd_masks(kernel, seed, bhv.long(), qo, ko, t, rate, causal)
        assert torch.equal(want, want_jax)
        assert got.dtype == torch.float32
        assert torch.equal(got, want * value)
        assert dk is None or dk.eq(0).all()
        if name == "wholly in the future" and causal:
            assert got.eq(0).all()
