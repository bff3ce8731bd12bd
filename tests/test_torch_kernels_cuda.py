"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: on a host without a CUDA device each test skips with that
reason (the CUDA kernels have no CPU mode; the CPU tests hold the plain
versions against JAX instead). On the card:

    python -m pytest tests/test_torch_kernels_cuda.py -q

Tolerances: rel-Frobenius 2e-2 for bf16 outputs and gradients and for the
ring kernels' fp32 o and partials, 1e-3 absolute for the fp32 lse and the
ring block's m and l (the kernels and the plain versions sum in different
orders; a dropout mask that differed anywhere would show as an O(1) error).
"""

import pytest
import torch

from distributed_llm_training_benchmark_framework_tpu_torch.ops import flash_attention as fa
from distributed_llm_training_benchmark_framework_tpu_torch.ops import ring_attention as ra

pytestmark = pytest.mark.cuda
CASES = [(d, causal, rate) for d in (64, 128) for causal in (False, True) for rate in (0.0, 0.1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the flash kernels run only on the card)")
    return torch.device("cuda")


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.parametrize("d,causal,rate", CASES)
def test_kernels_match_plain(cuda, d, causal, rate):
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, do = (torch.randn(4, 256, d, device=cuda, generator=g).to(torch.bfloat16)
                   for _ in range(4))
    out, lse = fa.flash_fwd(q, k, v, causal, rate, 77)
    p_out, p_lse = fa.flash_forward_plain(q, k, v, causal, rate, 77)
    assert _rel(out, p_out) <= 2e-2
    assert (lse - p_lse).abs().max().item() <= 1e-3
    delta = fa.attention_delta(p_out, do)
    args = (q, k, v, do, p_lse, delta, causal, rate, 77)
    assert _rel(fa.flash_bwd_dq(*args), fa.flash_bwd_dq_plain(*args)) <= 2e-2
    for got, want in zip(fa.flash_bwd_dkv(*args), fa.flash_bwd_dkv_plain(*args)):
        assert _rel(got, want) <= 2e-2


def test_autograd_function_matches_plain_autograd(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(2, 128, 4, 64, device=cuda, generator=g).to(torch.bfloat16)
               .requires_grad_(True) for _ in range(3))
    before = fa.launch_counts()
    out = fa.flash_attention(q, k, v, causal=True, dropout_rate=0.1, dropout_seed=5)
    grads = torch.autograd.grad(out.float().square().sum(), (q, k, v))
    ref = fa.flash_attention_plain(q, k, v, causal=True, dropout_rate=0.1, dropout_seed=5)
    ref_grads = torch.autograd.grad(ref.float().square().sum(), (q, k, v))
    assert _rel(out, ref) <= 2e-2
    for a, b in zip(grads, ref_grads):
        assert _rel(a, b) <= 2e-2
    after = fa.launch_counts()
    assert all(after[n] == before[n] + 1 for n in after)


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(2, 96, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple"):
        fa.flash_fwd(x, x, x, False, 0.0, 0)
    y = torch.zeros(2, 128, 32, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_fwd(y, y, y, False, 0.0, 0)
    z = torch.zeros(2, 128, 64, device=cuda, dtype=torch.float32)
    with pytest.raises(ValueError, match="bfloat16"):
        fa.flash_fwd(z, z, z, False, 0.0, 0)
    w = z.to(torch.bfloat16)
    bad_lse = torch.zeros(2, 64, device=cuda)
    with pytest.raises(ValueError, match="row statistics"):
        fa.flash_bwd_dq(w, w, w, w, bad_lse, bad_lse, False, 0.0, 0)


RING_CASES = [(d, causal, rate, zig) for d in (64, 128) for causal, zig in
              ((False, False), (True, False), (True, True)) for rate in (0.0, 0.1)]


@pytest.mark.parametrize("d,causal,rate,zig", RING_CASES)
def test_ring_kernels_match_plain(cuda, d, causal, rate, zig):
    """K4, K2′ and K3′ on one ring block at the hops of shards 1 and 2 of 4,
    with zigzag offsets or contiguous ones; contiguous causal hops include
    blocks wholly in the shard's future (every tile skipped)."""
    n, BH, Sl = 4, 3, 256
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v, do = (torch.randn(BH, Sl, d, device=cuda, generator=g).to(torch.bfloat16)
                   for _ in range(4))
    delta = 0.1 * torch.randn(BH, Sl, device=cuda, generator=g)
    bhv = ra._global_bh_vec(1, BH, 0, 0, BH, cuda)
    tiles = ra._shard_tiles(n, Sl, zig, cuda)
    for my in (1, 2):
        for src in range(n):
            qo, ko = tiles[my], tiles[src]
            rows, cols = fa._tile_coords(qo, Sl, cuda), fa._tile_coords(ko, Sl, cuda)
            m, l, o = ra.ring_fwd_block(q, k, v, causal, rate, 77, qo, ko, bhv)
            pm, pl, po = ra._block_stats_plain(q, k, v, 77, rows, cols, bhv, causal, rate)
            assert (m - pm).abs().max().item() <= 1e-3
            assert (l - pl).abs().max().item() <= 1e-3
            lse = torch.where(pl > 0, pm + torch.log(pl), 0.0)
            args = (q, k, v, do, lse, delta, causal, rate, 77, qo, ko, bhv)
            dq = fa.flash_bwd_dq(*args, out_dtype=torch.float32)
            dk, dv = fa.flash_bwd_dkv(*args, out_dtype=torch.float32)
            assert dq.dtype == dk.dtype == dv.dtype == torch.float32
            got = (o, dq, dk, dv)
            if causal and rows.max() < cols.min():  # wholly in the future
                assert m.eq(ra.NEG_INF).all() and l.eq(0).all()
                assert all(t.eq(0).all() for t in got)
                continue
            want = (po, fa.flash_bwd_dq_plain(*args, out_dtype=torch.float32),
                    *fa.flash_bwd_dkv_plain(*args, out_dtype=torch.float32))
            for a, b in zip(got, want):
                assert _rel(a, b) <= 2e-2


@pytest.mark.parametrize("causal,zigzag,rate", [(False, False, 0.1), (True, None, 0.0),
                                                (True, False, 0.1)])
def test_ring_attention_matches_flash_on_the_card(cuda, causal, zigzag, rate):
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(2, 1024, 4, 64, device=cuda, generator=g).to(torch.bfloat16)
               .requires_grad_(True) for _ in range(3))
    fa.reset_launch_counts()
    out = ra.ring_attention(q, k, v, causal=causal, dropout_rate=rate, dropout_seed=9,
                            seq_shards=4, zigzag=zigzag)
    grads = torch.autograd.grad(out.float().square().sum(), (q, k, v))
    assert ra.launch_counts() == {"ring_fwd_block": 16, "flash_bwd_dq_ring": 16,
                                  "flash_bwd_dkv_ring": 16}
    assert set(fa.launch_counts().values()) == {0}
    ref = fa.flash_attention(q, k, v, causal=causal, dropout_rate=rate, dropout_seed=9)
    ref_grads = torch.autograd.grad(ref.float().square().sum(), (q, k, v))
    assert _rel(out, ref) <= 2e-2
    for a, b in zip(grads, ref_grads):
        assert _rel(a, b) <= 2e-2


def test_ring_refuses_chunks_the_kernels_cannot_tile(cuda):
    x = torch.zeros(1, 4 * 96, 2, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 64"):
        ra.ring_attention(x, x, x, causal=True, seq_shards=4)  # shard of 96 rows
    y = torch.zeros(1, 4 * 192, 2, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 64"):
        ra.ring_attention(y, y, y, causal=True, seq_shards=4, zigzag=True)  # halves of 96
    with pytest.raises(ValueError, match="zigzag=False"):
        ra.ring_attention(y, y, y, causal=True, seq_shards=4)  # auto picks zigzag here too
