"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: on a host without a CUDA device each test skips with that
reason (the CUDA kernels have no CPU mode; the CPU tests hold the plain
versions against JAX instead). On the card:

    python -m pytest tests/test_torch_kernels_cuda.py -q

Tolerances: rel-Frobenius 2e-2 for bf16 outputs and gradients (the flash
kernels and the microbench's forward variants K5-K9) and for the ring
kernels' fp32 o and partials, 1e-3 absolute for the fp32 lse and the
ring block's m and l (the kernels and the plain versions sum in different
orders; a dropout mask that differed anywhere would show as an O(1) error).
The matmul-only forward K8 has no softmax, so no online-rescale gap: 2e-3,
and bit for bit on integer inputs, where every sum is exact.
"""

import pytest
import torch

from distributed_llm_training_benchmark_framework_tpu_torch.ops import flash_attention as fa
from distributed_llm_training_benchmark_framework_tpu_torch.ops import fwd_variants as fv
from distributed_llm_training_benchmark_framework_tpu_torch.ops import ring_attention as ra
from distributed_llm_training_benchmark_framework_tpu_torch.ops import ulysses_attention as ua

import torch_dropout_probe as probe

pytestmark = pytest.mark.cuda
CASES = [(d, causal, rate, s) for d in (64, 128) for causal in (False, True) for rate in (0.0, 0.1)
         for s in (64, 256)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the flash kernels run only on the card)")
    return torch.device("cuda")


def _rel(a, b):
    return ((a.float() - b.float()).norm() / b.float().norm()).item()


@pytest.mark.parametrize("d,causal,rate,s", CASES)
def test_kernels_match_plain(cuda, d, causal, rate, s):
    """K1-K3 at BH 4 and S 64 (one tile, the diagonal one when causal) or
    S 256 (chip_smoke's shape (c) at Dh 64, causal, rate 0.1)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    q, k, v, do = (torch.randn(4, s, d, device=cuda, generator=g).to(torch.bfloat16)
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


# (BH, Sl): 3 x 256, then chip_smoke's shape (c), 4 x 256, and one-tile
# shards of 64 (contiguous only: zigzag halves of 32 rows cannot be tiled).
RING_CASES = [(d, causal, rate, zig, bh, sl) for bh, sl in ((3, 256), (4, 256), (4, 64))
              for d in (64, 128) for causal, zig in ((False, False), (True, False), (True, True))
              for rate in (0.0, 0.1) if not (zig and sl == 64)]


@pytest.mark.parametrize("d,causal,rate,zig,bh,sl", RING_CASES)
def test_ring_kernels_match_plain(cuda, d, causal, rate, zig, bh, sl):
    """K4, K2′ and K3′ on one ring block at the hops of shards 1 and 2 of 4,
    with zigzag offsets or contiguous ones; contiguous causal hops include
    blocks wholly in the shard's future (every tile skipped)."""
    n, BH, Sl = 4, bh, sl
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


# The Ulysses rows' attention (chip_smoke.py's (u) and (v)): B 1, S 8192,
# 4 head groups of 4 heads at Dh 64 (non-causal, rate 0.1) or of 2 heads at
# Dh 128 (causal, rate 0).
ULYSSES_CASES = {"u": (16, 64, False, 0.1), "v": (8, 128, True, 0.0)}


def _fwd_bwd(attn, q, k, v, do):
    q, k, v = (t.detach().requires_grad_(True) for t in (q, k, v))
    out = attn(q, k, v)
    return (out.detach(), *torch.autograd.grad(out, (q, k, v), do))


@pytest.mark.parametrize("shape", sorted(ULYSSES_CASES))
def test_ulysses_matches_plain_and_is_flash_at_rate_0(cuda, monkeypatch, shape):
    """K1-K3 under the one-process Ulysses (4 launches each) against the same
    function over flash_attention_plain; at rate 0 the output and gradients
    are flash_attention's bit for bit (each head's tiles are flash's)."""
    H, d, causal, rate = ULYSSES_CASES[shape]
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v, do = (torch.randn(1, 8192, H, d, device=cuda, generator=g).to(torch.bfloat16)
                   for _ in range(4))

    def ulysses(a, b, c):
        return ua.ulysses_attention(a, b, c, causal=causal, dropout_rate=rate, dropout_seed=5,
                                    seq_shards=4)

    fa.reset_launch_counts()
    got = _fwd_bwd(ulysses, q, k, v, do)
    assert fa.launch_counts() == {"flash_fwd": 4, "flash_bwd_dq": 4, "flash_bwd_dkv": 4}
    flash = _fwd_bwd(lambda a, b, c: fa.flash_attention(a, b, c, causal=causal,
                                                        dropout_rate=rate, dropout_seed=5),
                     q, k, v, do)
    monkeypatch.setattr(ua, "flash_attention", fa.flash_attention_plain)
    want = _fwd_bwd(ulysses, q, k, v, do)
    for a, b in zip(got, want):
        assert _rel(a, b) <= 2e-2
    for a, b in zip(got, flash):
        assert torch.equal(a, b) == (rate == 0.0)


def test_ring_refuses_chunks_the_kernels_cannot_tile(cuda):
    x = torch.zeros(1, 4 * 96, 2, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 64"):
        ra.ring_attention(x, x, x, causal=True, seq_shards=4)  # shard of 96 rows
    y = torch.zeros(1, 4 * 192, 2, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="multiple of 64"):
        ra.ring_attention(y, y, y, causal=True, seq_shards=4, zigzag=True)  # halves of 96
    with pytest.raises(ValueError, match="zigzag=False"):
        ra.ring_attention(y, y, y, causal=True, seq_shards=4)  # auto picks zigzag here too


FWD_CASES = [(name, d) for name in fv.VARIANTS for d in (64, 128)]


def _fwd_inputs(cuda, d, bh=4, s=256, seed=4):
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(bh, s, d, device=cuda, generator=g).to(torch.bfloat16) for _ in range(3)]


@pytest.mark.parametrize("name,d", FWD_CASES)
def test_fwd_variants_match_plain_and_count_one_launch(cuda, name, d):
    """K5-K9 against their plain versions (K6 fits at Dh 128: 2 x 81 KB of
    shared memory, under the 227 KB a CTA may take), one launch per call."""
    q, k, v = _fwd_inputs(cuda, d)
    args = (q, k.transpose(1, 2).contiguous(), v) if name == "fwd_kt" else (q, k, v)
    before = fv.launch_counts()
    out = fv.WRAPPERS[name](*args)
    after = fv.launch_counts()
    assert {n: after[n] - before[n] for n in after} == {n: int(n == name) for n in after}
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    assert _rel(out, fv.PLAIN[name](*args)) <= 2e-2


def test_fwd_qscaled_equals_fwd_current_bitwise_at_dh64(cuda):
    q, k, v = _fwd_inputs(cuda, 64, bh=2, s=512, seed=5)
    assert torch.equal(fv.fwd_qscaled(q, k, v), fv.fwd_current(q, k, v))


# K5, K6 and K7 run K1's wgmma mainloop with K1's arithmetic (K5 is its
# plain instance, K7 reads k through a transposed descriptor, K6 runs two
# warpgroups per CTA): at rate 0, non-causal, their output is K1's bit for
# bit. So is K9's at Dh 64, where its bf16 q scale is 2^-3. S 64 is one k
# tile, 256 several, 2048 the microbench's length (at its BH 16).
@pytest.mark.parametrize("name,d,s", [
    *((name, d, s) for name in ("fwd_headpair", "fwd_kt", "fwd_current") for d in (64, 128)
      for s in (64, 256, 2048)),
    *(("fwd_qscaled", 64, s) for s in (64, 256, 2048)),
])
def test_fwd_layouts_equal_flash_fwd_bitwise(cuda, name, d, s):
    q, k, v = _fwd_inputs(cuda, d, bh=16 if s == 2048 else 4, s=s, seed=6)
    args = (q, k.transpose(1, 2).contiguous(), v) if name == "fwd_kt" else (q, k, v)
    want, _ = fa.flash_fwd(q, k, v, False, 0.0, 0)
    assert torch.equal(fv.WRAPPERS[name](*args), want)


def test_fwd_qscaled_single_tile_matches_plain_at_dh128(cuda):
    """K9 at Dh 128 (bf16 scale 0.08837890625, not a power of two) on one k
    tile: the in-kernel pass over q is all the work before the first
    product, so q read unscaled by that product would show here."""
    q, k, v = _fwd_inputs(cuda, 128, bh=4, s=64, seed=8)
    out = fv.fwd_qscaled(q, k, v)
    assert _rel(out, fv.fwd_qscaled_plain(q, k, v)) <= 2e-2
    assert not torch.equal(out, fv.fwd_current(q, k, v))


@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("s", [64, 256, 2048])
def test_fwd_matmul_only_matches_plain_tightly(cuda, monkeypatch, s, d):
    """K8 sums in another order than the plain version's fp32 products, and
    nothing else differs: no online rescale, one rounding of P."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    q, k, v = _fwd_inputs(cuda, d, bh=16 if s == 2048 else 4, s=s, seed=9)
    assert _rel(fv.fwd_matmul_only(q, k, v), fv.fwd_matmul_only_plain(q, k, v)) <= 2e-3


@pytest.mark.parametrize("s", [64, 256, 2048])
def test_fwd_matmul_only_exact_on_integer_inputs(cuda, monkeypatch, s):
    """q, k, v in {-2, ..., 2} at Dh 64: every score (|s| <= 256) and every
    bf16(s * 2^-3) is exact, and every fp32 sum of P.V (multiples of 2^-3
    below 2^17) is exact in any order. A lost tile, a wrong fragment layout
    or the scale applied in the wrong place shows as a difference."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    g = torch.Generator(device=cuda).manual_seed(10)
    bh = 16 if s == 2048 else 4
    q, k, v = (torch.randint(-2, 3, (bh, s, 64), device=cuda, generator=g).to(torch.bfloat16)
               for _ in range(3))
    assert torch.equal(fv.fwd_matmul_only(q, k, v), fv.fwd_matmul_only_plain(q, k, v))


# BH 2 is one CTA per q tile; BH 266 gives 133 head pairs, so the grid is not
# a whole number of waves over the 132 SMs.
@pytest.mark.parametrize("d", [64, 128])
@pytest.mark.parametrize("bh", [2, 266])
def test_fwd_headpair_grids_equal_flash_fwd_bitwise(cuda, bh, d):
    q, k, v = _fwd_inputs(cuda, d, bh=bh, s=128, seed=7)
    want, _ = fa.flash_fwd(q, k, v, False, 0.0, 0)
    assert torch.equal(fv.fwd_headpair(q, k, v), want)


# The dropout mask read back out of K1-K4 and K2′ / K3′
# (tests/torch_dropout_probe.py): the register fragment layout decides which
# (row, col) each element hashes, so a wrong coordinate shows here bit for
# bit (in dk/dv the fragment is transposed: its rows are keys).


@pytest.mark.parametrize("s,causal,rate", [(64, False, 0.1), (64, True, 0.1), (64, False, 0.5),
                                           (64, True, 0.5), (128, True, 0.3)])
def test_flash_fwd_dropout_mask_is_the_hash_bit_for_bit(cuda, s, causal, rate):
    seed, bh = 0x2545F491, 3
    tiles = torch.arange(s // 64, device=cuda) * 64
    bhv = torch.arange(bh, device=cuda)
    thr = fa.dropout_threshold(rate)
    for t in range(s // 64):
        out, l = probe.flash_probe(bh, s, t, causal, rate, seed, cuda)
        rows, cols, all_cols = probe.coords(tiles, tiles, t, cuda)
        live = probe.live_mask(rows, cols, causal)
        keep = fa.dropout_keep(seed, bhv[:, None, None], rows[None, :, None],
                               cols[None, None, :], thr) & live
        assert torch.equal(out != 0, keep)
        want_l = probe.live_mask(rows, all_cols, causal).sum(-1).float().expand(bh, s)
        assert torch.allclose(l, want_l, rtol=1e-5, atol=0)
        o = out.float() * l[..., None]
        assert torch.allclose(o, keep * probe.kept_value(rate), rtol=2 ** -7, atol=0)


def _ring_case(name, cuda):
    """(qoff, koff) of a 4-shard ring with shards of 128 rows."""
    contiguous = ra._shard_tiles(4, 128, False, cuda)
    zigzag = ra._shard_tiles(4, 128, True, cuda)
    return {
        "contiguous past shard": (contiguous[2], contiguous[1]),
        "zigzag half-chunk pair": (zigzag[1], zigzag[2]),
        "diagonal": (contiguous[2], contiguous[2]),
        "wholly in the future": (contiguous[0], contiguous[3]),
    }[name]


@pytest.mark.parametrize("name", ["contiguous past shard", "zigzag half-chunk pair",
                                  "diagonal", "wholly in the future"])
@pytest.mark.parametrize("causal,rate", [(True, 0.1), (True, 0.5), (False, 0.3)])
def test_ring_fwd_block_dropout_mask_is_the_hash_bit_for_bit(cuda, name, causal, rate):
    seed = 0x9E3779B9
    qo, ko = _ring_case(name, cuda)
    bhv = ra._global_bh_vec(1, 3, 1, 2, 8, cuda)  # global batch*head ids 10, 11, 12
    thr = fa.dropout_threshold(rate)
    for t in range(ko.numel()):
        m, l, o = probe.ring_probe(qo, ko, bhv, t, causal, rate, seed, cuda)
        rows, cols, all_cols = probe.coords(qo, ko, t, cuda)
        keep = fa.dropout_keep(seed, bhv.long()[:, None, None], rows[None, :, None],
                               cols[None, None, :], thr) & probe.live_mask(rows, cols, causal)
        assert torch.equal(o, keep * probe.kept_value(rate))
        row_live = probe.live_mask(rows, all_cols, causal)
        assert torch.equal(l, row_live.sum(-1).float().expand_as(l))
        want_m = torch.where(row_live.any(-1), 0.0, ra.NEG_INF).expand_as(m)
        assert torch.equal(m, want_m)
        if name == "wholly in the future" and causal:
            assert m.eq(ra.NEG_INF).all() and l.eq(0).all() and o.eq(0).all()


def _bwd_keep(kernel, seed, bh, qoff, koff, tile, rate, causal, cuda):
    """The hash's keep & live mask in the layout of a backward probe's read-back."""
    rows, cols, transposed = probe.bwd_coords(kernel, qoff, koff, tile, cuda)
    keep = fa.dropout_keep(seed, bh[:, None, None], rows[None, :, None], cols[None, None, :],
                           fa.dropout_threshold(rate)) & probe.live_mask(rows, cols, causal)
    return keep.transpose(1, 2) if transposed else keep


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("s,causal,rate", [(64, False, 0.1), (64, True, 0.1), (64, False, 0.5),
                                           (64, True, 0.5), (128, True, 0.3), (128, False, 0.1)])
def test_flash_bwd_dropout_mask_is_the_hash_bit_for_bit(cuda, kernel, s, causal, rate):
    """K2 reads back the dropped ds, K3 the dropped p^T (dk exactly 0), with
    plain flash's identity offsets, bf16 outputs."""
    seed, bh = 0x2545F491, 3
    tiles = torch.arange(s // 64, device=cuda) * 64
    bh_ids = torch.arange(bh, device=cuda)
    for t in range(s // 64):
        got, value, dk = probe.bwd_probe(kernel, bh, s, t, causal, rate, seed, cuda)
        keep = _bwd_keep(kernel, seed, bh_ids, tiles, tiles, t, rate, causal, cuda)
        assert got.dtype == torch.bfloat16
        assert torch.equal(got.float(), keep * value)
        assert dk is None or dk.eq(0).all()


@pytest.mark.parametrize("kernel", ["dq", "dkv"])
@pytest.mark.parametrize("name", ["contiguous past shard", "zigzag half-chunk pair",
                                  "diagonal", "wholly in the future"])
@pytest.mark.parametrize("causal,rate", [(True, 0.1), (True, 0.5), (False, 0.3)])
def test_ring_bwd_dropout_mask_is_the_hash_bit_for_bit(cuda, kernel, name, causal, rate):
    """K2′ / K3′ (fp32 outputs) at the ring's global offsets; a block wholly
    in the q shard's future writes exact zeros."""
    seed = 0x9E3779B9
    qo, ko = _ring_case(name, cuda)
    bhv = ra._global_bh_vec(1, 3, 1, 2, 8, cuda)  # global batch*head ids 10, 11, 12
    for t in range(ko.numel()):
        got, value, dk = probe.bwd_probe(kernel, 3, 128, t, causal, rate, seed, cuda,
                                         (qo, ko, bhv), torch.float32)
        keep = _bwd_keep(kernel, seed, bhv.long(), qo, ko, t, rate, causal, cuda)
        assert got.dtype == torch.float32
        assert torch.equal(got, keep * value)
        assert dk is None or dk.eq(0).all()
        if name == "wholly in the future" and causal:
            assert got.eq(0).all()


@pytest.mark.parametrize("s", [64, 256])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("out_dtype", [torch.bfloat16, torch.float32])
def test_bwd_kernels_match_plain_at_dh128(cuda, s, causal, rate, out_dtype):
    """K2 / K3 at Dh 128, the register-tight instances (dk and dv take 64
    fp32 registers each per thread), in both output types."""
    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v, do = (torch.randn(3, s, 128, device=cuda, generator=g).to(torch.bfloat16)
                   for _ in range(4))
    _, lse = fa.flash_forward_plain(q, k, v, causal, rate, 21)
    delta = 0.1 * torch.randn(3, s, device=cuda, generator=g)
    args = (q, k, v, do, lse, delta, causal, rate, 21)
    dq = fa.flash_bwd_dq(*args, out_dtype=out_dtype)
    dk, dv = fa.flash_bwd_dkv(*args, out_dtype=out_dtype)
    want = (fa.flash_bwd_dq_plain(*args, out_dtype=out_dtype),
            *fa.flash_bwd_dkv_plain(*args, out_dtype=out_dtype))
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == out_dtype and got.shape == q.shape
        assert _rel(got, ref) <= 2e-2


@pytest.mark.parametrize("d,causal,rate", [(64, False, 0.1), (128, True, 0.0), (64, True, 0.1)])
def test_fwd_bhv_instance_equals_offset_instance_on_contiguous_ids(cuda, d, causal, rate):
    """K1's bhv instance on ids bh_offset + arange(BH) is K1's offset
    instance (the offset folded into the seed) bit for bit."""
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v = (torch.randn(8, 256, d, device=cuda, generator=g).to(torch.bfloat16)
               for _ in range(3))
    for offset in (0, 5):
        ids = torch.arange(offset, offset + 8, dtype=torch.int32, device=cuda)
        before = fa.head_shard_launch_counts()["flash_fwd_bhv"]
        got = fa.flash_fwd(q, k, v, causal, rate, 99, bhv=ids)
        assert fa.head_shard_launch_counts()["flash_fwd_bhv"] == before + 1
        want = fa.flash_fwd(q, k, v, causal, rate, 99, offset)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("d,causal,rate,H,tp", [(64, False, 0.1, 16, 2), (64, False, 0.1, 16, 4),
                                                (128, True, 0.0, 8, 2), (128, True, 0.1, 8, 8)])
def test_head_shards_equal_the_whole_layers_rows(cuda, d, causal, rate, H, tp):
    """At B 2, S 2048 ((a)'s and (b)'s geometry): each tensor-parallel rank's
    K1 (bhv instance), K2 and K3 on its H/tp heads, keyed by global
    batch*head ids, equal the whole layer's launch on those rows bit for bit,
    and their plain versions within the tolerances above."""
    B, S = 2, 2048
    g = torch.Generator(device=cuda).manual_seed(4)
    q, k, v, do = (torch.randn(B * H, S, d, device=cuda, generator=g).to(torch.bfloat16)
                   for _ in range(4))
    out, lse = fa.flash_fwd(q, k, v, causal, rate, 11)
    delta = fa.attention_delta(out, do)
    args = (q, k, v, do, lse, delta, causal, rate, 11)
    dq, (dk, dv) = fa.flash_bwd_dq(*args), fa.flash_bwd_dkv(*args)
    Hl = H // tp
    for m in range(tp):
        rows = torch.cat([torch.arange(b * H + m * Hl, b * H + (m + 1) * Hl)
                          for b in range(B)]).to(cuda)
        bhv = fa._global_bh_vec(B, Hl, 0, m * Hl, H, cuda)
        qs, ks, vs, dos = (t[rows].contiguous() for t in (q, k, v, do))
        o, l = fa.flash_fwd(qs, ks, vs, causal, rate, 11, bhv=bhv)
        sargs = (qs, ks, vs, dos, l, delta[rows].contiguous(), causal, rate, 11)
        got = (o, l, fa.flash_bwd_dq(*sargs, bhv=bhv), *fa.flash_bwd_dkv(*sargs, bhv=bhv))
        for a, b in zip(got, (out, lse, dq, dk, dv)):
            assert torch.equal(a, b[rows])
        p_out, p_lse = fa.flash_forward_plain(qs, ks, vs, causal, rate, 11, bhv=bhv)
        assert _rel(o, p_out) <= 2e-2 and (l - p_lse).abs().max().item() <= 1e-3


@pytest.mark.parametrize("shape", ["tier S", "row"])
def test_moe_index_dispatch_matches_the_plain_version(cuda, shape):
    """The MoE layer's index dispatch (the main path) against the one-hot
    plain version on the card, bf16 compute: the output bit for bit (each
    slot holds one token; the combine sums two exact products in fp32), the
    gradients within 2e-2 of their largest magnitude (tests/test_torch_moe.py).
    Tier S: B 2, S 64, E 4, D 128, F 512; the 1.18B row's layer: N 2048, E
    8, C 640, D 1024, F 4096."""
    from distributed_llm_training_benchmark_framework_tpu_torch.models import get_config
    from distributed_llm_training_benchmark_framework_tpu_torch.models import moe

    B, S, E, D, F = {"tier S": (2, 64, 4, 128, 512), "row": (1, 2048, 8, 1024, 4096)}[shape]
    cfg = get_config("tinygpt", "A", S, n_experts=E)
    g = torch.Generator(device=cuda).manual_seed(7)

    def rnd(*s):
        return (0.02 * torch.randn(*s, device=cuda, generator=g)).requires_grad_()

    x = torch.randn(B, S, D, device=cuda, generator=g).to(torch.bfloat16).requires_grad_()
    lv = [rnd(D, E), rnd(E, D, F), rnd(E, F), rnd(E, F, D), rnd(E, D)]
    dy = torch.randn(B, S, D, device=cuda, generator=g)
    outs, grads = [], []
    for form in ("index", "plain"):
        if form == "index":
            y, aux = moe.moe_mlp(cfg, x, lv[0],
                                 lambda xin: moe.expert_ffn(xin, *lv[1:], cfg.compute_dtype))
        else:
            y, aux = moe.moe_mlp_plain(cfg, x, *lv)
        (torch.sum(y.float() * dy) + aux).backward()
        outs.append((y.detach(), aux.detach()))
        grads.append([t.grad.clone() for t in (x, *lv)])
        for t in (x, *lv):
            t.grad = None
    assert torch.equal(outs[0][0], outs[1][0]) and torch.equal(outs[0][1], outs[1][1])
    for a, b in zip(*grads):
        assert (a.float() - b.float()).abs().max() <= 2e-2 * b.float().abs().max()
