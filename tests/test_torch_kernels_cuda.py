"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: on a host without a CUDA device each test skips with that
reason (the CUDA kernels have no CPU mode; the CPU tests hold the plain
versions against JAX instead). On the card:

    python -m pytest tests/test_torch_kernels_cuda.py -q

Tolerances: rel-Frobenius 2e-2 for bf16 outputs and gradients, 1e-3 absolute
for the fp32 lse (the kernels and the plain versions sum in different
orders; a dropout mask that differed anywhere would show as an O(1) error).
"""

import pytest
import torch

from distributed_llm_training_benchmark_framework_tpu_torch.ops import flash_attention as fa

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
