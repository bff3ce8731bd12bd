"""The port's dropout hash is bit-identical to the JAX package's.

Both sides get the same (seed, batch*head, row, col) coordinates from
numpy; the port computes in int64 masked to 32 bits, JAX in uint32.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_training_benchmark_framework_tpu.ops import flash_attention as jfa
from distributed_llm_training_benchmark_framework_tpu_torch.ops import flash_attention as tfa

RATES = (0.1, 0.5, 0.999)


def test_mix32_bit_identical():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, size=4096, dtype=np.uint64)
    x[:4] = (0, 1, 2**31, 2**32 - 1)
    want = np.asarray(jfa._mix32(jnp.asarray(x.astype(np.uint32)))).astype(np.int64)
    got = tfa.mix32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rate", RATES)
def test_threshold_identical(rate):
    assert tfa.dropout_threshold(rate) == int(jfa._dropout_threshold(rate))


@pytest.mark.parametrize("seed", [0, 1, 0xFFFFFFFF, 0x9E3779B9, None])
@pytest.mark.parametrize("rate", RATES)
def test_keep_mask_bit_identical(seed, rate):
    rng = np.random.default_rng(0 if seed is None else seed % 997)
    if seed is None:
        seed = int(rng.integers(0, 2**32))
    bh = np.concatenate([[0, 2**20 - 1], rng.integers(0, 2**20, 6)]).astype(np.int64)
    rows = np.concatenate([[0, 2**16 - 1], rng.integers(0, 2**16, 14)]).astype(np.int64)
    cols = np.concatenate([[0, 2**16 - 1], rng.integers(0, 2**16, 30)]).astype(np.int64)
    thr = jfa._dropout_threshold(rate)
    want = np.asarray(jfa._dropout_keep(
        jnp.uint32(seed), jnp.asarray(bh[:, None, None], jnp.int32),
        jnp.asarray(rows[None, :, None], jnp.int32), jnp.asarray(cols[None, None, :], jnp.int32),
        thr,
    ))
    got = tfa.dropout_keep(
        seed, torch.from_numpy(bh[:, None, None]), torch.from_numpy(rows[None, :, None]),
        torch.from_numpy(cols[None, None, :]), tfa.dropout_threshold(rate),
    ).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.shape == (8, 16, 32)
