"""The embedding and MLP dropout masks, drawn per global batch row
(``models/tinygpt.py``: ``row_seed``, ``_dropout_mask``, ``_mask_geometry``).

Each row of the global batch draws its keep-mask at the full sequence from a
generator seeded by (site seed, row), and a rank keeps only its rows and its
columns in a buffer of their own:

- the rows a data rank draws equal those rows of the one-process draw of
  the same global batch, at data 1, 2 and 4, for the embedding's mask and
  every layer's, through the model's forward;
- every kept mask owns storage of exactly its window's size (rows x
  columns x width bytes), for the whole row, a ``seq`` window and a
  collective-matmul window, so no mask holds a global draw alive;
- the train step draws its site seeds in the pipeline's order (a
  micro-batch's attention seeds, then its mask seeds), from the CPU
  generator alone, and none at dropout 0; ``reseed`` gives a fresh stream;
- the kept share is 1 - rate within 6 binomial sigmas, as is JAX's own
  ``jax.random.bernoulli`` draw at the same shape (the two agree only
  statistically: JAX's PRNG is not torch's).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_training_benchmark_framework_tpu_torch.models import TinyGPT, get_config
from distributed_llm_training_benchmark_framework_tpu_torch.models import tinygpt
from distributed_llm_training_benchmark_framework_tpu_torch.parallel.strategies import (
    apply_strategy,
    get_strategy,
)
from distributed_llm_training_benchmark_framework_tpu_torch.train.step import TrainStep
from torch_threads import one_thread  # noqa: F401  (autouse, module scope)

S, RATE = 32, 0.1


def _model(dropout=RATE):
    model = TinyGPT(get_config("tinygpt", "S", S, dropout=dropout,
                               compute_dtype=torch.float32))
    return model.init_weights(torch.Generator().manual_seed(0))


def _captured_masks(monkeypatch, model, idx, seeds, batch_offset, global_batch):
    """The masks one forward hands to ``_apply_dropout``, in call order
    (the embedding's, then each layer's MLP)."""
    masks = []
    real = tinygpt._apply_dropout

    def capture(x, mask, rate):
        masks.append(mask)
        return real(x, mask, rate)

    monkeypatch.setattr(tinygpt, "_apply_dropout", capture)
    with torch.no_grad():
        model(idx, idx, mask_seeds=seeds, batch_offset=batch_offset, global_batch=global_batch)
    monkeypatch.setattr(tinygpt, "_apply_dropout", real)
    return masks


def test_row_seeds_are_distinct_63_bit_integers():
    seeds = [tinygpt.row_seed(s, r) for s in (0, 1, 2**62 - 1) for r in range(512)]
    assert len(set(seeds)) == len(seeds)
    assert all(0 <= v < 2**63 for v in seeds)


@pytest.mark.parametrize("data", [1, 2, 4])
def test_rank_rows_equal_the_one_process_draw(monkeypatch, data):
    model = _model()
    G = 4
    idx = torch.from_numpy(np.random.default_rng(0).integers(
        0, model.config.vocab_size, (G, S))).long()
    seeds = [int(v) for v in np.random.default_rng(1).integers(0, 2**62,
                                                                 model.config.n_layer + 1)]
    whole = _captured_masks(monkeypatch, model, idx, seeds, 0, None)
    assert len(whole) == model.config.n_layer + 1
    b = G // data
    for rank in range(data):
        rows = slice(rank * b, (rank + 1) * b)
        mine = _captured_masks(monkeypatch, model, idx[rows], seeds, rank * b, G)
        for got, want in zip(mine, whole):
            assert got.shape == (b, S, model.config.n_embd)
            assert torch.equal(got, want[rows])
            assert got.untyped_storage().nbytes() == got.numel()
    # Distinct sites draw distinct masks.
    assert not torch.equal(whole[0], whole[1])


@pytest.mark.parametrize("cols", [slice(0, 64), slice(16, 32), slice(48, 64)],
                         ids=["row", "seq-window", "last-window"])
def test_a_kept_window_owns_storage_of_its_size(cols):
    rows, row_shape = range(3, 5), (64, 8)
    keep = tinygpt._dropout_mask(123, RATE, rows, row_shape, cols, "cpu")
    n_cols = cols.stop - cols.start
    assert keep.shape == (2, n_cols, 8) and keep.dtype == torch.bool
    assert keep.untyped_storage().nbytes() == 2 * n_cols * 8
    full = tinygpt._dropout_mask(123, RATE, rows, row_shape, slice(0, 64), "cpu")
    assert torch.equal(keep, full[:, cols])
    # A row's mask does not depend on the other rows drawn beside it.
    alone = tinygpt._dropout_mask(123, RATE, range(4, 5), row_shape, cols, "cpu")
    assert torch.equal(alone[0], keep[1])


def test_no_mask_at_rate_zero_or_without_a_seed():
    assert tinygpt._dropout_mask(None, RATE, range(2), (8, 4), slice(0, 8), "cpu") is None
    assert tinygpt._dropout_mask(5, 0.0, range(2), (8, 4), slice(0, 8), "cpu") is None


def _step(dropout, accum=2):
    model = _model(dropout)
    model, opt = apply_strategy(model, get_strategy("zero2"), None)
    return TrainStep(model, opt, grad_accum=accum, micro_batch=1, seed=7,
                     device=torch.device("cpu"))


def test_the_step_draws_site_seeds_in_the_pipeline_order(monkeypatch):
    step = _step(RATE)
    calls = []
    real_forward = type(step.model).forward

    def spy(self, idx, targets=None, **kw):
        calls.append((kw["attn_seeds"], kw["mask_seeds"]))
        return real_forward(self, idx, targets, **kw)

    monkeypatch.setattr(type(step.model), "forward", spy)
    table = torch.from_numpy(np.random.default_rng(2).integers(
        0, step.config.vocab_size, (8, S))).long()
    step(table, 0)
    ref = TrainStep.__new__(TrainStep)
    ref.config, ref.seed_gen = step.config, torch.Generator().manual_seed(7)
    want = [(ref._attn_seeds(), ref._mask_seeds()) for _ in range(2)]
    assert calls == want
    assert not hasattr(step, "mask_gen")
    # A replay's stream is fresh.
    step.reseed(7, 1)
    assert step._mask_seeds() != want[0][1]


def test_dropout_zero_draws_no_seed():
    step = _step(0.0)
    state = step.seed_gen.get_state()
    assert step._attn_seeds() is None and step._mask_seeds() is None
    assert torch.equal(step.seed_gen.get_state(), state)


def test_kept_share_is_the_rate_as_in_jax():
    rows, row_shape = range(16), (256, 64)
    keep = tinygpt._dropout_mask(99, RATE, rows, row_shape, slice(0, 256), "cpu")
    n = keep.numel()
    sigma = (n * RATE * (1 - RATE)) ** 0.5
    jkeep = jax.random.bernoulli(jax.random.PRNGKey(99), 1.0 - RATE, (16, *row_shape))
    for kept in (int(keep.sum()), int(jnp.sum(jkeep))):
        assert abs(kept - n * (1 - RATE)) < 6 * sigma
