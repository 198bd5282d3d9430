"""Port row fetch (graphminer_tpu_torch/ops/fetch.py, kernel D's plain
version on the CPU) against the JAX package's Pallas fetch_rows_sum, run in
TPU interpret mode: pallas_call is wrapped for the test so that it passes
interpret=pltpu.InterpretParams(); nothing in the JAX package changes.
Results must be equal."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from graphminer_tpu.ops import pallas_fetch
from graphminer_tpu_torch.ops import fetch


@pytest.fixture
def interpret(monkeypatch):
    """pallas_call in TPU interpret mode, for this test only."""
    real = pl.pallas_call

    @functools.wraps(real)
    def pallas_call(*args, **kwargs):
        kwargs.setdefault("interpret", pltpu.InterpretParams())
        return real(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", pallas_call)
    pallas_fetch.fetch_rows_sum.clear_cache()
    yield
    pallas_fetch.fetch_rows_sum.clear_cache()


@pytest.mark.parametrize("w,n,n_buf", [(8, 64, 8), (128, 200, 16),
                                       (32, 7, 4), (256, 96, 2)])
def test_fetch_matches_pallas(interpret, w, n, n_buf):
    rng = np.random.default_rng(w + n)
    table = rng.integers(-1000, 1000, size=(500, w)).astype(np.int32)
    idx = rng.integers(0, 500, size=n).astype(np.int32)
    want = np.asarray(pallas_fetch.fetch_rows_sum(
        jnp.asarray(idx), jnp.asarray(table), n_buf=n_buf))
    got = fetch.fetch_rows_sum(torch.from_numpy(idx), torch.from_numpy(table),
                               n_buf=n_buf)
    assert got.dtype == torch.int32 and got.shape == (1, w)
    assert np.array_equal(got.numpy(), want)


def test_fetch_matches_numpy_large():
    """Chunked plain sums over many rows: more indices than one chunk."""
    rng = np.random.default_rng(1)
    table = rng.integers(0, 100, size=(1 << 12, 32)).astype(np.int32)
    idx = rng.integers(0, 1 << 12, size=(1 << 19) + 5).astype(np.int32)
    got = fetch.fetch_rows_sum(torch.from_numpy(idx), torch.from_numpy(table))
    want = table.astype(np.int64)[idx].sum(axis=0)
    assert np.array_equal(got.numpy()[0], want)


def test_fetch_out_of_range_rows_add_nothing():
    table = np.arange(12, dtype=np.int32).reshape(4, 3)
    idx = np.array([0, -1, 3, 4, 1 << 30, 3], dtype=np.int32)
    got = fetch.fetch_rows_sum(torch.from_numpy(idx), torch.from_numpy(table))
    assert got.tolist() == [(table[0] + 2 * table[3]).tolist()]


def test_fetch_int32_overflow_raises():
    table = torch.full((2, 4), (1 << 30), dtype=torch.int32)
    with pytest.raises(RuntimeError, match="leaves int32"):
        fetch.fetch_rows_sum(torch.tensor([0, 1, 0], dtype=torch.int32),
                             table)


def test_fetch_rejects_bad_args():
    table = torch.zeros((4, 8), dtype=torch.int32)
    idx = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="n_buf"):
        fetch.fetch_rows_sum(idx, table, n_buf=3)
    with pytest.raises(TypeError, match="int32"):
        fetch.fetch_rows_sum(idx.long(), table)
