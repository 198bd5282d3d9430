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


def emulate_kernel(idx, table, n_buf, wave):
    """csrc/fetch_rows_sum.cu in numpy: the launch's grid (fetch.grid_blocks
    over one wave of `wave` blocks), each lane group's interleaved indices
    taken n_buf at a time, the block's two-step reduction of its [rows, w]
    int64 sums (pieces of rows, then one thread a column), the integer adds
    into the workspace and the last block's int32 check. Returns the int32
    [1, w] result and how often each index was fetched."""
    v, w = table.shape
    t = idx.shape[0]
    vec, lanes = fetch.lanes_of(w)
    block = fetch.BLOCK
    rows = block // lanes
    nb = fetch.grid_blocks(t, w, wave)
    stride = nb * rows
    fetched = np.zeros(t, np.int64)
    sums = np.zeros(w, np.int64)                      # the workspace
    for b in range(nb):
        acc = np.zeros((rows, w), np.int64)           # red[slot * w + col]
        base = b * rows + np.arange(rows)
        while (base < t).any():
            for j in range(n_buf):
                i = base + j * stride
                ok = i < t
                np.add.at(fetched, i[ok], 1)
                r = np.where(ok, idx[np.minimum(i, t - 1)], -1)
                hit = (r >= 0) & (r < v)
                acc[hit] += table[r[hit]].astype(np.int64)
            base = base + stride * n_buf
        red = acc.reshape(-1)
        p = block // w if w <= block else 1
        part = np.array([red[np.arange(e // w, rows, p) * w + e % w].sum()
                         for e in range(p * w)], np.int64)
        sums += part.reshape(p, w).sum(axis=0)
    assert ((sums >= -(1 << 31)) & (sums < (1 << 31))).all()
    return sums.astype(np.int32)[None, :], fetched


#: (w, t, n_buf, wave): 16-byte lanes (w 8, 32, 256, 1024) and 4-byte lanes
#: (w 6), index counts that fill less than one wave, one wave and several,
#: every pipeline depth
EMULATED = [(8, 700, 16, 264), (6, 301, 1, 3), (32, 2000, 2, 5),
            (256, 999, 4, 264), (1024, 37, 32, 132), (6, 5000, 8, 7),
            (128, 1, 16, 264), (8, 0, 2, 4)]


@pytest.mark.parametrize("w,t,n_buf,wave", EMULATED)
def test_emulated_kernel_matches_plain(w, t, n_buf, wave):
    rng = np.random.default_rng(w * 7 + t)
    table = rng.integers(-1000, 1000, size=(300, w)).astype(np.int32)
    idx = rng.integers(-4, 304, size=t).astype(np.int32)
    got, fetched = emulate_kernel(idx, table, n_buf, wave)
    assert (fetched == 1).all()                 # one row fetch an index
    want = fetch.fetch_rows_sum_plain(torch.from_numpy(idx),
                                      torch.from_numpy(table))
    assert np.array_equal(got, want.numpy())


@pytest.mark.parametrize("w,t,n_buf", [(6, 150, 4), (256, 96, 32),
                                       (8, 400, 1)])
def test_emulated_kernel_matches_pallas(interpret, w, t, n_buf):
    rng = np.random.default_rng(w + n_buf)
    table = rng.integers(-1000, 1000, size=(500, w)).astype(np.int32)
    idx = rng.integers(0, 500, size=t).astype(np.int32)
    want = np.asarray(pallas_fetch.fetch_rows_sum(
        jnp.asarray(idx), jnp.asarray(table), n_buf=n_buf))
    for wave in (1, 3, 264):
        assert np.array_equal(emulate_kernel(idx, table, n_buf, wave)[0],
                              want)


@pytest.mark.parametrize("t,w,wave,nb", [(0, 8, 264, 1), (1, 256, 264, 1),
                                         (10**6, 8, 264, 264),
                                         (300, 6, 264, 8), (5000, 128, 7, 7)])
def test_grid_blocks(t, w, wave, nb):
    """One wave at most, and no block without a row slot's first index."""
    assert fetch.grid_blocks(t, w, wave) == nb
