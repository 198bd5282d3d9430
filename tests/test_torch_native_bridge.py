"""The port's native bridge entries for the large-clique engine
(graphminer_tpu_torch/native_bridge.py: expand_multi, count_multi,
kclique_dfs) against the JAX package's bridge and numpy on random bitmaps,
as tests/test_native_expand.py does, and kclique_dfs against
tests/oracle.k_cliques."""
from unittest import mock

import numpy as np
import pytest

import oracle
from graphminer_tpu import native_bridge as jnb
from graphminer_tpu_torch import native_bridge as nb
from graphminer_tpu_torch.io.synth import rmat


def numpy_ref(bases, rows, n_bits):
    acc = np.full((rows[0].shape[0], bases[0].shape[1]), 0xFFFFFFFF,
                  dtype=np.uint32)
    for b, r in zip(bases, rows):
        acc &= b.view(np.uint32)[r]
    bits = np.unpackbits(acc.view(np.uint8), axis=1, bitorder="little")
    return np.nonzero(bits[:, :n_bits])


def bitmaps(seed, n, words, n_src, v=60):
    rng = np.random.default_rng(seed)
    bases = [rng.integers(-2**31, 2**31, (v, words), dtype=np.int64)
             .astype(np.int32) for _ in range(n_src)]
    rows = [rng.integers(0, v, n).astype(np.int32) for _ in range(n_src)]
    return bases, rows


@pytest.mark.parametrize("seed,n,words,n_bits,n_src", [
    (0, 200, 8, 256, 2),
    (1, 64, 8, 100, 3),       # n_bits inside a word
    (2, 500, 16, 512, 2),
    (3, 10, 8, 1, 2),
])
def test_expand_and_count_multi(seed, n, words, n_bits, n_src):
    bases, rows = bitmaps(seed, n, words, n_src)
    ti, pos = numpy_ref(bases, rows, n_bits)
    cnt = nb.count_multi(bases, rows, words, n_bits)
    assert cnt.dtype == np.int32
    assert np.array_equal(cnt, np.bincount(ti, minlength=n))
    assert np.array_equal(cnt, jnb.count_multi(bases, rows, words, n_bits))
    cap = max(len(ti), 1)
    outs = []
    for bridge in (nb, jnb):
        ot, ob = np.zeros(cap, np.int64), np.zeros(cap, np.int32)
        n_em, nxt = bridge.expand_multi(bases, rows, words, n_bits, 0, cap,
                                        ot, ob)
        assert (n_em, nxt) == (len(ti), n)
        outs.append((ot[:n_em], ob[:n_em]))
    assert np.array_equal(outs[0][0], ti) and np.array_equal(outs[0][1], pos)
    assert all(np.array_equal(a, b) for a, b in zip(*outs))


def test_expand_multi_resumes_on_whole_tasks():
    bases, rows = bitmaps(7, 300, 8, 2)
    ti, pos = numpy_ref(bases, rows, 256)
    cap = 97
    got_t, got_b, start = [], [], 0
    ot, ob = np.zeros(cap, np.int64), np.zeros(cap, np.int32)
    while start < 300:
        n_em, nxt = nb.expand_multi(bases, rows, 8, 256, start, cap, ot, ob)
        assert nxt > start
        if nxt < 300:       # stopped before a task that would not fit
            assert n_em + np.sum(ti == nxt) > cap
        got_t.append(ot[:n_em].copy())
        got_b.append(ob[:n_em].copy())
        start = nxt
    assert np.array_equal(np.concatenate(got_t), ti)
    assert np.array_equal(np.concatenate(got_b), pos)
    with pytest.raises(ValueError):
        nb.expand_multi(bases, rows, 8, 256, 0, cap, ot.astype(np.int32), ob)


def test_kclique_dfs_vs_oracle_and_jax():
    g = rmat(11, 8, seed=3)
    rg = g.relabel_by_degree(descending=False).orientation()
    got = nb.kclique_dfs(rg.rowptr, rg.colidx, 6)
    assert got == jnb.kclique_dfs(rg.rowptr, rg.colidx, 6)
    assert got == oracle.k_cliques(g, 6) == 1352617


def test_none_without_the_library():
    bases, rows = bitmaps(0, 10, 8, 2)
    with mock.patch.object(nb, "get_lib", lambda: None):
        assert nb.count_multi(bases, rows, 8, 256) is None
        assert nb.kclique_dfs(np.zeros(2, np.int64), np.zeros(0, np.int32),
                              3) is None
        assert nb.expand_multi(bases, rows, 8, 256, 0, 1,
                               np.zeros(1, np.int64),
                               np.zeros(1, np.int32)) is None
