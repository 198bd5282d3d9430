"""Kernel Q's plain version (graphminer_tpu_torch/ops/cuda_cliquebig.py,
the compaction of graphminer_tpu/ops/cliquebig.py::_tri_expand_bilinear)
against a numpy reference on random rows: bit 31 set, n_bits inside a
word, tasks whose ids lie outside their tables, tasks with no bit, offsets
past 2^31 given as int64, an empty chunk; and the offsets against the
native count_multi prepass that the engine takes them from."""
import numpy as np
import pytest
import torch

from graphminer_tpu_torch import native_bridge
from graphminer_tpu_torch.ops.cuda_cliquebig import (quad_emit,
                                                     quad_emit_plain,
                                                     quad_offsets)

SENTINEL = np.iinfo(np.int32).max


def words(rng, shape):
    return rng.integers(-2**31, 2**31, shape, dtype=np.int64).astype(np.int32)


def inputs(rng, words_, n_bits, e=300, c=200, n=700):
    y2 = words(rng, (e, words_)) & words(rng, (e, words_))
    core = words(rng, (c, words_))
    core[7] = 0                                   # tasks with no bit
    y2[:, 0] |= np.int32(-2**31)                  # bit 31 in every row
    erow = rng.integers(-2, e + 2, n).astype(np.int32)
    c1 = rng.integers(-2, c + 2, n).astype(np.int32)
    erow[::37] = SENTINEL
    c1[5::11] = 7
    return y2, core, erow, c1


def reference(y2, core, erow, c1, n_bits):
    """Per task, its set bits below n_bits, ascending (none for a task
    with an id outside its table)."""
    out = []
    for r, c in zip(erow, c1):
        if not (0 <= r < y2.shape[0] and 0 <= c < core.shape[0]):
            out.append([])
            continue
        y = (y2[r] & core[c]).view(np.uint32)
        out.append([b for b in range(min(n_bits, 32 * y.shape[0]))
                    if (int(y[b // 32]) >> (b % 32)) & 1])
    return out


@pytest.mark.parametrize("words_,n_bits", [(8, 256), (8, 200), (3, 65),
                                           (32, 1000)])
def test_quad_emit_plain_equals_numpy(words_, n_bits):
    rng = np.random.default_rng(words_ + n_bits)
    y2, core, erow, c1 = inputs(rng, words_, n_bits)
    ref = reference(y2, core, erow, c1, n_bits)
    counts = np.array([len(b) for b in ref])
    base = (1 << 31) + 12345                      # a slice of a long scan
    off = quad_offsets(counts) + base
    t = torch.from_numpy
    r, cols = quad_emit_plain(t(y2), t(core), t(erow), t(c1), t(off),
                              n_bits)
    want_r = np.repeat(erow, counts)
    want_c = np.stack([np.repeat(c1, counts),
                       np.concatenate([np.array(b, np.int64) for b in ref])],
                      axis=1)
    assert r.dtype == cols.dtype == torch.int32
    assert np.array_equal(r.numpy(), want_r)
    assert np.array_equal(cols.numpy(), want_c)
    assert (counts == 0).sum() > 20 and counts.max() > 0
    if n_bits % 32 == 0:
        assert (want_c[:, 1] % 32 == 31).any()    # bit 31 emitted
    # the CPU wrapper takes the plain version; n_quads from off
    r2, c2 = quad_emit(t(y2), t(core), t(erow), t(c1), t(off), n_bits)
    assert torch.equal(r2, r) and torch.equal(c2, cols)


def test_offsets_equal_count_multi():
    """quad_offsets over the native count_multi counts of the engine's
    triangle tasks (y2 rows as bm[a] & bm[b]) is Q's off."""
    rng = np.random.default_rng(3)
    bm = words(rng, (400, 8))
    core = bm[200:]
    ea, eb = rng.integers(0, 400, (2, 300)).astype(np.int32)
    y2 = bm[ea] & bm[eb]
    erow = rng.integers(0, 300, 900).astype(np.int32)
    c1 = rng.integers(0, 200, 900).astype(np.int32)
    counts = native_bridge.count_multi([bm, bm, core],
                                       [ea[erow], eb[erow], c1], 8, 200)
    ref = reference(y2, core, erow, c1, 200)
    assert np.array_equal(counts, [len(b) for b in ref])
    off = quad_offsets(counts)
    assert off.dtype == np.int64 and off[0] == 0 and off[-1] == counts.sum()
    t = torch.from_numpy
    r, cols = quad_emit(t(y2), t(core), t(erow), t(c1), t(off), 200,
                        int(off[-1]))
    assert r.shape == (counts.sum(),) and cols.shape == (counts.sum(), 2)


def test_empty_and_checks():
    rng = np.random.default_rng(5)
    y2, core, erow, c1 = inputs(rng, 8, 256, n=4)
    t = torch.from_numpy
    before = quad_emit.launches
    r, cols = quad_emit(t(y2), t(core), t(erow[:0]), t(c1[:0]),
                        t(np.zeros(1, np.int64)), 256)
    assert r.shape == (0,) and cols.shape == (0, 2)
    assert quad_emit.launches == before
    with pytest.raises(TypeError):
        quad_emit(t(y2), t(core), t(erow), t(c1), t(np.zeros(5, np.int32)),
                  256)
    with pytest.raises(ValueError):
        quad_emit(t(y2), t(core), t(erow), t(c1), t(np.zeros(4, np.int64)),
                  256)
    with pytest.raises(ValueError):
        quad_emit(t(y2), t(core[:, :4]), t(erow), t(c1),
                  t(np.zeros(5, np.int64)), 256)
