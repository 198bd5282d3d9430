"""The plain reference: the Graph500 generator's two paths and the exact
counters, against pinned goldens and brute force (CPU)."""
import itertools
import os
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from bench_port.reference import counts, graph500  # noqa: E402

#: bench.py:62-63 (rmat14 triangles) and the 4-clique golden that
#: chip_smoke.py pins for motif 4 at rmat12, both at seed 7, edge factor 16
GOLDEN_RMAT14_TRIANGLES = 2_860_691
GOLDEN_RMAT12_CLIQUE4 = 4_059_942


def _t(rp, col):
    return torch.from_numpy(rp), torch.from_numpy(col)


def _brute(n, edges, k):
    adj = [set() for _ in range(n)]
    for u, v in edges:
        adj[u].add(v)
        adj[v].add(u)
    return sum(1 for c in itertools.combinations(range(n), k)
               if all(b in adj[a] for a, b in itertools.combinations(c, 2)))


def _csr(n, edges):
    src = np.array([e[0] for e in edges], dtype=np.int64)
    dst = np.array([e[1] for e in edges], dtype=np.int64)
    return graph500.csr_from_draws_numpy(src, dst, n)


def test_rmat14_triangle_golden():
    rp, col = graph500.kronecker_csr_numpy(14, seed=7)
    assert counts.triangles(*_t(rp, col)) == GOLDEN_RMAT14_TRIANGLES


def test_rmat12_clique4_golden():
    rp, col = graph500.kronecker_csr_numpy(12, seed=7)
    assert counts.clique4(*_t(rp, col)) == GOLDEN_RMAT12_CLIQUE4


@pytest.mark.parametrize("seed", range(6))
def test_counters_match_brute_force(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(6, 22))
    p = float(rng.uniform(0.2, 0.8))
    edges = [(u, v) for u, v in itertools.combinations(range(n), 2)
             if rng.random() < p]
    if not edges:
        edges = [(0, 1)]
    rp, col = _csr(n, edges)
    assert counts.triangles(*_t(rp, col)) == _brute(n, edges, 3)
    assert counts.clique4(*_t(rp, col)) == _brute(n, edges, 4)


def test_small_blocks_give_the_same_counts():
    """Many wedge blocks and many 4-clique batches count as one does."""
    rp, col = _t(*graph500.kronecker_csr_numpy(10, seed=3))
    assert (counts.triangles(rp, col, block_pairs=257)
            == counts.triangles(rp, col))
    assert (counts.clique4(rp, col, block_pairs=1000, batch_bytes=4096)
            == counts.clique4(rp, col))


def test_complete_graph():
    n = 40
    edges = list(itertools.combinations(range(n), 2))
    rp, col = _t(*_csr(n, edges))
    assert counts.triangles(rp, col) == n * (n - 1) * (n - 2) // 6
    assert counts.clique4(rp, col) == n * (n - 1) * (n - 2) * (n - 3) // 24


def test_numpy_path_is_the_programs_rule():
    """The frozen copy draws what graphminer_tpu_torch.io.synth.rmat draws
    (the program is imported here only to hold the copy to it)."""
    from graphminer_tpu_torch.io.synth import rmat
    for scale, seed in ((8, 7), (10, 2**31 + 5)):
        g = rmat(scale, 16, seed=seed)
        rp, col = graph500.kronecker_csr_numpy(scale, seed=seed)
        assert np.array_equal(g.rowptr, rp)
        assert np.array_equal(g.colidx, col)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11, 2**40 + 3])
def test_torch_path_is_a_sound_csr(seed):
    rp, col = graph500.kronecker_csr_torch(10, seed=seed)
    again = graph500.kronecker_csr_torch(10, seed=seed)
    assert torch.equal(rp, again[0]) and torch.equal(col, again[1])
    n = rp.numel() - 1
    assert n == 1024 and rp.dtype == torch.int64 and col.dtype == torch.int32
    src = torch.repeat_interleave(torch.arange(n), rp[1:] - rp[:-1])
    keys = src * n + col.long()
    assert bool((keys[1:] > keys[:-1]).all())           # sorted, no dups
    assert not bool((src == col.long()).any())          # no loops
    rev, _ = torch.sort(col.long() * n + src)
    assert torch.equal(rev, keys)                       # symmetric
    # the same rule as the numpy path: as many edges, to a few percent
    ref = graph500.kronecker_csr_numpy(10, seed=7)[1].shape[0]
    assert abs(col.numel() - ref) < 0.03 * ref


def test_controls_fail_where_their_type_cannot_hold_the_count():
    """float32 rounds a count above 2^24 (rmat14: 36.6 M 4-cliques)."""
    rp, col = _t(*graph500.kronecker_csr_numpy(14, seed=7))
    exact = counts.clique4(rp, col)
    assert counts.clique4(rp, col, accumulate="float32") != exact
    parts = torch.tensor([2**24, 1], dtype=torch.int64)
    assert counts._accumulate(parts, "float32") != 2**24 + 1
    assert counts._accumulate(parts, "int64") == 2**24 + 1
    with pytest.raises(ValueError):
        counts._accumulate(parts, "int32")

