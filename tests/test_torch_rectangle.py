"""Port 4-cycle engine (graphminer_tpu_torch/ops/rectangle.py: cases A and
B on X + torch._int_mm and kernel W's plain version, the recursion and its
closers) against the JAX package's ops/rectangle.py, the frontier engine,
the native wedge pass, a brute-force oracle and the pinned golden
(bench.py:82). Inputs from
numpy seeds; all exact."""
import pytest

import oracle
from graphminer_tpu import native_bridge as jnb
from graphminer_tpu.core.graph import HostGraph as JHostGraph
from graphminer_tpu.ops import rectangle as jr
from graphminer_tpu_torch import native_bridge
from graphminer_tpu_torch.core.graph import HostGraph
from graphminer_tpu_torch.io.synth import erdos_renyi, rmat
from graphminer_tpu_torch.ops import rectangle as rc
from graphminer_tpu_torch.workloads.sgl import sgl_count

#: rmat(12, 16, seed=7) 4-cycles (bench.py:82)
GOLDEN_RMAT12 = 52_988_519


def jax_graph(g):
    return JHostGraph(rowptr=g.rowptr, colidx=g.colidx)


def port_graph(jg):
    return HostGraph(rowptr=jg.rowptr, colidx=jg.colidx)


def test_dense_closer_vs_oracle(rand_graphs):
    g = port_graph(rand_graphs[0])         # n = 24: brute force is feasible
    edges, n_pat, _ = oracle.PATTERNS["rectangle"]
    assert rc._c4_dense(g) == oracle.count_noninduced(g, edges, n_pat)


@pytest.mark.parametrize("n,p,seed", [(40, 0.3, 0), (64, 0.15, 1),
                                      (80, 0.25, 2), (120, 0.1, 3)])
@pytest.mark.parametrize("core", [8, 32, None])
def test_vs_jax_core_sweep(n, p, seed, core):
    """Degenerate, partial and whole-graph cores: small cores force case-B
    chunks with sub neighbours and case-C recursion levels."""
    g = erdos_renyi(n, p, seed)
    core = core or n
    got = rc.rectangle_count_fast(g, core=core, device="cpu")
    assert got == jr.rectangle_count_fast(jax_graph(g), core=core)


def test_rmat11_core256_vs_jax_and_wedge_pass():
    """rmat11 at core 256 against JAX and against the native wedge pass
    over the whole graph (no code shared with the matrix-product levels)."""
    g = rmat(11, 8, seed=3)
    rg = g.relabel_by_degree(descending=False)
    want = native_bridge.c4_anchor(rg.rowptr, rg.colidx)
    assert want > 0
    assert rc.rectangle_count_fast(g, core=256, device="cpu") == want == \
        jr.rectangle_count_fast(jax_graph(g), core=256)


def test_rmat12_golden_default_core():
    """rmat(12, 16, seed=7) at the default core: case A alone, over a
    4096-id core."""
    g = rmat(12, 16, seed=7)
    assert rc.rectangle_count_fast(g, device="cpu") == GOLDEN_RMAT12


def test_chunk_invariance():
    g = rmat(11, 8, seed=3)
    a = rc.rectangle_count_fast(g, core=128, chunk=64, device="cpu")
    b = rc.rectangle_count_fast(g, core=128, chunk=4096, device="cpu")
    c = rc.rectangle_count_fast(g, core=128, chunk=100, device="cpu")
    assert a == b == c > 0


def test_recursion_depth_vs_wedge_anchor(monkeypatch):
    """Deeper matrix-product levels (no wedge cut until depth 6) and the
    wedge-anchor closer at depth 1 give the same count."""
    g = rmat(11, 8, seed=5)
    closed = rc.rectangle_count_fast(g, core=64, device="cpu")
    depths = []
    real = rc.rectangle_count_fast

    def spy(g_, *a, **kw):
        depths.append(kw.get("_depth", 0))
        return real(g_, *a, **kw)

    monkeypatch.setattr(rc, "WEDGE_NATIVE_CUT", -1)
    monkeypatch.setattr(rc, "rectangle_count_fast", spy)
    deep = spy(g, core=64, device="cpu")
    assert deep == closed == jr.rectangle_count_fast(jax_graph(g), core=64)
    assert max(depths) >= 2


def test_c4_anchor_equals_jax_and_numpy(monkeypatch):
    """The port's gm_c4 binding equals the JAX package's and the numpy
    closer (the library hidden) on sorted relabeled graphs."""
    for g in (erdos_renyi(150, 0.08, 4),
              rmat(9, 8, seed=6).relabel_by_degree(descending=False)):
        nat = native_bridge.c4_anchor(g.rowptr, g.colidx)
        assert nat is not None and nat > 0
        assert nat == jnb.c4_anchor(g.rowptr, g.colidx)
        assert nat == rc._c4_dense(g)
        with monkeypatch.context() as m:
            m.setattr(native_bridge, "c4_anchor", lambda *a: None)
            assert rc._c4_wedge_anchor(g) == nat


def test_workload_routing():
    """sgl rectangle --fast against the generic frontier plan, at core 32
    on an ER graph (so cases B and C run)."""
    g = erdos_renyi(120, 0.1, 3)
    want = sgl_count(g, "rectangle", device="cpu")
    assert want > 0
    assert sgl_count(g, "rectangle", fast=True, device="cpu") == want == \
        rc.rectangle_count_fast(g, core=32, device="cpu")
