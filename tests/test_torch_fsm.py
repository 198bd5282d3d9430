"""Port FSM (graphminer_tpu_torch/workloads/fsm.py) against the JAX
package's workloads/fsm.py on the same numpy-seeded labelled graphs: the
device steps (forward extension, backward filter, MNI support) on the same
parent buffers, column for column, and fsm_count, all exact."""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphminer_tpu.core.graph import HostGraph as JHostGraph
from graphminer_tpu.workloads import fsm as jfsm
from graphminer_tpu_torch.core.graph import HostGraph
from graphminer_tpu_torch.io.synth import labeled_er, rmat
from graphminer_tpu_torch.utils.profiling import PROFILER
from graphminer_tpu_torch.workloads import fsm


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: these searches issue many small ops, and under
    xdist the workers' intra-op threads only contend for the cores (24x
    slower with 6 workers of 8 threads on 8 cores)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def jax_graph(g):
    return JHostGraph(rowptr=g.rowptr, colidx=g.colidx, vlabels=g.vlabels,
                      elabels=g.elabels)


@functools.lru_cache(maxsize=None)
def rmat10():
    """rmat(10, 8, seed=7) labelled by default_rng(7).integers(1, 5), as
    bench.py labels its FSM graphs."""
    g = rmat(10, 8, seed=7)
    g.vlabels = np.random.default_rng(7).integers(
        1, 5, g.n_vertices).astype(np.uint8)
    return g


@functools.lru_cache(maxsize=None)
def er_elab():
    return labeled_er(60, 0.15, n_vlabels=3, n_elabels=2, seed=4)


def live(buf, n):
    return np.asarray(buf)[:, :n]


def same_emb(jde, de):
    assert de.n == int(jde.n)
    assert np.array_equal(live(de.buf.numpy(), de.n), live(jde.buf, de.n))
    if de.n:
        assert (de.buf.numpy()[:, de.n:] == fsm.SENTINEL).all()


def searches(g):
    """(JAX _FSM, port _FSM) with their frequent triples filled, as run()
    fills them before its first extension."""
    jf, pf = jfsm._FSM(jax_graph(g), 2), fsm._FSM(g, 2, device="cpu")
    for f in (jf, pf):
        for pat, de in f.initial_patterns().values():
            la, lb = pat.vlabels
            f.freq_triples.add((min(la, lb), pat.elabels[0] if pat.elabels
                                else 0, max(la, lb)))
    return jf, pf


@pytest.mark.parametrize("graph", ["er_elab", "rmat10"])
def test_device_steps_equal_jax(graph):
    """Every single-edge pattern's buffer, every forward extension of it
    and every backward filter of its forward children: live columns, n and
    the fused support equal JAX's, and the standalone support too."""
    g = er_elab() if graph == "er_elab" else rmat10()
    jf, pf = searches(g)
    jinit, pinit = jf.initial_patterns(), pf.initial_patterns()
    assert list(jinit) == list(pinit)
    n_ext = n_back = 0
    for key, (pat, de) in pinit.items():
        jde = jinit[key][1]
        same_emb(jde, de)
        assert pf.support(de) == jf.support(jde)
        for at in range(2):
            for el, label in pf._ext_candidates(pat.vlabels[at])[:2]:
                ne = pf.forward_extend(de, at, label, el)
                jne = jf.forward_extend(jde, at, label, el)
                same_emb(jne, ne)
                assert ne.sup == jne.sup
                n_ext += 1
                child = pat.add_forward(at, label, el if pf.use_elab
                                        else None)
                for elb in pf._backward_elabels(child.vlabels[1 - at],
                                                child.vlabels[2]):
                    fb = pf.backward_filter(ne, 1 - at, 2, elb)
                    jb = jf.backward_filter(jne, 1 - at, 2, elb)
                    same_emb(jb, fb)
                    assert fb.sup == jb.sup
                    n_back += 1
    assert n_ext > 0 and n_back > 0


def test_forward_overflow_equals_jax():
    """A child count past JAX's first cap: the direct step at that cap keeps
    JAX's first cap_c children and reports the same count; forward_extend,
    which sizes the child by its label bound, runs once (no
    fsm_overflow_retries) and equals JAX's retried buffer."""
    g = rmat10()
    jf, pf = searches(g)
    jinit, pinit = jf.initial_patterns(), pf.initial_patterns()
    key = max(pinit, key=lambda k: pinit[k][1].n)
    pat, de = pinit[key]
    jde = jinit[key][1]
    el, label = pf._ext_candidates(pat.vlabels[0])[0]
    cap_c = fsm._cap_for(de.n)
    args = dict(width=pf.width, nv=de.nv, cap_p=de.cap, cap_c=cap_c,
                use_elab=False)
    buf, n, sup = fsm._forward_extend_dev(pf.dg, pf.vlab, de.buf, de.n, 0,
                                          label, el, **args)
    jbuf, jn, _ = jfsm._forward_extend_dev(
        jf.dg, jf.vlab, jde.buf, jnp.int32(jde.n), jnp.int32(0),
        jnp.int32(label), jnp.int32(el), **args)
    assert n == int(jn) > cap_c and sup is None
    assert np.array_equal(buf.numpy(), np.asarray(jbuf))
    before = PROFILER.counters["fsm_overflow_retries"]
    ne = pf.forward_extend(de, 0, label, el)
    assert PROFILER.counters["fsm_overflow_retries"] == before
    jne = jf.forward_extend(jde, 0, label, el)
    same_emb(jne, ne)
    assert ne.sup == jne.sup and ne.cap >= jne.cap == fsm._cap_for(n)


def test_mni_support_equals_jax():
    """The support over random buffers with SENTINEL tails, repeated ids and
    an empty live range, whole and over the live prefix."""
    rng = np.random.default_rng(3)
    for nv, cap, n in ((2, 1024, 700), (3, 64, 64), (4, 1024, 0)):
        buf = np.full((nv, cap), fsm.SENTINEL, dtype=np.int32)
        buf[:, :n] = rng.integers(0, 50, (nv, n))
        t = torch.from_numpy(buf)
        want = int(jfsm._mni_support_device(jnp.asarray(buf)))
        assert int(fsm._mni_support_device(t)) == want
        assert int(fsm._mni_support_device(t, n)) == want


@pytest.mark.parametrize("seed,n,p,labels,k,minsup", [
    (0, 16, 0.3, 2, 2, 3),
    (1, 18, 0.25, 3, 3, 3),
    (2, 20, 0.3, 2, 3, 5),
    (3, 14, 0.4, 3, 2, 2),
])
def test_fsm_count_equals_jax(seed, n, p, labels, k, minsup):
    g = labeled_er(n, p, n_vlabels=labels, seed=seed)
    assert fsm.fsm_count(g, k, minsup, device="cpu") == \
        jfsm.fsm_count(jax_graph(g), k, minsup)


def test_fsm_elabels_split_patterns():
    """Edge labels split single-edge patterns (the JAX package's
    test_fsm_elabels_split_patterns graph), in both packages."""
    src = np.array([0, 0, 0, 0, 1, 1, 1, 1])
    dst = np.array([2, 3, 4, 5, 6, 7, 8, 9])
    el = np.array([5, 5, 9, 9, 5, 5, 9, 9], dtype=np.uint16)
    g = HostGraph.from_edges(src, dst, 10, symmetrize=True, elabels=el,
                             vlabels=np.array([1, 1] + [2] * 8,
                                              dtype=np.uint8)).sort_neighbors()
    g2 = HostGraph(rowptr=g.rowptr, colidx=g.colidx, vlabels=g.vlabels)
    for h, want in ((g, 2), (g2, 1)):
        assert fsm.fsm_count(h, 1, 2, device="cpu") == want == \
            jfsm.fsm_count(jax_graph(h), 1, 2)
    assert fsm.fsm_count(g, 2, 2, device="cpu") == \
        jfsm.fsm_count(jax_graph(g), 2, 2)


@pytest.mark.parametrize("minsup,want", [(30, 50), (100, 36)])
def test_fsm_rmat10(minsup, want):
    """Labelled rmat10, k = 2 (50 is the most 4 labels allow; 36 is not)."""
    g = rmat10()
    f = fsm._FSM(g, minsup, device="cpu")
    assert f.run(2) == want == jfsm.fsm_count(jax_graph(g), 2, minsup)
    assert sum(s >= minsup for s in f.supports.values()) == want


@pytest.mark.parametrize("graph,k,minsup,classes", [
    ("er_elab", 3, 4, (8, 12)), ("rmat10", 2, 30, (128, 1024))])
def test_fsm_width_classes_equal_jax(monkeypatch, graph, k, minsup, classes):
    """The anchor-degree width classes, engaged in the port only by a
    lowered WIDTH_CLASS_MIN, change no count or support: on the ER graph
    some calls take the narrow class 12 (max degree 17), on rmat10 every
    call the wide class 1024 (its patterns all hold a hub of degree 363)."""
    g = er_elab() if graph == "er_elab" else rmat10()
    plain = fsm._FSM(g, minsup, device="cpu")
    want = plain.run(k)
    monkeypatch.setattr(fsm, "WIDTH_CLASS_MIN", 4)
    monkeypatch.setattr(fsm, "FSM_WIDTH_CLASSES", classes)
    f = fsm._FSM(g, minsup, device="cpu")
    widths = []
    call_width = f._call_width
    monkeypatch.setattr(f, "_call_width", lambda de, at, label=None: (
        widths.append(call_width(de, at, label)) or widths[-1]))
    assert f.run(k) == want == jfsm.fsm_count(jax_graph(g), k, minsup)
    assert f.supports == plain.supports
    assert {w for w, _ in widths} - {f.width} and len(widths) > 20
