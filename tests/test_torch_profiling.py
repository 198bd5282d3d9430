"""utils/profiling.py's spans: nesting and self time, what records with
tracing on and off, the count path's host events under torch.profiler,
threads, and the device event pair only under PROFILER.enabled."""
import json
import sys
import threading
import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from graphminer_tpu_torch.io.loader import save_graph
from graphminer_tpu_torch.io.synth import rmat
from graphminer_tpu_torch.ops.cliquek import CliqueKEngine
from graphminer_tpu_torch.ops.hybrid import HybridEngine
from graphminer_tpu_torch.utils.profiling import PROFILER, Profiler


@pytest.fixture
def untraced():
    """PROFILER with tracing off (the CLI's --profile leaves it on in a
    process that ran main), restored after."""
    was = PROFILER.enabled
    PROFILER.enabled = False
    yield PROFILER
    PROFILER.enabled = was


@pytest.fixture(scope="module")
def rg():
    return rmat(10, 8, seed=7).relabel_by_degree(
        descending=False).orientation()


def _by_name(prof):
    return {r.name: r for r in prof.span_records()}


def _mark(prof):
    """The largest id of a span record (-1 without one)."""
    return max((r.id for r in prof.span_records()), default=-1)


def _since(prof, mark):
    """The records of spans opened after `mark` (the buffer may be full,
    so no index into it)."""
    return [r for r in prof.span_records() if r.id > mark]


def test_spans_nest_and_self_time_excludes_children():
    prof = Profiler()
    with prof.span("outer") as outer:
        time.sleep(0.01)
        with prof.span("inner"):
            time.sleep(0.02)
        with prof.span("inner"):
            time.sleep(0.01)
    recs = _by_name(prof)
    inners = [r for r in prof.span_records() if r.name == "inner"]
    assert len(inners) == 2 and all(r.parent == recs["outer"].id
                                    for r in inners)
    assert recs["outer"].parent is None
    child = sum(r.end - r.start for r in inners)
    assert outer.seconds == pytest.approx(recs["outer"].end
                                          - recs["outer"].start)
    assert recs["outer"].self_s == pytest.approx(outer.seconds - child)
    assert prof.seconds["outer"] == pytest.approx(outer.seconds)
    assert prof.self_seconds["outer"] == pytest.approx(outer.seconds - child)
    assert prof.seconds["inner"] == pytest.approx(child)
    assert 0.005 < recs["outer"].self_s < outer.seconds - 0.025
    rep = prof.report()
    assert set(rep) == {"phases_s", "phases_self_s", "counters"}
    assert rep["phases_s"]["inner"] == pytest.approx(child, abs=1e-6)


def test_a_span_closes_when_its_block_raises():
    prof = Profiler()
    with pytest.raises(ValueError):
        with prof.span("outer"):
            with prof.span("inner"):
                raise ValueError("x")
    assert [r.name for r in prof.span_records()] == ["inner", "outer"]
    with prof.span("next"):
        pass
    assert prof.span_records()[-1].parent is None


def test_hot_spans_record_only_while_tracing_and_setup_spans_always():
    prof = Profiler()
    with prof.span("count", hot=True) as sp:
        pass
    assert sp is None and prof.span_records() == []
    with prof.span("build.pack"):
        pass
    assert [r.name for r in prof.span_records()] == ["build.pack"]
    prof.enabled = True
    with prof.span("count", hot=True) as sp:
        pass
    assert sp is not None
    with profile(activities=[ProfilerActivity.CPU]):
        prof.enabled = False
        with prof.span("count.launch", hot=True):
            pass
    assert [r.name for r in prof.span_records()] == [
        "build.pack", "count", "count.launch"]


def test_a_span_is_a_decorator_that_records_each_call():
    prof = Profiler()

    @prof.span("build.pack", label="x")
    def pack(n):
        return n + 1

    assert pack(1) == 2 and pack(2) == 3
    recs = prof.span_records()
    assert [r.name for r in recs] == ["build.pack"] * 2
    assert recs[0].attrs == {"label": "x"} and recs[0].id != recs[1].id


def test_the_record_buffer_keeps_the_newest():
    prof = Profiler(capacity=4)
    for i in range(10):
        with prof.span(f"s{i}"):
            pass
    assert [r.name for r in prof.span_records()] == ["s6", "s7", "s8", "s9"]
    assert len(prof.seconds) == 10
    prof.reset()
    assert prof.span_records() == [] and not prof.seconds


def test_threads_lose_no_totals_counts_or_records():
    prof = Profiler()
    n_threads, per = 6, 400
    barrier = threading.Barrier(n_threads)

    def work(i):
        barrier.wait(timeout=30)
        for _ in range(per):
            with prof.span("outer", card=i):
                with prof.span("inner"):
                    prof.count("n")
            prof.add("added", 1.0)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        ts = [threading.Thread(target=work, args=(i,))
              for i in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    recs = prof.span_records()
    assert prof.counters["n"] == n_threads * per
    assert prof.seconds["added"] == n_threads * per
    assert len(recs) == 2 * n_threads * per
    by_id = {r.id: r for r in recs}
    assert len(by_id) == len(recs)
    for r in recs:
        if r.name == "inner":
            parent = by_id[r.parent]
            assert parent.name == "outer" and parent.thread == r.thread
    assert {r.attrs["card"] for r in recs if r.name == "outer"} == \
        set(range(n_threads))
    assert prof.seconds["outer"] == pytest.approx(
        sum(r.end - r.start for r in recs if r.name == "outer"))


@pytest.mark.parametrize("make", ["hybrid", "cliquek"])
def test_a_count_under_torch_profiler_shows_its_spans(rg, untraced, make):
    eng = (HybridEngine(rg, core=256, device="cpu") if make == "hybrid"
           else CliqueKEngine(rg, 4, core=256, device="cpu"))
    want = eng.count()
    mark = _mark(untraced)
    before_dc = untraced.seconds.get("device_count", 0.0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        got = eng.count()
    assert got == want
    events = {e.name: e for e in prof.events()}
    assert {"count", "count.launch", "count.readback"} <= set(events)
    c, lo, rb = (events[n].time_range for n in
                 ("count", "count.launch", "count.readback"))
    assert c.start <= lo.start and lo.end <= rb.start and rb.end <= c.end
    recs = _since(untraced, mark)
    names = [r.name for r in recs]
    assert names == ["count.launch", "count.readback", "count"]
    assert recs[0].parent == recs[2].id == recs[1].parent
    assert untraced.seconds.get("device_count", 0.0) == before_dc


def test_untraced_counts_record_no_span_and_no_event_pair(rg, untraced,
                                                          monkeypatch):
    def no_event(*a, **k):
        raise AssertionError("a CUDA event pair with tracing off")
    monkeypatch.setattr(torch.cuda, "Event", no_event)
    eng = HybridEngine(rg, core=256, device="cpu")
    before_dc = untraced.seconds.get("device_count", 0.0)
    mark = _mark(untraced)
    eng.count()
    assert _since(untraced, mark) == []
    assert untraced.seconds.get("device_count", 0.0) == before_dc
    # the count path as a CUDA engine calls it: no event pair, no sync
    assert untraced.engine_count(lambda: torch.tensor(7), "cuda", 3) == 7
    with untraced.span("device_count", "cuda", hot=True) as sp:
        pass
    assert sp is None
    untraced.enabled = True
    with pytest.raises(AssertionError, match="event pair"):
        untraced.engine_count(lambda: torch.tensor(7), "cuda", 3)


def test_enabled_times_the_device_count_phase_on_the_cpu(rg, untraced):
    eng = HybridEngine(rg, core=256, device="cpu")
    before = untraced.seconds.get("device_count", 0.0)
    untraced.enabled = True
    eng.count()
    assert untraced.seconds["device_count"] > before
    assert untraced.span_records()[-1].name == "count"


def test_build_spans_split_the_constructor(rg, untraced):
    mark = _mark(untraced)
    eng = CliqueKEngine(rg, 4, core=256, device="cpu")
    recs = _since(untraced, mark)
    build = [r for r in recs if r.name == "build"]
    assert len(build) == 1
    names = {r.name for r in recs}
    assert {"build.pack", "build.upload", "build.enumerate",
            "build.tail"} <= names
    tail = next(r for r in recs if r.name == "build.tail")
    assert eng.tail_s == pytest.approx(tail.end - tail.start)
    assert eng.prep_s == pytest.approx(tail.start - build[0].start)
    kids = sum(r.end - r.start for r in recs if r.parent == build[0].id)
    assert build[0].self_s == pytest.approx(
        build[0].end - build[0].start - kids)
    assert all(r.start >= build[0].start and r.end <= build[0].end
               for r in recs)


def test_cli_profile_reports_spans_counters_and_launches(tmp_path, capsys,
                                                         untraced):
    from graphminer_tpu_torch.__main__ import main
    p = str(tmp_path / "graph")
    save_graph(rmat(9, 8, seed=3), p)
    assert main(["tc", p, "--fast", "--cpu", "--profile", "--json"]) == 0
    prof = json.loads(capsys.readouterr().out.strip().splitlines()[-1])[
        "profile"]
    assert untraced.enabled
    assert prof["phases_s"]["device_count"] > 0
    assert {"build", "build.pack", "count", "count.launch",
            "count.readback"} <= set(prof["phases_self_s"])
    assert prof["counters"]["edge_tasks"] > 0
    assert set(prof["kernel_launches"].values()) == {0}


def test_sharded_count_gives_each_card_thread_a_span(rg, untraced):
    from graphminer_tpu_torch.core.plan import TRIANGLE
    from graphminer_tpu_torch.parallel import mesh
    m = mesh.make_mesh(devices=[f"cpu:{i % 4}" for i in range(8)],
                       shape=(2, 4))
    mark = _mark(untraced)
    want = HybridEngine(rg, core=256, device="cpu").count()
    assert mesh.count_pattern_sharded(rg, TRIANGLE, mesh=m, chunk=256) == want
    recs = _since(untraced, mark)
    cards = [r for r in recs if r.name == "sharded.card"]
    top = next(r for r in recs if r.name == "sharded_count")
    assert sorted(r.attrs["card"] for r in cards) == [0, 1, 2, 3]
    assert all(top.start <= r.start and r.end <= top.end for r in cards)
