"""Kernel R's plain version and the port's probe scripts
(graphminer_tpu_torch/scripts/{launch_check,prof_breakdown}.py) on the CPU
at small sizes; the card runs them at full size in chip_smoke.py."""
import numpy as np
import pytest
import torch

from graphminer_tpu_torch.ops import cuda_check
from graphminer_tpu_torch.scripts import (launch_check, prof_breakdown,
                                          prof_rectangle, prof_window)


def test_times_two_plain_wraps_like_int32():
    rng = np.random.default_rng(0)
    x = rng.integers(-(1 << 31), 1 << 31, size=(8, 128), dtype=np.int64
                     ).astype(np.int32)
    x[0, :3] = [np.iinfo(np.int32).max, np.iinfo(np.int32).min, -1]
    got = cuda_check.times_two(torch.from_numpy(x))
    assert got.dtype == torch.int32 and got.shape == (8, 128)
    assert np.array_equal(got.numpy(), x * np.int32(2))


def test_launch_check_on_cpu(capsys):
    launch_check.main(["--device", "cpu"])
    assert capsys.readouterr().out.startswith("OK: 2 in")


def test_prof_breakdown_on_cpu(monkeypatch, capsys):
    """The script's whole flow at scale 12 with a small fetch table: the
    tail and spoke counts add up to the graph's triangle count (the same
    as the stream engine's), and every fetch shape ran and agreed."""
    from graphminer_tpu_torch.io.synth import rmat
    from graphminer_tpu_torch.ops.stream import triangle_count_stream
    monkeypatch.setattr(prof_breakdown, "SCALE", 12)
    monkeypatch.setattr(prof_breakdown, "FETCH_ROWS", 1 << 10)
    monkeypatch.setattr(prof_breakdown, "FETCH_COUNTS", (64, 512))
    monkeypatch.setattr(prof_breakdown, "REPS", 1)
    res = prof_breakdown.main(["--device", "cpu"])
    want = triangle_count_stream(rmat(12, 16, seed=7), device="cpu")
    assert res["tail"]["count"] + res["spoke"]["count"] == want
    assert len(res["fetch"]) == 8
    out = capsys.readouterr().out
    assert "tail:" in out and "spoke:" in out and "fetch w= 256" in out


def test_prof_breakdown_clique_on_cpu(monkeypatch, capsys):
    """--clique at scale 10: every form of the hi part (kernel G's path,
    the slab form on 1, 2 and 4 streams, the bucket form at k = 5) reaches
    the engine's hi total (the script raises otherwise), each timed twice
    in turns; the buckets expand more rows than the flat list, which
    expands each triangle task once; G's bound over the mask's set bits
    counts no more operations than over its tiles, nor those more than
    over the full Gram."""
    from graphminer_tpu_torch.io.synth import rmat
    from graphminer_tpu_torch.ops.cliquek import CliqueKEngine
    from graphminer_tpu_torch.ops.slab_form import HI_STREAMS
    monkeypatch.setattr(prof_breakdown, "SCALE", 10)
    monkeypatch.setattr(prof_breakdown, "REPS", 1)
    res = prof_breakdown.main(["--device", "cpu", "--clique"])["clique"]
    eng = CliqueKEngine(rmat(10, 16, seed=7), 5, device="cpu")
    rows = res[5]["expanded_rows"]
    assert rows["flat"] == -(-eng.n_tri // 32) * 32 < rows["buckets"]
    assert res[5]["hi"] == int(eng.hi_partials().sum()) > 0
    assert res[5]["n_tiles"] == eng.gram_plan.n_tiles
    flat = ["G"] + [f"slab form, {n} streams" for n in (1, 2, 4)]
    assert sorted(res[4]["ms"]) == sorted(flat)
    assert sorted(res[5]["ms"]) == sorted(flat +
                                          [f"buckets, {HI_STREAMS} streams"])
    for k in (4, 5):
        assert all(len(v) == 2 for v in res[k]["ms"].values())
        b = res[k]["bounds"]
        assert 0 < b["ops_mask"] <= b["ops_tiles"] <= b["ops_full"]
    assert "clique k=5 hi part" in capsys.readouterr().out


@pytest.mark.parametrize("scale,core", [(10, 64), (10, 32), (12, 64)])
def test_tail_bytes_counts_each_named_row_prefix_once(scale, core):
    """E's bound bytes against a per-task walk: each row a real task names,
    as wide as the widest clamped prefix its groups read, the real task ids
    and one int64 per group; never more than the whole tables. (10, 32) and
    (12, 64) have class-64 groups wider than the stored tail (wt_pad 32 and
    48), so the clamp is exercised."""
    from graphminer_tpu_torch.io.synth import rmat
    from graphminer_tpu_torch.ops.hubcore import TriangleEngine
    from graphminer_tpu_torch.types import SENTINEL
    eng = TriangleEngine(rmat(scale, 16, seed=7), core=core, chunk=128,
                         device="cpu")
    words = eng.layout.words
    wt = eng.tables.src_rows.shape[1] - words
    src_w, dst_w, n_tasks = {}, {}, 0
    for (s, d), (wa, wb, _ck) in zip(eng.group_arrays, eng.spec):
        wa_, wb_ = min(wa, wt), min(wb, wt)
        if not (wa_ and wb_):
            wa_ = wb_ = 0
        for u, v in zip(s.reshape(-1).tolist(), d.reshape(-1).tolist()):
            if u == SENTINEL:
                continue
            n_tasks += 1
            src_w[u] = max(src_w.get(u, 0), words + wa_)
            dst_w[v] = max(dst_w.get(v, 0), words + wb_)
    want = 4 * (sum(src_w.values()) + sum(dst_w.values()) + 2 * n_tasks) \
        + 8 * len(eng.spec)
    assert n_tasks == eng.n_tail_tasks > 0
    got = prof_breakdown.tail_bytes(eng)
    assert got == want
    tab = eng.tables
    assert got <= 4 * (tab.src_rows.numel() + tab.dst_rows.numel()
                       + sum(s.numel() + d.numel()
                             for s, d in eng.group_arrays)) + 8 * len(eng.spec)


@pytest.mark.parametrize("script,argv", [
    (launch_check, []), (prof_breakdown, []),
    (prof_window, ["1024", "256", "128", "8"]),
    (prof_rectangle, ["--scale", "8"])])
def test_scripts_need_a_card_by_default(monkeypatch, script, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        script.main(argv)


def test_prof_rectangle_on_cpu(capsys):
    """prof_rectangle at scale 12 on the CPU: the golden count, once a rep,
    and no device figures."""
    res = prof_rectangle.main(["--device", "cpu", "--scale", "12",
                               "--reps", "1"])
    assert res["count"] == prof_rectangle.GOLDEN[12]
    assert len(res["host_s"]) == 1 and "device_ms" not in res
    assert '"count": 52988519' in capsys.readouterr().out


def test_prof_cliquebig_on_cpu(capsys):
    """prof_cliquebig at scale 9: at k = 6 the host and the device path (in
    turns, then at a small CAP6 in several chunks) and at k = 7 the one
    path give the native DFS count, with one dispatch counted per launch
    the engine made."""
    from graphminer_tpu_torch import native_bridge
    from graphminer_tpu_torch.io.synth import rmat
    from graphminer_tpu_torch.scripts import prof_cliquebig
    rg = rmat(9, 16, seed=7).relabel_by_degree(
        descending=False).orientation()
    for k, extra in ((6, ["--caps", "65536"]), (7, [])):
        res = prof_cliquebig.main(["--device", "cpu", "--k", str(k),
                                   "--scales", "9", *extra])
        runs = res["scales"][9]["runs"]
        want = native_bridge.kclique_dfs(rg.rowptr, rg.colidx, k)
        assert [r["count"] for r in runs] == [want] * len(runs)
        assert len(runs) == (5 if k == 6 else 2)
        if k == 6:
            assert [r["path"] for r in runs] == ["host", "device", "device",
                                                  "host", "device"]
            assert runs[-1]["dispatches"]["quad"] > 1
    assert "rmat9 k=7" in capsys.readouterr().out
