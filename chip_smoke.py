#!/usr/bin/env python3
"""Smoke test of graphminer_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Drives the port's paths — exact triangle counting on RMAT scale 18, edge
factor 16, seed 7 (82,947,332 triangles) through the stream, ring,
hub-core and hybrid engines and the generic set-operation path, the
three probe scripts, the generic clique and SgL counts, and the fast 4- and
5-clique engine on the same graph (2,280,263,816 and 55,374,832,965) — and
fails (non-zero exit, no result line) when any phase fails:

  1. card and versions; exits when torch.cuda.is_available() is false;
  2. builds the CUDA kernels from graphminer_tpu_torch/csrc with nvcc, then
     launches kernel R through the port's launch_check script;
  3. holds kernels A, B, C, D, E, m3, m3b, R, X and L against their plain
     PyTorch versions on the card, exactly: random inputs over every width
     class, A, B, C and E also as one grouped launch over random
     multi-bucket sets, X in both layouts, plain and gathered (depth 0-4),
     L at 3-8 rows a task and with no task (no launch), then the real
     buckets and tail groups of rmat14 builds, one by one and grouped
     (counts 2,860,691, also through TriangleEngine), and X's slabs, B_hh
     and L's lo tasks of the rmat14 CliqueKEngine at k = 4 and 5;
  4. runs `python -m graphminer_tpu_torch tc <rmat18> --fast --json
     --profile` and checks its count and that kernel A launched once;
  5. runs the ring engine on the same graph and checks its count and that
     kernels B and C launched once each;
  6. runs TriangleEngine on the same graph (count, tail + core split,
     kernel E launched once, the spoke expanded by kernel X, which is held
     to its plain version on the spoke's first slab and core mask), the
     port's prof_breakdown at rmat18 (kernels E and D) and prof_window at
     its defaults (m1 = m2 = m3 = m3b), in process;
  7. times every kernel with CUDA events (median of 11 after warm-up),
     kernel and plain version side by side, each beside the least time an
     H100 could take for the same work (A, B, C and E as the engines'
     single launch, A also over groups of the rmat18 buckets; B also with
     the bytes it reads past L1), the spoke product (torch._int_mm) against
     its operations bound, the device-busy share of stream, ring and
     hub-core counts from torch.profiler; the device time alone
     (torch.profiler) of D at each of prof_breakdown's shapes, of m3 and
     m3b, and of R and torch.mul,
     failing unless a D call and a window_count call each run one kernel
     and no other device op; and R's host time a call, split into the
     parts of its wrapper's path (host clock over 10,000 calls);
  8. runs the hybrid engine (ring phase C + sub-core stream) on rmat18:
     count, one launch each of B and A and none of C or E, the coverage
     of the DAG edges, layout bytes, device count time and busy share;
  9. runs `python -m graphminer_tpu_torch` without --cpu: tc on rmat18,
     clique 4 and 5 on rmat14 (36,628,817 and 387,027,732) generic and
     with --fast (CliqueKEngine: X launched, L once where there are lo
     tasks), sgl diamond and rectangle on rmat12 (57,515,371 and
     52,988,519), each against its golden, with its run_s;
 10. holds the frontier's map engine against its compact engine on the
     card at rmat10, cliques k = 3-5 and the four SGL plans;
 11. holds every set operation, both backends, on the card against the
     CPU on random rows of widths 8-4096;
 12. sizes the hybrid's sub-core stream at rmat20 (build_stream
     plan_only), builds the engine and checks its count (423,537,282),
     the estimate against the built bytes, its launches, the peak device
     memory and the device count time;
 13. builds CliqueKEngine on rmat18 at k = 4, then at k = 5, and checks each
     count (2,280,263,816 and 55,374,832,965), that X launched once a slab
     and L once, and prints prep time, task counts, the device count split
     hi / lo, X's, torch._int_mm's and L's device time beside their bounds
     and the peak device memory; then holds X to its plain version on the
     first and the last slab of each count and L on each lo task list.

Each path of phases 2, 4-6, 8, 12 and 13 runs with every launch count set to
0 just before it, and its counts are read just after. The line before the
last is the card's name and power limit; the last line is {"ok": true,
"device": {...}}. The rmat12, rmat14, rmat18 and rmat20 graphs are written
under the git-ignored graph_cache/ directory.
"""
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

REPO = os.path.dirname(os.path.abspath(__file__))
GOLDEN = {14: 2_860_691, 18: 82_947_332,     # rmat(scale, 16, seed=7)
          20: 423_537_282}
PREFIX = os.path.join(REPO, "graph_cache", "rmat18_ef16_seed7", "graph")
REPS = 11
SENTINEL = 0x7FFFFFFF
CARD = "unknown card"

KERNELS = {
    "stream_bucket_count": {
        "route": "cuda",
        "source": "graphminer_tpu_torch/csrc/stream_count.cu",
        "replaces": "graphminer_tpu/ops/stream.py:353"},
    "ring_phase_c": {
        "route": "cuda",
        "source": "graphminer_tpu_torch/csrc/ring_phase_c.cu",
        "replaces": "graphminer_tpu/ops/pallas_ring.py:41"},
    "ring_tail_pairs": {
        "route": "cuda",
        "source": "graphminer_tpu_torch/csrc/ring_tail_pairs.cu",
        "replaces": "graphminer_tpu/ops/ring.py:361"},
    "fetch_rows_sum": {
        "route": "cuda",
        "source": "graphminer_tpu_torch/csrc/fetch_rows_sum.cu",
        "replaces": "graphminer_tpu/ops/pallas_fetch.py:20"},
    "hub_tail_count": {
        "route": "cuda",
        "source": "graphminer_tpu_torch/csrc/hub_tail_count.cu",
        "replaces": "graphminer_tpu/ops/hubcore.py:221"},
    "window_count_m3": {
        "route": "cuda",
        "source": "graphminer_tpu_torch/csrc/window_count.cu",
        "replaces": "scripts/prof_window.py:134"},
    "window_count_m3b": {
        "route": "cuda",
        "source": "graphminer_tpu_torch/csrc/window_count.cu",
        "replaces": "scripts/prof_window.py:183"},
    "times_two": {
        "route": "cuda",
        "source": "graphminer_tpu_torch/csrc/times_two.cu",
        "replaces": "scripts/repro_mosaic_hang.py:26"},
    "expand_bits": {
        "route": "cuda",
        "source": "graphminer_tpu_torch/csrc/expand_bits.cu",
        "replaces": "graphminer_tpu/ops/hubcore.py:252"},
    "lo_popcount": {
        "route": "cuda",
        "source": "graphminer_tpu_torch/csrc/lo_popcount.cu",
        "replaces": "graphminer_tpu/ops/cliquek.py:311"},
}
#: rmat(18, 16, seed=7) k-cliques (bench.py:64-68)
GOLDEN_CK = {4: 2_280_263_816, 5: 55_374_832_965}
MAX_ERR = {k: 0 for k in KERNELS}
#: window_count's rows_per_step of kernels m3 and m3b
WINDOW_ROWS = {"window_count_m3": 1, "window_count_m3b": 8}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def say(msg):
    print(msg, flush=True)


def card_line() -> str:
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except FileNotFoundError:
        return "nvidia-smi: not found"
    return (r.stdout.strip().splitlines() or ["nvidia-smi: no output"])[0]


def check_environment():
    global CARD
    CARD = card_line()
    say(CARD)
    say(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: torch.cuda.is_available() is false")


def build_kernels():
    from graphminer_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.kernels()
    say(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"({_build.lib_path()})")
    if _build.BUILD_INFO:
        for line in _build.BUILD_INFO["log"].splitlines():
            if "Used" in line or "spill" in line:
                say(f"  ptxas: {line.strip()}")


def wrappers():
    """{kernel name: wrapper} for every kernel that counts its launches in
    process (kernel A's count comes from the CLI's own process)."""
    from graphminer_tpu_torch.ops import (cuda_check, cuda_cliquek,
                                          cuda_expand, cuda_hubcore,
                                          cuda_ring, cuda_stream, cuda_window,
                                          fetch)
    return {"stream_bucket_count": cuda_stream.stream_bucket_count,
            "ring_phase_c": cuda_ring.ring_phase_c,
            "ring_tail_pairs": cuda_ring.ring_tail_pairs,
            "fetch_rows_sum": fetch.fetch_rows_sum,
            "hub_tail_count": cuda_hubcore.hub_tail_count,
            "window_count": cuda_window.window_count,
            "times_two": cuda_check.times_two,
            "expand_bits": cuda_expand.expand_bits,
            "lo_popcount": cuda_cliquek.lo_popcount}


def reset_counts():
    for name, fn in wrappers().items():
        if name == "window_count":
            fn.launches = {r: 0 for r in fn.launches}
        else:
            fn.launches = 0


def read_counts():
    """{kernel name: launches since reset_counts()}."""
    out = {}
    for name, fn in wrappers().items():
        if name == "window_count":
            for k, r in WINDOW_ROWS.items():
                out[k] = fn.launches[r]
        else:
            out[name] = fn.launches
    return out


def run_path(label, fn, kernels):
    """Run one path with every count at 0 before it; returns (fn's result,
    {kernel: launches} for `kernels`); fails if one was never launched."""
    reset_counts()
    val = fn()
    torch.cuda.synchronize()
    counts = read_counts()
    got = {k: counts[k] for k in kernels}
    say(f"{label}: launches {got}")
    check(all(v > 0 for v in got.values()),
          f"{label}: a kernel of the path was not launched: {got}")
    return val, got


def run_launch_check():
    from graphminer_tpu_torch.scripts import launch_check
    _, got = run_path("launch_check (kernel R)",
                      lambda: launch_check.main([]), ["times_two"])
    return got


def compare(name, kernel_val, plain_val, what):
    """Hold a kernel's result (a count or a tensor) against its plain
    version's, exactly, and keep the largest difference seen."""
    k = torch.as_tensor(kernel_val).to(torch.int64).cpu()
    p = torch.as_tensor(plain_val).to(torch.int64).cpu()
    check(k.shape == p.shape, f"{name} {what}: shapes {k.shape} {p.shape}")
    err = int((k - p).abs().max()) if k.numel() else 0
    MAX_ERR[name] = max(MAX_ERR[name], err)
    check(err == 0, f"{name} {what}: kernel != plain (max abs err {err})")


def compare_rows(name, kernel_val, plain_val, what):
    """compare() for large int8 tensors (kernel X's rows), on the card."""
    check(kernel_val.shape == plain_val.shape and
          kernel_val.dtype == plain_val.dtype == torch.int8,
          f"{name} {what}: {kernel_val.dtype} {tuple(kernel_val.shape)} vs "
          f"{plain_val.dtype} {tuple(plain_val.shape)}")
    err = int((kernel_val.to(torch.int16) - plain_val.to(torch.int16))
              .abs().max()) if kernel_val.numel() else 0
    MAX_ERR[name] = max(MAX_ERR[name], err)
    check(err == 0, f"{name} {what}: kernel != plain (max abs err {err})")


# --------------------------------------------------------------------------
# phase 3: kernel == plain
# --------------------------------------------------------------------------

def _tails(rng, rows, width, fill_max):
    """[rows, width] sorted unique non-negative ids, SENTINEL padded."""
    gaps = rng.integers(1, 12, size=(rows, width))
    vals = np.cumsum(gaps, axis=1).astype(np.int32)
    k = rng.integers(0, min(width, fill_max) + 1, size=rows)
    vals[np.arange(width)[None, :] >= k[:, None]] = SENTINEL
    return vals


def _words(rng, shape):
    """Random int32 words; about half have bit 31 set."""
    return rng.integers(-(1 << 31), 1 << 31, size=shape, dtype=np.int64
                        ).astype(np.int32)


def kernel_checks_random():
    from graphminer_tpu_torch.ops import cuda_ring, cuda_stream
    from graphminer_tpu_torch.ops.ring import C_CLASSES, T_CLASSES
    from graphminer_tpu_torch.ops.stream import WIDTH_CLASSES
    rng = np.random.default_rng(7)
    dev = torch.device("cuda")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    n_cases = 0
    # A: every ws x wtv (plus a wt_pad-like width), widths cycling
    for i, (ws, wtv, wta) in enumerate(
            [(ws, wtv, wta) for ws in (8, 32, 128)
             for wtv, wta in ((0, 0), (16, 8), (16, 0), (48, 32), (48, 64),
                              (200, 96))]):
        width = WIDTH_CLASSES[i % len(WIDTH_CLASSES)]
        n = max(8, min(256, (1 << 22) // (width * (ws + wta))))
        d = np.concatenate([_words(rng, (n, ws)),
                            _tails(rng, n, wtv, wtv)], axis=1)
        s = np.concatenate([_words(rng, (n * width, ws)),
                            _tails(rng, n * width, wta, wta)], axis=1)
        empty = rng.random(n * width) < 0.2          # SENTINEL src slots
        s[empty, :ws] = 0
        s[empty, ws:] = SENTINEL
        s = s.reshape(n, width, ws + wta)
        dd, sd = t(d), t(s)
        compare("stream_bucket_count",
                cuda_stream.stream_bucket_count(dd, sd, ws=ws, wtv=wtv),
                cuda_stream.stream_bucket_count_plain(dd, sd, ws=ws, wtv=wtv),
                f"random ws={ws} wtv={wtv} wta={wta} width={width}")
        n_cases += 1
    # B: every C_CLASSES width at the core table's 128 words, then other
    # word counts (small cores, and the generic path above 128 words)
    for wc, words, n_table in ([(wc, 128, 4096) for wc in C_CLASSES]
                               + [(64, 8, 200), (64, 40, 1300),
                                  (16, 264, 8448)]):
        n = max(8, min(512, (1 << 20) // wc))
        table, src = _words(rng, (n_table, words)), _words(rng, (n, words))
        dl = rng.integers(-3, n_table + 3, size=(n, wc)).astype(np.int32)
        dl[rng.random((n, wc)) < 0.1] = SENTINEL
        args = t(table), t(src), t(dl)
        compare("ring_phase_c", cuda_ring.ring_phase_c(*args),
                cuda_ring.ring_phase_c_plain(*args),
                f"random wc={wc} words={words}")
        n_cases += 1
    # C: tail tables of every T_CLASSES width against a few partners
    for wa in T_CLASSES:
        for wb in (8, 128, 2048):
            na, nb = 300, 200
            ta, tb = _tails(rng, na, wa, wa), _tails(rng, nb, wb, wb)
            n = max(8, min(4096, (1 << 22) // (wa * wb)))
            sa = rng.integers(-2, na + 2, size=n).astype(np.int32)
            sb = rng.integers(-2, nb + 2, size=n).astype(np.int32)
            sa[rng.random(n) < 0.05] = SENTINEL
            args = t(ta), t(tb), t(sa), t(sb)
            compare("ring_tail_pairs", cuda_ring.ring_tail_pairs(*args),
                    cuda_ring.ring_tail_pairs_plain(*args),
                    f"random wa={wa} wb={wb}")
            n_cases += 1
    n_cases += kernel_checks_random_slice2(rng, t)
    n_cases += kernel_checks_random_x_l(rng, t)
    n_cases += grouped_checks_random(rng, t)
    n_cases += grouped_checks_random_be(rng, t)
    torch.cuda.synchronize()
    say(f"kernel == plain on random inputs: {n_cases} cases exact")


def grouped_checks_random(rng, t):
    """A and C as one launch over random multi-bucket sets (3-12 buckets of
    mixed ws/wtv/wta with a one-row bucket, widths 2 and 2048, an empty
    bucket; tail tables up to 4096 wide with an empty tail bucket) against
    the sum of the plain versions; returns the number of cases."""
    from graphminer_tpu_torch.ops import cuda_ring, cuda_stream
    n_cases = 0
    for n_b in (3, 7, 12):
        specs = [(1, 2048, 8, 0, 0), (int(rng.integers(1, 300)), 2, 128, 48,
                                      32), (0, 32, 8, 16, 8)]
        for _ in range(n_b - 3):
            ws = int(rng.choice([8, 32, 128]))
            wtv, wta = [(0, 0), (16, 8), (16, 16), (48, 32), (48, 48)][
                int(rng.integers(5))]
            width = int(rng.choice([2, 8, 32, 128, 512, 2048]))
            specs.append((int(rng.integers(1, max(2, 8192 // width))), width,
                          ws, wtv, wta))
        buckets = []
        for n, width, ws, wtv, wta in specs:
            d = np.concatenate([_words(rng, (n, ws)),
                                _tails(rng, n, wtv, wtv)], axis=1)
            s = np.concatenate([_words(rng, (n * width, ws)),
                                _tails(rng, n * width, wta, wta)], axis=1)
            s[rng.random(n * width) < 0.2, ws:] = SENTINEL
            buckets.append((t(d), t(s.reshape(n, width, ws + wta)), ws, wtv))
        plan = cuda_stream.plan_stream(buckets)
        compare("stream_bucket_count",
                cuda_stream.stream_count_all(plan).sum(),
                cuda_stream.stream_count_all_plain(plan).sum(),
                f"grouped random, {n_b} buckets")
        n_cases += 1
        tables = {w: t(_tails(rng, 120, w, w)) for w in (8, 16, 64, 2048,
                                                         4096)}
        groups = []
        for i in range(n_b):
            wa, wb = (int(rng.choice(list(tables))) for _ in range(2))
            # the plain compare of a task is wa x wb: fewer wide pairs
            n = 0 if i == 1 else int(rng.integers(1, 3000)) // (
                1 + wa * wb // 65536)
            sa = rng.integers(-2, 122, size=n).astype(np.int32)
            sb = rng.integers(-2, 122, size=n).astype(np.int32)
            sa[rng.random(n) < 0.05] = SENTINEL
            groups.append((tables[wa], tables[wb], t(sa), t(sb)))
        plan = cuda_ring.plan_tail_pairs(groups)
        compare("ring_tail_pairs", cuda_ring.ring_tail_pairs_all(plan).sum(),
                cuda_ring.ring_tail_pairs_all_plain(plan).sum(),
                f"grouped random, {n_b} tail buckets")
        n_cases += 1
    return n_cases


def grouped_checks_random_be(rng, t):
    """B and E as one launch over random multi-bucket sets against the sum
    of the plain versions. B: 3-12 buckets over a 4096-row core table
    (staged), a 20,000-row bitmap table (read in place) and small tables of
    8 and 40 words; a one-row bucket, an empty one, wc 4 to 4096, half the
    src slices zero, SENTINEL and out-of-table slots. E: groups of every
    class pair of 0, 16, 64 and 256 over 48-slot tails (so wa and wb clamp
    to wt_pad), a one-task group, an empty group, SENTINEL padding and ids
    outside the tables. Words have bit 31 set about half the time. Returns
    the number of cases."""
    from graphminer_tpu_torch.ops import cuda_hubcore, cuda_ring
    from types import SimpleNamespace
    tables = {"core": _words(rng, (4096, 128)), "bm": _words(rng, (20000, 128)),
              "w8": _words(rng, (200, 8)), "w40": _words(rng, (1300, 40))}
    tables = {k: t(v) for k, v in tables.items()}
    n_cases = 0
    for n_b in (3, 7, 12):
        specs = [("core", 1, 4096), ("bm", 0, 16), ("core", 500, 64)]
        for _ in range(n_b - 3):
            key = str(rng.choice(["core", "core", "bm", "w8", "w40"]))
            wc = int(rng.choice([4, 16, 64, 256, 1024, 4096]))
            specs.append((key, int(rng.integers(1, max(2, 65536 // wc))), wc))
        groups = []
        for key, n, wc in specs:
            tab = tables[key]
            src = _words(rng, (n, tab.shape[1]))
            sl = tab.shape[1] // 8
            src.reshape(n, sl, 8)[rng.random((n, sl)) < 0.5] = 0
            dl = rng.integers(-3, tab.shape[0] + 3, size=(n, wc)
                              ).astype(np.int32)
            dl[rng.random((n, wc)) < 0.1] = SENTINEL
            groups.append((tab, t(src), t(dl)))
        plan = cuda_ring.plan_phase_c(groups)
        compare("ring_phase_c", cuda_ring.ring_phase_c_all(plan).sum(),
                cuda_ring.ring_phase_c_all_plain(plan).sum(),
                f"grouped random, {n_b} buckets")
        n_cases += 1
    for words, wt in ((128, 48), (8, 16)):
        def rows(m):
            return t(np.concatenate([_words(rng, (m, words)),
                                     _tails(rng, m, wt, wt)], axis=1))
        tabs = SimpleNamespace(src_rows=rows(3000), dst_rows=rows(900))
        arrays, spec = [], []
        pairs = [(a, b) for a in (0, 16, 64, 256) for b in (0, 16, 64, 256)]
        for i, (wa, wb) in enumerate(pairs):
            n = (1, 0)[i] if i < 2 else int(rng.integers(1, 20000))
            su = rng.integers(-2, 3002, size=n + 64).astype(np.int32)
            dv = np.sort(rng.integers(-2, 902, size=n + 64)).astype(np.int32)
            su[n:] = dv[n:] = SENTINEL
            arrays.append((t(su), t(dv)))
            spec.append((wa, wb, n + 64))
        plan = cuda_hubcore.plan_tail_count(tabs, arrays, spec, words)
        compare("hub_tail_count", cuda_hubcore.hub_tail_count_all(plan).sum(),
                cuda_hubcore.hub_tail_count_all_plain(plan).sum(),
                f"grouped random, words={words} wt={wt}, 16 groups")
        n_cases += 1
    return n_cases


def kernel_checks_random_slice2(rng, t):
    """D, E, m3, m3b and R on random inputs; returns the number of cases."""
    from graphminer_tpu_torch.ops import (cuda_check, cuda_hubcore,
                                          cuda_window, fetch)
    n_cases = 0
    # R: random words, the int32 product wraps in both versions
    x = t(_words(rng, (8, 128)))
    compare("times_two", cuda_check.times_two(x),
                    cuda_check.times_two_plain(x), "random [8, 128]")
    n_cases += 1
    # D: widths with 16-byte and 4-byte chunks, every pipeline depth,
    # indices partly outside the table
    for w in (8, 6, 32, 128, 256, 1024):
        tbl = t(rng.integers(-1000, 1000, size=(5000, w)).astype(np.int32))
        idx = t(rng.integers(-5, 5005, size=20000).astype(np.int32))
        want = fetch.fetch_rows_sum_plain(idx, tbl)
        for nb in fetch.N_BUF:
            compare("fetch_rows_sum",
                            fetch.fetch_rows_sum(idx, tbl, nb), want,
                            f"random w={w} n_buf={nb}")
            n_cases += 1
    # E: classes narrower and wider than the stored tail, popcount-only
    # groups, SENTINEL and out-of-range task ids
    for words, wt, wa, wb in ((128, 48, 64, 16), (128, 48, 16, 64),
                              (128, 48, 0, 0), (8, 8, 16, 64), (8, 0, 0, 0),
                              (32, 16, 16, 1024), (256, 24, 16, 16)):
        def rows(m):
            return np.concatenate([_words(rng, (m, words)),
                                   _tails(rng, m, wt, wt)], axis=1)
        ns, nd, n = 700, 300, 50000
        sr, dr = t(rows(ns)), t(rows(nd))
        su = rng.integers(-2, ns + 2, size=n).astype(np.int32)
        su[rng.random(n) < 0.05] = SENTINEL
        dv = np.sort(rng.integers(-2, nd + 2, size=n)).astype(np.int32)
        args, kw = (sr, dr, t(su), t(dv)), dict(words=words, wa=wa, wb=wb)
        compare("hub_tail_count", cuda_hubcore.hub_tail_count(*args, **kw),
                cuda_hubcore.hub_tail_count_plain(*args, **kw),
                f"random words={words} wt={wt} wa={wa} wb={wb}")
        n_cases += 1
    # m3 and m3b: narrow (W = 8) and wide windows, starts and local indices
    # partly out of range; chunk counts no multiple of the wave, cap no
    # multiple of a pass of task rows, W = 12
    for tk, cap, span, w, nd in ((4096, 512, 256, 8, 3000),
                                 (4096, 512, 256, 128, 3000),
                                 (65536, 8192, 1024, 128, 57344),
                                 (8192, 1024, 1024, 8, 5000),
                                 (4096, 512, 4096, 16, 5000),
                                 (300 * 520, 520, 300, 8, 1000),
                                 (5 * 77, 77, 10, 12, 40),
                                 (7 * 1000, 1000, 1000, 128, 1500),
                                 (133 * 64, 64, 512, 32, 600)):
        nck = tk // cap
        tbl, src = t(_words(rng, (nd, w))), t(_words(rng, (nck, cap, w)))
        st = t(rng.integers(-100, nd + 100, size=nck).astype(np.int32))
        li = t(np.sort(rng.integers(-3, span + 3, size=(nck, cap)), axis=1
                       ).astype(np.int32))
        want = cuda_window.window_count_plain(src, tbl, st, li, span=span)
        for name, r in WINDOW_ROWS.items():
            compare(name, cuda_window.window_count(
                src, tbl, st, li, span=span, rows_per_step=r), want,
                f"random T={tk} cap={cap} span={span} w={w}")
            n_cases += 1
    return n_cases


def kernel_checks_random_x_l(rng, t):
    """X and L on random inputs; returns the number of cases. X: plain mode
    on strided slices (ld > hw) at hw 1, 2, 16, 32 and 128 with n no
    multiple of 8 and padded n_out, and gathered mode at depth 0-4 (rows
    explicit and by task) with SENTINEL and out-of-range ids, both
    output layouts; L: nrow 3-8 with SENTINEL rows and ids outside the
    tables, and an empty task list, which must launch nothing."""
    from graphminer_tpu_torch.ops import cuda_cliquek, cuda_expand
    X, xp = cuda_expand.expand_bits, cuda_expand.expand_bits_plain
    n_cases = 0
    for hw, ld, n in ((1, 5, 1001), (2, 8, 4093), (16, 24, 30001),
                      (32, 128, 20005), (128, 136, 9999)):
        view = t(_words(rng, (n, ld)))[:, ld - hw:]
        n_out = -(-(n + 7) // 32) * 32
        for tr in (False, True):
            compare_rows("expand_bits", X(view, n_out=n_out, transpose=tr),
                         xp(view, n_out=n_out, transpose=tr),
                         f"random hw={hw} ld={ld} n={n} transpose={tr}")
            n_cases += 1
    hw, nb, nt, n = 16, 5000, 4096, 50000
    base, tab = t(_words(rng, (nb, 32)))[:, 16:], t(_words(rng, (nt, hw)))
    for depth in range(5):
        cols = rng.integers(-3, nt + 3, (n, depth)).astype(np.int32)
        cols[rng.random((n, depth)) < 0.05] = SENTINEL
        r = rng.integers(-3, nb + 3, n).astype(np.int32)
        r[rng.random(n) < 0.05] = SENTINEL
        for kw in (dict(r=t(r)), {}):
            for tr in (False, True):
                args = dict(tab=tab, cols=t(cols), n_out=50016, transpose=tr,
                            **kw)
                compare_rows("expand_bits", X(base, **args),
                             xp(base, **args),
                             f"random gathered depth={depth} "
                             f"{sorted(kw)} transpose={tr}")
                n_cases += 1
    v, c = 20000, 4096
    for words in (8, 128):
        bm = t(_words(rng, (v, words)))
        core = bm[v - c:]
        for nrow in range(3, 9):
            n = 100000 if words == 8 else 30000
            cols = np.concatenate([rng.integers(-1, v + 1, (n, 2)),
                                   rng.integers(-2, c + 2, (n, nrow - 2))],
                                  axis=1).astype(np.int32)
            cols[-4096:] = SENTINEL
            cols = t(cols)
            compare("lo_popcount",
                    cuda_cliquek.lo_popcount(bm, core, cols).sum(),
                    cuda_cliquek.lo_popcount_plain(bm, core, cols).sum(),
                    f"random words={words} nrow={nrow}")
            n_cases += 1
    before = cuda_cliquek.lo_popcount.launches
    got = cuda_cliquek.lo_popcount(bm, core, cols[:0])
    check(cuda_cliquek.lo_popcount.launches == before and int(got.sum()) == 0,
          "lo_popcount with no tasks launched or counted")
    return n_cases + 1


def kernel_checks_cliquek14():
    """X and L on the rmat14 CliqueKEngine inputs at k = 4 and 5: every
    slab X expands in a count and B_hh against the plain version, and L on
    the lo tasks; then the count against phase 9's generic goldens.
    Returns {k: lo tasks}, which phase 9's `clique k --fast` runs share."""
    from graphminer_tpu_torch.io.synth import rmat
    from graphminer_tpu_torch.ops import cuda_cliquek, cuda_expand
    from graphminer_tpu_torch.ops.cliquek import CliqueKEngine
    g = rmat(14, 16, seed=7)
    n_lo = {}
    for k, want in ((4, 36_628_817), (5, 387_027_732)):
        eng = CliqueKEngine(g, k, device="cuda")
        hd, hw = eng.hi_dim, eng.hi_words
        lo_cut = eng.words * 32 - hd
        view = eng.core[lo_cut:, eng.words - hw:]
        compare_rows("expand_bits", eng.bhh, cuda_expand.expand_bits_plain(
            view, n_out=hd), f"rmat14 k={k} B_hh")
        n_slabs = 0
        for base, kw in eng.slab_args():
            compare_rows("expand_bits", cuda_expand.expand_bits(base, **kw),
                         cuda_expand.expand_bits_plain(base, **kw),
                         f"rmat14 k={k} slab {n_slabs} ({sorted(kw)})")
            n_slabs += 1
        check(n_slabs == eng.n_slabs, f"rmat14 k={k}: {n_slabs} slabs != "
              f"{eng.n_slabs}")
        if eng.lo_cols is not None:
            compare("lo_popcount",
                    cuda_cliquek.lo_popcount(eng.bm, eng.core,
                                             eng.lo_cols).sum(),
                    cuda_cliquek.lo_popcount_plain(eng.bm, eng.core,
                                                   eng.lo_cols).sum(),
                    f"rmat14 k={k} lo tasks")
        got = eng.count()
        check(got == want, f"rmat14 CliqueKEngine k={k}: {got} != {want}")
        say(f"rmat14 CliqueKEngine k={k}: X == plain on B_hh and {n_slabs} "
            f"slabs, L == plain on {eng.n_lo} lo tasks; count {got} "
            f"(n_core_edges {eng.n_core_edges}, n_tri {eng.n_tri})")
        n_lo[k] = eng.n_lo
        del eng
    torch.cuda.empty_cache()
    return n_lo


def bucket_calls(stream_eng, ring_eng):
    """{kernel name: (wrapper, plain version, [(args, kwargs) per bucket])}
    over the two engines' layouts, as their counts call them."""
    from graphminer_tpu_torch.ops import cuda_ring, cuda_stream
    lay = ring_eng.layout
    return {
        "stream_bucket_count": (
            cuda_stream.stream_bucket_count,
            cuda_stream.stream_bucket_count_plain,
            [((b.dst_rows, b.src_rows), dict(ws=b.ws, wtv=b.wtv))
             for b in stream_eng.stream.buckets]),
        "ring_phase_c": (
            cuda_ring.ring_phase_c, cuda_ring.ring_phase_c_plain,
            [((lay.core_bm, b.src_bm, b.dst_loc), {}) for b in lay.cbuckets]
            + [((lay.bm_table, b.src_bm, b.dst_loc), {})
               for b in lay.bbuckets]),
        "ring_tail_pairs": (
            cuda_ring.ring_tail_pairs, cuda_ring.ring_tail_pairs_plain,
            [((lay.tail_tables[b.ta], lay.tail_tables[b.tv], b.src_slot,
               b.dst_slot), {}) for b in lay.tbuckets]),
    }


def kernel_checks_rmat14():
    from graphminer_tpu_torch.io.synth import rmat
    from graphminer_tpu_torch.ops.cuda_hubcore import (hub_tail_count,
                                                       hub_tail_count_plain)
    from graphminer_tpu_torch.ops.ring import RingEngine
    from graphminer_tpu_torch.ops.stream import StreamEngine
    g = rmat(14, 16, seed=7)
    se, re_ = StreamEngine(g, device="cuda"), RingEngine(g, device="cuda")
    sizes = {}
    for name, (kern, plain, calls) in bucket_calls(se, re_).items():
        for args, kw in calls:
            compare(name, kern(*args, **kw), plain(*args, **kw),
                    f"rmat14 bucket {[tuple(a.shape) for a in args]}")
        sizes[name] = len(calls)
    from graphminer_tpu_torch.ops.hubcore import TriangleEngine
    he = TriangleEngine(g, device="cuda")
    for args, kw in tail_calls(he):
        compare("hub_tail_count", hub_tail_count(*args, **kw),
                hub_tail_count_plain(*args, **kw),
                f"rmat14 tail group {kw}")
    sizes["hub_tail_count"] = len(he.spec)
    from graphminer_tpu_torch.ops import cuda_ring, cuda_stream
    compare("stream_bucket_count",
            cuda_stream.stream_count_all(se.plan).sum(),
            cuda_stream.stream_count_all_plain(se.plan).sum(),
            "rmat14 grouped launch")
    compare("ring_tail_pairs",
            cuda_ring.ring_tail_pairs_all(re_.tail_plan).sum(),
            cuda_ring.ring_tail_pairs_all_plain(re_.tail_plan).sum(),
            "rmat14 grouped launch")
    compare("ring_phase_c",
            cuda_ring.ring_phase_c_all(re_.phase_c_plan).sum(),
            cuda_ring.ring_phase_c_all_plain(re_.phase_c_plan).sum(),
            "rmat14 grouped launch")
    from graphminer_tpu_torch.ops import cuda_hubcore
    compare("hub_tail_count",
            cuda_hubcore.hub_tail_count_all(he.tail_plan).sum(),
            cuda_hubcore.hub_tail_count_all_plain(he.tail_plan).sum(),
            "rmat14 grouped launch")
    torch.cuda.synchronize()
    s, r, h = se.count(), re_.count(), he.count()
    check(s == GOLDEN[14] and r == GOLDEN[14] and h == GOLDEN[14],
          f"rmat14 counts stream {s} ring {r} hub-core {h} != {GOLDEN[14]}")
    ht, hc = he.count_tail(), he.count_core()
    check(ht + hc == h, f"rmat14 hub-core tail {ht} + core {hc} != {h}")
    say(f"rmat14: kernel == plain on every bucket and tail group {sizes} "
        f"and as grouped launches of A, B, C and E; "
        f"stream = ring = hub-core = {s} (tail {ht} + core {hc})")


def tail_calls(eng):
    """[(args, kwargs)] of TriangleEngine's kernel-E calls, one per group."""
    tab, lay = eng.tables, eng.layout
    return [((tab.src_rows, tab.dst_rows, s.reshape(-1), d.reshape(-1)),
             dict(words=lay.words, wa=wa, wb=wb))
            for (s, d), (wa, wb, _ck) in zip(eng.group_arrays, eng.spec)]


# --------------------------------------------------------------------------
# phases 4, 5 and 7: main path, ring engine, timing
# --------------------------------------------------------------------------

def write_rmat18():
    from graphminer_tpu_torch.io.loader import save_graph
    from graphminer_tpu_torch.io.synth import rmat
    t0 = time.perf_counter()
    g = rmat(18, 16, seed=7)
    save_graph(g, PREFIX)
    say(f"rmat18: V={g.n_vertices} E={g.n_edges} written to {PREFIX} "
        f"in {time.perf_counter() - t0:.1f} s")
    return g


def run_cli():
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "graphminer_tpu_torch", "tc",
                        PREFIX, "--fast", "--json", "--profile"], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    sys.stderr.write(r.stderr)
    check(r.returncode == 0, f"CLI exited {r.returncode}")
    out = json.loads(r.stdout.strip().splitlines()[-1])
    launches = out["profile"]["kernel_launches"]["stream_bucket_count"]
    say(f"CLI tc --fast: total={out['total']} run_s={out['run_s']} "
        f"device_count_s={out['profile']['phases_s'].get('device_count')} "
        f"stream_bucket_count launches={launches} "
        f"(wall {time.perf_counter() - t0:.1f} s)")
    check(out["total"] == GOLDEN[18],
          f"CLI total {out['total']} != {GOLDEN[18]}")
    check(launches == 1, f"kernel A launched {launches} times by the CLI's "
          "count, not once")
    return launches


def run_ring(g):
    from graphminer_tpu_torch.ops.ring import RingEngine
    t0 = time.perf_counter()
    eng = RingEngine(g, device="cuda")
    t_build = time.perf_counter() - t0
    total, launches = run_path("RingEngine rmat18 count", eng.count,
                               ["ring_phase_c", "ring_tail_pairs"])
    say(f"RingEngine rmat18: count={total} build_s={t_build:.1f}")
    for k, letter in (("ring_phase_c", "B"), ("ring_tail_pairs", "C")):
        check(launches[k] == 1, f"kernel {letter} launched {launches[k]} "
              "times by the ring count, not once")
    check(total == GOLDEN[18], f"ring count {total} != {GOLDEN[18]}")
    return eng, launches


def time_ms(fn):
    """Median device time of fn() in ms over REPS runs after warm-up, and
    the value it returned."""
    from graphminer_tpu_torch.utils.profiling import time_ms as timed
    return timed(fn, "cuda", REPS)


def in_turns(run_k, run_p):
    """(kernel ms, plain ms, kernel value, plain value) timed in turns:
    plain, kernel, kernel, plain; each ms the median of the two medians."""
    p1, pv = time_ms(run_p)
    k1, kv = time_ms(run_k)
    k2, _ = time_ms(run_k)
    p2, _ = time_ms(run_p)
    return statistics.median([k1, k2]), statistics.median([p1, p2]), kv, pv


def gathered_bytes(pairs):
    """Bytes of the table rows that index tensors name, each distinct row of
    a table counted once: pairs = [(table [n, w], ids)], ids outside
    [0, n) name nothing."""
    by_table = {}
    for table, ids in pairs:
        by_table.setdefault(table.data_ptr(), (table, []))[1].append(
            ids.reshape(-1))
    total = 0
    for table, ids in by_table.values():
        ids = torch.cat(ids)
        ids = ids[(ids >= 0) & (ids < table.shape[0])]
        total += int(torch.unique(ids).numel()) * table.shape[1] * 4
    return total


def kernel_bytes(name, calls, n_partials=None):
    """The bytes a kernel's calls must move: every streamed input and every
    gathered table row read once, one int64 partial written per call (or
    n_partials of them, for one grouped launch)."""
    nb = lambda t: t.numel() * t.element_size()
    out = 8 * (len(calls) if n_partials is None else n_partials)
    if name == "stream_bucket_count":
        return out + sum(nb(a[0]) + nb(a[1]) for a, _ in calls)
    if name == "ring_phase_c":                 # table, src_bm, dst_loc
        return out + sum(nb(a[1]) + nb(a[2]) for a, _ in calls) + \
            gathered_bytes([(a[0], a[2]) for a, _ in calls])
    if name == "ring_tail_pairs":                      # ta, tb, sa, sb
        return out + sum(nb(a[2]) + nb(a[3]) for a, _ in calls) + \
            gathered_bytes([(a[0], a[2]) for a, _ in calls]
                           + [(a[1], a[3]) for a, _ in calls])
    raise KeyError(name)


def timing(stream_eng, ring_eng):
    """Per-kernel and per-engine device time, kernel vs plain, in turns: A,
    B and C as the engines' one grouped launch."""
    from graphminer_tpu_torch.ops import cuda_ring, cuda_stream
    from graphminer_tpu_torch.utils.profiling import bound_ms
    res = {}
    splan, pplan, tplan = (stream_eng.plan, ring_eng.phase_c_plan,
                           ring_eng.tail_plan)
    grouped = {
        "stream_bucket_count": (
            lambda: cuda_stream.stream_count_all(splan),
            lambda: cuda_stream.stream_count_all_plain(splan)),
        "ring_phase_c": (
            lambda: cuda_ring.ring_phase_c_all(pplan),
            lambda: cuda_ring.ring_phase_c_all_plain(pplan)),
        "ring_tail_pairs": (
            lambda: cuda_ring.ring_tail_pairs_all(tplan),
            lambda: cuda_ring.ring_tail_pairs_all_plain(tplan))}
    for name, (_, _, calls) in bucket_calls(stream_eng, ring_eng).items():
        k, p, kv, pv = in_turns(*grouped[name])
        compare(name, kv.sum(), pv.sum(), "rmat18 engine share")
        nbytes = kernel_bytes(name, calls, kv.numel())
        b_ms, b_by = bound_ms(nbytes)
        res[name] = dict(ms=k, plain_ms=p, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None)
        say(f"[{CARD}] {name} at rmat18 ({len(calls)} buckets, 1 launch): "
            f"kernel {k:.4f} ms, plain {p:.3f} ms, bound {b_ms:.4f} ms "
            f"({b_by}, {nbytes} B)")
    # B's bytes past L1 per count in the kernel's own terms, beside the
    # first design's (one whole table row a valid task, its src row and
    # slots) and the bound's
    first = sum(int(((d >= 0) & (d < t.shape[0])).sum()) * t.shape[1] * 4
                + (s.numel() + d.numel()) * 4 for t, s, d in pplan.groups)
    bound = kernel_bytes("ring_phase_c", [(g, {}) for g in pplan.groups],
                         pplan.n_blocks)
    say(f"ring_phase_c rmat18 bytes past L1 a count: {pplan.l2_bytes} "
        f"(first design {first}; bound {bound}); "
        f"{pplan.items.shape[0]} items in {pplan.n_tiles} tiles over "
        f"{pplan.n_blocks} blocks, {pplan.stage_rows} rows staged a slice")
    stream_groups(stream_eng)
    phase_c_groups(ring_eng)
    engines = (
        ("stream", stream_eng, stream_eng.stream.nbytes(),
         [res["stream_bucket_count"]]),
        ("ring", ring_eng, ring_eng.layout.nbytes(),
         [res["ring_phase_c"], res["ring_tail_pairs"]]))
    for label, eng, nbytes, parts in engines:
        k_ms = sum(r["ms"] for r in parts)
        p_ms = sum(r["plain_ms"] for r in parts)
        e_ms, total = time_ms(lambda: eng.partials().sum())
        check(int(total) == GOLDEN[18], f"{label} total {int(total)}")
        say(f"[{CARD}] {label} engine rmat18 device count: {e_ms:.3f} ms "
            f"(kernel parts {k_ms:.3f} ms, plain {p_ms:.3f} ms); "
            f"edge tasks/s {eng.n_edges / (e_ms / 1e3):.4e} kernel, "
            f"{eng.n_edges / (p_ms / 1e3):.4e} plain; "
            f"{eng.n_edges} edge tasks; layout {nbytes} bytes")
    busy_share("stream", stream_eng, {"A": "stream_count_kernel"})
    busy_share("ring", ring_eng, {"B": "ring_phase_c_kernel",
                                  "C": "ring_tail_pairs_kernel"})
    return res


#: groups of the rmat18 stream buckets that stream_groups times
STREAM_GROUPS = (("no dst tail", lambda b: b.wtv == 0),
                 ("dst tail", lambda b: b.wtv > 0),
                 ("width >= 32", lambda b: b.width >= 32),
                 ("width < 32", lambda b: b.width < 32))


def stream_groups(stream_eng, top=4):
    """Kernel A, one launch each, over groups of the stream buckets (with
    and without a dst tail; of width >= 32, whose tiles' dst rows fit the
    kernel's shared-memory staging buffer, and narrower) and over the `top`
    largest buckets alone, each held against the plain version and printed
    beside its bytes and bound; then the share of 16-byte src tail chunks
    that hold SENTINEL padding alone (they cost the kernel no search)."""
    from graphminer_tpu_torch.ops import cuda_stream
    from graphminer_tpu_torch.utils.profiling import bound_ms
    bk = stream_eng.stream.buckets
    largest = sorted(bk, key=lambda b: -b.src_rows.numel())[:top]
    for label, sel in STREAM_GROUPS + tuple(
            (f"bucket {b.spec}", lambda x, b=b: x is b) for b in largest):
        bs = [b for b in bk if sel(b)]
        plan = cuda_stream.plan_stream(
            [(b.dst_rows, b.src_rows, b.ws, b.wtv) for b in bs])
        ms, kv = time_ms(lambda: cuda_stream.stream_count_all(plan))
        compare("stream_bucket_count", kv.sum(),
                cuda_stream.stream_count_all_plain(plan).sum(),
                f"rmat18 group {label}")
        nbytes = sum((b.dst_rows.numel() + b.src_rows.numel()) * 4
                     for b in bs)
        say(f"[{CARD}] stream_count rmat18 {label}: {len(bs)} buckets, "
            f"{nbytes} B, {ms:.4f} ms, {nbytes / ms / 1e9:.3f} TB/s, bound "
            f"{bound_ms(nbytes)[0]:.4f} ms")
    n = pad = 0
    for b in bk:
        if b.wtv and b.wta:
            c = b.src_rows[:, :, b.ws:].reshape(-1, 4)
            n += c.shape[0]
            pad += int((c == SENTINEL).all(dim=1).sum())
    say(f"stream rmat18 src tail chunks: {n}, SENTINEL padding alone: "
        f"{pad / max(n, 1):.4f}")


def phase_c_groups(ring_eng):
    """Kernel B, one launch each, over the ring layout's phase-C buckets
    alone (core table staged) and its bitmap-pass buckets alone (bm_table
    read in place), each held against the plain version and printed with
    its slots (task-sector pairs) and time a slot: the planner weighs a
    slot of an unstaged table by their ratio (cuda_ring.DIRECT_COST)."""
    from graphminer_tpu_torch.ops import cuda_ring
    lay = ring_eng.layout
    per = {}
    for label, table, bks in (("phase C", lay.core_bm, lay.cbuckets),
                              ("bitmap pass", lay.bm_table, lay.bbuckets)):
        plan = cuda_ring.plan_phase_c(
            [(table, b.src_bm, b.dst_loc) for b in bks])
        ms, kv = time_ms(lambda: cuda_ring.ring_phase_c_all(plan))
        compare("ring_phase_c", kv.sum(),
                cuda_ring.ring_phase_c_all_plain(plan).sum(),
                f"rmat18 {label}")
        slots = int((plan.items[:, 1] & ((1 << cuda_ring.LEN_BITS) - 1))
                    .sum())
        per[label] = ms / slots
        say(f"[{CARD}] ring_phase_c rmat18 {label}: {len(bks)} buckets, "
            f"{plan.items.shape[0]} items, {slots} slots, {ms:.4f} ms, "
            f"{ms / slots * 1e9:.3f} ps a slot")
    say(f"ring_phase_c rmat18 time a slot, bitmap pass / phase C: "
        f"{per['bitmap pass'] / per['phase C']:.3f} (planner: "
        f"{cuda_ring.DIRECT_COST})")


def busy_share(label, eng, kernels, counts=5):
    """The device-busy share of `counts` engine counts: the device time of
    the kernels and copies torch.profiler records, over the window that two
    CUDA events around the counts measure; and the device time of each of
    `kernels` ({letter: name of its __global__ function}) per count."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    eng.count()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        a.record()
        for _ in range(counts):
            eng.count()
        b.record()
        b.synchronize()
    window_us = a.elapsed_time(b) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        say(f"[{CARD}] {label} count device-busy share: not measured "
            "(torch.profiler recorded no device event)")
        return
    busy_us = sum(e.time_range.elapsed_us() for e in dev)
    per = {k: sum(e.time_range.elapsed_us() for e in dev if fn in e.name)
           / counts for k, fn in kernels.items()}
    say(f"[{CARD}] {label} count device-busy share over {counts} counts: "
        f"{busy_us / window_us:.4f} (device events {busy_us:.1f} us in a "
        f"{window_us:.1f} us window, {len(dev)} events); device us per "
        f"count: " + ", ".join(f"{k} {v:.1f}" for k, v in per.items()))


#: readings device_ms takes of a kernel whose profiler events fall short
DEVICE_READS = 3


def device_ms(fn, kernel=None, calls=200):
    """The device time of one fn() call in ms (torch.profiler over `calls`
    calls after warm-up). With `kernel` (the name of a __global__ function),
    fails unless that kernel is the one device op the calls run, besides a
    memset a call at most, and it ran at most once a call; and unless the
    wrappers' launch counts rose by exactly one for each fn() call, so a
    call that launched nothing fails. The profiler can miss events at the
    edge of its window: a reading with fewer than 0.9 kernel events a call
    is taken again, DEVICE_READS readings in all."""
    from graphminer_tpu_torch.utils.profiling import device_ms as alone
    if kernel is None:
        return alone(fn, calls)[0]
    n_calls = [0]

    def counted():
        n_calls[0] += 1
        fn()

    for _ in range(DEVICE_READS):
        before = sum(read_counts().values())
        n_calls[0] = 0
        ms, ops = alone(counted, calls)
        launched = sum(read_counts().values()) - before
        check(launched == n_calls[0],
              f"{kernel}: {launched} launches counted over {n_calls[0]} "
              "calls")
        kernels = {k: v for k, v in ops.items() if "emset" not in k}
        memsets = sum(v for k, v in ops.items() if "emset" in k)
        rate = next(iter(kernels.values()), 0.0)
        check(len(kernels) == 1 and kernel in next(iter(kernels))
              and rate <= 1.0 and memsets <= 1.0,
              f"a call of {kernel} ran other device work: {ops}")
        if rate >= 0.9:
            return ms
        say(f"torch.profiler recorded {rate} {kernel} events a call "
            "(fewer than 0.9) while the wrapper counted one launch a call:"
            " reading again")
    check(False, f"torch.profiler recorded {rate} {kernel} events a call "
          f"in each of {DEVICE_READS} readings")


def r_host_split(calls=10_000):
    """Kernel R's host time a call in us (host clock over `calls` calls,
    synchronized at the end), torch.mul's beside it, and the parts of the
    wrapper's path, each timed alone."""
    from graphminer_tpu_torch.ops import _build, _tensors, cuda_check
    x = torch.ones((8, 128), dtype=torch.int32, device="cuda")
    out, dev = torch.empty_like(x), x.device
    n, nb = x.numel(), _tensors.n_blocks(x.numel())
    fn, st = _build.entry("gm_times_two"), _build.stream(dev)
    parts = {
        "times_two(x)": lambda: cuda_check.times_two(x),
        "torch.mul(x, 2)": lambda: torch.mul(x, 2),
        "on_cuda": lambda: _tensors.on_cuda("times_two", x),
        "torch.empty_like": lambda: torch.empty_like(x),
        "n_blocks": lambda: _tensors.n_blocks(n),
        "kernels()": _build.kernels,
        "entry() lookup": lambda: _build.entry("gm_times_two"),
        "stream() raw handle": lambda: _build.stream(dev),
        "ctypes call with its launch": lambda: fn(
            x.data_ptr(), out.data_ptr(), n, nb, st),
    }
    res = {}
    for name, f in parts.items():
        for _ in range(100):
            f()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            f()
        torch.cuda.synchronize()
        res[name] = (time.perf_counter() - t0) / calls * 1e6
    say(f"[{CARD}] times_two host us a call ({calls} calls): " + "; ".join(
        f"{k} {v:.3f}" for k, v in res.items()))
    return res


# --------------------------------------------------------------------------
# phase 6: the hub-core engine and the probe scripts
# --------------------------------------------------------------------------

def run_triangle_engine(g):
    from graphminer_tpu_torch.ops.hubcore import TriangleEngine
    t0 = time.perf_counter()
    eng = TriangleEngine(g, device="cuda")
    t_build = time.perf_counter() - t0
    total, launches = run_path("TriangleEngine rmat18 count", eng.count,
                               ["hub_tail_count", "expand_bits"])
    launches.pop("expand_bits")         # X's launches are phase 13's
    check(launches["hub_tail_count"] == 1,
          f"kernel E launched {launches['hub_tail_count']} times by the "
          "hub-core count, not once")
    tail, core = eng.count_tail(), eng.count_core()
    say(f"TriangleEngine rmat18: count={total} (tail {tail} + core {core}) "
        f"build_s={t_build:.1f} groups={eng.spec} "
        f"tail_tasks={eng.n_tail_tasks} spoke_rows={eng.spoke.shape[0]}")
    check(total == GOLDEN[18], f"hub-core count {total} != {GOLDEN[18]}")
    check(tail + core == total, f"tail {tail} + core {core} != {total}")
    return eng, launches


def run_prof_breakdown():
    from graphminer_tpu_torch.scripts import prof_breakdown
    out, launches = run_path("prof_breakdown rmat18",
                             lambda: prof_breakdown.main([]),
                             ["hub_tail_count", "fetch_rows_sum"])
    total = out["tail"]["count"] + out["spoke"]["count"]
    check(total == GOLDEN[18], f"prof_breakdown tail + spoke {total}")
    check(len(out["fetch"]) == 8, f"prof_breakdown ran {len(out['fetch'])} "
          "of 8 fetch shapes")
    return out, launches


def run_prof_window():
    from graphminer_tpu_torch.scripts import prof_window
    out, launches = run_path("prof_window defaults",
                             lambda: prof_window.main([]),
                             list(WINDOW_ROWS))
    totals = {k: out[k]["total"] for k in ("m1", "m2", "m3", "m3b")}
    check(len(set(totals.values())) == 1, f"prof_window totals {totals}")
    return out, launches


def int_mm_rules():
    """torch._int_mm on the card: exact in each row/column-major layout of
    its operands, and refusing m <= 16 and k or n not a multiple of 8."""
    g = torch.Generator(device="cuda")
    g.manual_seed(3)
    xt = torch.randint(0, 2, (4096, 512), generator=g, device="cuda",
                       dtype=torch.int8)
    ref = (xt.float() @ xt.t().float()).to(torch.int32)
    col = xt.t().contiguous().t()                   # the same, column-major
    for lay, (a, b) in {"A row, B col": (xt, xt.t()),
                        "A row, B row": (xt, xt.t().contiguous()),
                        "A col, B row": (col, xt.t().contiguous()),
                        "A col, B col": (col, xt.t())}.items():
        check(torch.equal(torch._int_mm(a, b), ref),
              f"torch._int_mm inexact with {lay}")
    refused = []
    for (m, k), (k2, n) in (((16, 32), (32, 32)), ((17, 12), (12, 32)),
                            ((32, 32), (32, 12))):
        a = torch.ones((m, k), dtype=torch.int8, device="cuda")
        b = torch.ones((n, k2), dtype=torch.int8, device="cuda").t()
        try:
            torch._int_mm(a, b)
        except RuntimeError:
            refused.append((m, k, n))
    check(len(refused) == 3, f"torch._int_mm refused only {refused}")
    say(f"torch._int_mm: exact in all four operand layouts at [4096, 512] x "
        f"[512, 4096]; refuses (m, k, n) = {refused}")


def timing_slice(hub_eng, pb, pw):
    """Kernels E, D, m3, m3b and R and the spoke product at the shapes of
    their paths, kernel vs plain, each with its bound (E's and m3's as
    prof_breakdown's and prof_window's results `pb` and `pw` gave them)."""
    from graphminer_tpu_torch.ops import (cuda_check, cuda_expand,
                                          cuda_hubcore, cuda_window, fetch,
                                          hubcore)
    from graphminer_tpu_torch.scripts import prof_breakdown, prof_window
    from graphminer_tpu_torch.utils.profiling import bound_ms
    dev = torch.device("cuda")
    res = {}

    # E: the rmat18 tail groups, one launch
    plan = hub_eng.tail_plan
    k, p, kv, pv = in_turns(
        lambda: cuda_hubcore.hub_tail_count_all(plan),
        lambda: cuda_hubcore.hub_tail_count_all_plain(plan))
    compare("hub_tail_count", kv.sum(), pv.sum(), "rmat18 tail groups")
    b_ms, b_by = pb["tail"]["bound"]
    res["hub_tail_count"] = dict(ms=k, plain_ms=p, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=None)
    say(f"[{CARD}] hub_tail_count at rmat18 ({len(plan.groups)} groups, "
        f"{hub_eng.n_tail_tasks} tasks, {plan.n_tiles} tiles, 1 launch): "
        f"kernel {k:.4f} ms, plain {p:.3f} ms, bound {b_ms:.4f} ms ({b_by}, "
        f"{pb['tail']['bytes']} bytes)")

    # the spoke product: torch._int_mm (a library call, no kernel of ours);
    # first the layout and shape rules that hubcore relies on, then its
    # product against the f32 one on the first slab
    int_mm_rules()
    lay = hub_eng.layout
    cpad = lay.words * 32
    torch.backends.cuda.matmul.allow_tf32 = False
    first = hub_eng.spoke[:hubcore.MAX_SLAB]
    xt = hubcore._expand_bits(first, cpad, transpose=True)
    compare_rows("expand_bits", xt, cuda_expand.expand_bits_plain(
        first, transpose=True), f"rmat18 spoke slab 1 [{cpad}, "
        f"{first.shape[0]}] (transposed)")
    exact = torch.equal(torch._int_mm(xt, xt.t()),
                        (xt.float() @ xt.t().float()).to(torch.int32))
    check(exact, "torch._int_mm Gram != the f32 Gram on the first slab")
    del xt
    core_rows = lay.table[lay.table.shape[0] - lay.core_size:, :lay.words]
    compare_rows("expand_bits", hubcore._expand_bits(core_rows, cpad),
                 cuda_expand.expand_bits_plain(core_rows),
                 f"rmat18 spoke core mask [{lay.core_size}, {cpad}] "
                 f"(row-major, rows of the {lay.table.shape[1]}-word table "
                 "in place)")
    s_ms, spoke = time_ms(lambda: hub_eng.core_partials().sum())
    ops = 2 * cpad * cpad * hub_eng.spoke.shape[0]
    sb_ms, sb_by = bound_ms(hub_eng.spoke.numel() * 4, ops)
    res["spoke"] = dict(ms=s_ms, bound_ms=sb_ms, bound_by=sb_by, ops=ops)
    say(f"[{CARD}] spoke product (X + torch._int_mm, "
        f"{hub_eng.spoke.shape[0]} rows, Gram == f32 Gram on slab 1): "
        f"{s_ms:.3f} ms (with the torch expansion before kernel X: "
        f"25.668 ms on an H100 80GB HBM3, 700 W), bound "
        f"{sb_ms:.4f} ms ({sb_by}, {ops:.4e} int8 ops); count {int(spoke)}")
    e_ms, total = time_ms(lambda: hub_eng.tail_partials().sum()
                          + hub_eng.core_partials().sum())
    check(int(total) == GOLDEN[18], f"hub-core total {int(total)}")
    say(f"[{CARD}] hub-core engine rmat18 device count: {e_ms:.3f} ms "
        f"(tail {k:.4f} ms + spoke {s_ms:.3f} ms)")
    busy_share("hub-core", hub_eng, {"E": "hub_tail_count_kernel"})

    # D: prof_breakdown's eight shapes; the library yardstick is one
    # embedding_bag over the whole index list (exact in float64 below 2^53)
    tot = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, library_ms=0.0,
               device_ms=0.0)
    for w in prof_breakdown.FETCH_WIDTHS:
        for n in prof_breakdown.FETCH_COUNTS:
            idx, tbl = prof_breakdown.fetch_inputs(w, n, 0, dev)
            t64 = tbl.double()
            call = lambda: fetch.fetch_rows_sum(idx, tbl, prof_breakdown.N_BUF)
            k, p, kv, pv = in_turns(
                call, lambda: fetch.fetch_rows_sum_plain(idx, tbl))
            compare("fetch_rows_sum", kv, pv, f"w={w} n={n}")
            d_ms = device_ms(call, "fetch_rows_sum_kernel")
            lib_ms, lv = time_ms(
                lambda: F.embedding_bag(idx[None], t64, mode="sum"))
            check(torch.equal(lv.to(torch.int64), kv.to(torch.int64)),
                  f"embedding_bag != fetch_rows_sum at w={w} n={n}")
            b_ms, _ = prof_breakdown.fetch_bound(idx, w)
            for key, v in (("ms", k), ("plain_ms", p), ("bound_ms", b_ms),
                           ("library_ms", lib_ms), ("device_ms", d_ms)):
                tot[key] += v
            say(f"[{CARD}] fetch_rows_sum w={w} n={n}: kernel {k:.4f} ms "
                f"(device alone {d_ms:.4f} ms, {n * w * 4 / d_ms / 1e6:.1f} "
                f"GB/s on {n * w * 4} gathered bytes), plain {p:.4f} ms, "
                f"embedding_bag {lib_ms:.4f} ms, bound {b_ms:.4f} ms (bytes)")
            del t64
    res["fetch_rows_sum"] = dict(tot, bound_by="bytes")
    say(f"[{CARD}] fetch_rows_sum, 8 shapes: kernel {tot['ms']:.4f} ms, "
        f"device alone {tot['device_ms']:.4f} ms, bound "
        f"{tot['bound_ms']:.4f} ms; one kernel and no other device op a "
        f"call")

    # m3, m3b: prof_window's defaults
    span = prof_window.SPAN
    table, starts, lidx, srcs = (
        torch.from_numpy(a).to(dev) for a in prof_window.make_inputs(
            prof_window.T, prof_window.CAP, span, prof_window.W))
    b_ms, b_by = pw["bound_ms"], pw["bound_by"]
    for name, r in WINDOW_ROWS.items():
        kern = lambda: cuda_window.window_count(
            srcs, table, starts, lidx, span=span, rows_per_step=r)
        k, p, kv, pv = in_turns(
            kern, lambda: cuda_window.window_count_plain(
                srcs, table, starts, lidx, span=span))
        compare(name, kv, pv, "prof_window defaults")
        d_ms = device_ms(kern, "window_count_kernel")
        res[name] = dict(ms=k, plain_ms=p, bound_ms=b_ms, bound_by=b_by,
                         library_ms=None, device_ms=d_ms)
        say(f"[{CARD}] {name} at prof_window defaults: kernel {k:.4f} ms "
            f"(device alone {d_ms:.4f} ms), plain {p:.3f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}, {pw['bytes']} bytes)")
    del srcs

    # R: [8, 128]; torch's own x * 2 is both the plain version and the
    # library call
    x = torch.ones((8, 128), dtype=torch.int32, device=dev)
    k, p, kv, pv = in_turns(lambda: cuda_check.times_two(x),
                            lambda: cuda_check.times_two_plain(x))
    compare("times_two", kv, pv, "[8, 128]")
    lib_ms, _ = time_ms(lambda: torch.mul(x, 2))
    b_ms, b_by = bound_ms(2 * x.numel() * 4)
    # the device time alone, without the wrapper's dispatch
    dev_ms = device_ms(lambda: cuda_check.times_two(x), "times_two")
    lib_dev_ms = device_ms(lambda: torch.mul(x, 2))
    split = r_host_split()
    res["times_two"] = dict(ms=k, plain_ms=p, bound_ms=b_ms, bound_by=b_by,
                            library_ms=lib_ms, device_ms=dev_ms,
                            library_device_ms=lib_dev_ms,
                            host_us=split["times_two(x)"],
                            library_host_us=split["torch.mul(x, 2)"])
    say(f"[{CARD}] times_two [8, 128]: kernel {k:.4f} ms, plain {p:.4f} "
        f"ms, torch.mul {lib_ms:.4f} ms ({k / lib_ms:.3f}x), bound "
        f"{b_ms:.6f} ms ({b_by}); on the device alone (torch.profiler): "
        f"kernel {dev_ms:.5f} ms, torch.mul {lib_dev_ms:.5f} ms")
    return res


# --------------------------------------------------------------------------
# phases 8-12: the hybrid tier and the generic set-operation path
# --------------------------------------------------------------------------

def graph_prefix(scale):
    return os.path.join(REPO, "graph_cache", f"rmat{scale}_ef16_seed7",
                        "graph")


def write_rmat(scale):
    """rmat(scale, 16, seed=7), written under graph_cache/ as write_rmat18
    writes rmat18."""
    from graphminer_tpu_torch.io.loader import save_graph
    from graphminer_tpu_torch.io.synth import rmat
    t0 = time.perf_counter()
    g = rmat(scale, 16, seed=7)
    save_graph(g, graph_prefix(scale))
    say(f"rmat{scale}: V={g.n_vertices} E={g.n_edges} written in "
        f"{time.perf_counter() - t0:.1f} s")
    return g


def hybrid_launch_check(label, eng):
    """One count of a HybridEngine with every count at 0 before it: it must
    launch B and A once each and C and E never. Returns the count."""
    total, launches = run_path(label, eng.count,
                               ["ring_phase_c", "stream_bucket_count"])
    counts = read_counts()
    want = {"ring_phase_c": 1, "stream_bucket_count": 1,
            "ring_tail_pairs": 0, "hub_tail_count": 0}
    got = {k: counts[k] for k in want}
    check(got == want, f"{label}: launches {got}, want {want}")
    check(eng.ring.n_core_tasks + eng.stream.n_tasks == eng.n_edges,
          f"{label}: core {eng.ring.n_core_tasks} + sub-core "
          f"{eng.stream.n_tasks} != {eng.n_edges} tasks")
    # each kernel against its plain version on this path's own plans, after
    # the counts were read (these launches are not the path's)
    from graphminer_tpu_torch.ops import cuda_ring, cuda_stream
    compare("ring_phase_c",
            cuda_ring.ring_phase_c_all(eng.phase_c_plan).sum(),
            cuda_ring.ring_phase_c_all_plain(eng.phase_c_plan).sum(),
            f"{label}, {len(eng.ring.cbuckets)} phase-C buckets")
    compare("stream_bucket_count",
            cuda_stream.stream_count_all(eng.stream_plan).sum(),
            cuda_stream.stream_count_all_plain(eng.stream_plan).sum(),
            f"{label}, {len(eng.stream.buckets)} sub-core buckets")
    say(f"{label}: B and A == plain on the hybrid's plans "
        f"({len(eng.ring.cbuckets)} B buckets, {len(eng.stream.buckets)} A "
        f"buckets)")
    return total, launches


def run_hybrid18(g):
    """Phase 8: the hybrid tier at rmat18 — count, launches, coverage,
    layout bytes, device count time, busy share."""
    from graphminer_tpu_torch.ops.hybrid import HybridEngine
    t0 = time.perf_counter()
    eng = HybridEngine(g, device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t0
    total, launches = hybrid_launch_check("HybridEngine rmat18 count", eng)
    check(total == GOLDEN[18], f"hybrid count {total} != {GOLDEN[18]}")
    e_ms, tot = time_ms(lambda: eng.partials().sum())
    check(int(tot) == GOLDEN[18], f"hybrid partials {int(tot)}")
    say(f"[{CARD}] HybridEngine rmat18: count={total} build_s={t_build:.2f}"
        f" layout {eng.nbytes()} B (ring {eng.ring.nbytes()} + sub-core "
        f"stream {eng.stream.nbytes()}); {len(eng.ring.cbuckets)} B buckets "
        f"({eng.ring.n_core_tasks} core tasks), {len(eng.stream.buckets)} A "
        f"buckets ({eng.stream.n_tasks} sub-core tasks); device count "
        f"{e_ms:.4f} ms (median of {REPS}), "
        f"{eng.n_edges / (e_ms / 1e3):.4e} edge tasks/s; phase "
        f"{time.perf_counter() - t0:.1f} s")
    busy_share("hybrid", eng, {"B": "ring_phase_c_kernel",
                               "A": "stream_count_kernel"})
    return launches


def run_hybrid20():
    """Phase 12: the hybrid tier at rmat20 — the sub-core stream's exact
    size first (build_stream(plan_only=True)), then the build, the count,
    the peak device memory and the device count time."""
    from graphminer_tpu_torch.ops.hybrid import HybridEngine
    from graphminer_tpu_torch.ops.ring import CORE
    from graphminer_tpu_torch.ops.stream import build_stream
    t0 = time.perf_counter()
    g = write_rmat(20)
    t1 = time.perf_counter()
    rg = g.relabel_by_degree(descending=False).orientation()
    est = build_stream(rg, core=CORE, dst_below=rg.n_vertices - CORE,
                       plan_only=True)
    whole = build_stream(rg, core=CORE, plan_only=True)
    say(f"rmat20: DAG max degree {rg.max_degree}, {rg.n_edges} DAG edges; "
        f"sub-core stream estimate {est} B, whole stream layout {whole} B "
        f"({time.perf_counter() - t1:.1f} s)")
    torch.cuda.reset_peak_memory_stats()
    t1 = time.perf_counter()
    eng = HybridEngine(rg, device="cuda")
    torch.cuda.synchronize()
    t_build = time.perf_counter() - t1
    check(eng.stream.nbytes() == est,
          f"rmat20 sub-core stream {eng.stream.nbytes()} B != estimate {est}")
    total, _ = hybrid_launch_check("HybridEngine rmat20 count", eng)
    check(total == GOLDEN[20], f"rmat20 hybrid count {total} != "
          f"{GOLDEN[20]}")
    e_ms, _ = time_ms(lambda: eng.partials().sum())
    say(f"[{CARD}] HybridEngine rmat20: count={total} build_s={t_build:.2f}"
        f" layout {eng.nbytes()} B (sub-core stream {eng.stream.nbytes()})"
        f"; max_memory_allocated {torch.cuda.max_memory_allocated()} B; "
        f"device count {e_ms:.4f} ms, "
        f"{eng.n_edges / (e_ms / 1e3):.4e} edge tasks/s; phase "
        f"{time.perf_counter() - t0:.1f} s")


#: the CLI runs of phase 9: (scale, verb arguments, golden); all but the
#: --fast cliques (CliqueKEngine) take the generic path
GENERIC_CLI = ((18, ("tc",), GOLDEN[18]),
               (14, ("clique", "4"), 36_628_817),
               (14, ("clique", "5"), 387_027_732),
               (14, ("clique", "4", "--fast"), 36_628_817),
               (14, ("clique", "5", "--fast"), 387_027_732),
               (12, ("sgl", "diamond"), 57_515_371),
               (12, ("sgl", "rectangle"), 52_988_519))


def run_generic_cli(n_lo14):
    """Phase 9: `python -m graphminer_tpu_torch <verb>` on CUDA, without
    --cpu: the generic set-operation path (setops, DeviceGraph, the frontier
    engine), which launches no kernel of ours, and `clique 4|5 --fast`
    (CliqueKEngine at its defaults), which must launch X and, when the
    engine has lo tasks (`n_lo14`, phase 3's rmat14 engines), L once."""
    t0 = time.perf_counter()
    for scale in sorted({s for s, _, _ in GENERIC_CLI} - {18}):
        write_rmat(scale)
    out = {}
    for scale, args, want in GENERIC_CLI:
        t1 = time.perf_counter()
        r = subprocess.run([sys.executable, "-m", "graphminer_tpu_torch",
                            args[0], graph_prefix(scale), *args[1:],
                            "--json", "--profile"], cwd=REPO,
                           capture_output=True, text=True, timeout=600)
        sys.stderr.write(r.stderr)
        check(r.returncode == 0, f"CLI {args} exited {r.returncode}")
        res = json.loads(r.stdout.strip().splitlines()[-1])
        prof = res["profile"]
        fast = "--fast" in args
        say(f"[{CARD}] CLI {' '.join(args)} rmat{scale} "
            f"({'CliqueKEngine' if fast else 'generic'}, cuda): "
            f"total={res['total']} run_s={res['run_s']} "
            f"load_s={res['load_s']} device_count_s="
            f"{prof['phases_s'].get('device_count')} device={prof['device']}"
            f" launches={prof['kernel_launches']} "
            f"(wall {time.perf_counter() - t1:.1f} s)")
        check(prof["device"] == "cuda", f"CLI {args} ran on {prof['device']}")
        check(res["total"] == want, f"CLI {args} rmat{scale} total "
              f"{res['total']} != {want}")
        x_l = [prof["kernel_launches"][k] for k in ("expand_bits",
                                                     "lo_popcount")]
        # X: B_hh and each slab; L: once, unless the engine has no lo task
        check(x_l[0] >= 2 and x_l[1] == int(n_lo14[int(args[1])] > 0)
              if fast else not any(x_l),
              f"CLI {args}: launches of X and L {x_l}")
        out[" ".join(args)] = res["run_s"]
    say(f"generic CLI phase: {time.perf_counter() - t0:.1f} s")
    return out


def run_map_vs_compact():
    """Phase 10: the frontier's map engine against its compact engine on the
    card at rmat10, cliques k = 3-5 and the four SGL plans."""
    from graphminer_tpu_torch.core.plan import SGL_PLANS, clique_plan
    from graphminer_tpu_torch.engine.frontier import count_pattern
    from graphminer_tpu_torch.io.synth import rmat
    t0 = time.perf_counter()
    g = rmat(10, 16, seed=7)
    plans = [clique_plan(k) for k in (3, 4, 5)] + [
        SGL_PLANS[n] for n in ("diamond", "rectangle", "house", "pentagon")]
    for p in plans:
        t1 = time.perf_counter()
        c = count_pattern(g, p, engine="compact", chunk=16384, device="cuda")
        t2 = time.perf_counter()
        m = count_pattern(g, p, engine="map", chunk=64, device="cuda")
        say(f"rmat10 {p.name}: compact {c} ({t2 - t1:.2f} s), map {m} "
            f"({time.perf_counter() - t2:.2f} s)")
        check(c == m and c > 0, f"rmat10 {p.name}: map {m} != compact {c}")
    say(f"map == compact phase: {time.perf_counter() - t0:.1f} s")


def run_setops_card_vs_cpu():
    """Phase 11: every set operation, both backends, on the card against
    the CPU, on random rows of widths 8-4096 (empty, full, SENTINEL and
    bounded rows among them)."""
    from graphminer_tpu_torch.ops import setops
    t0 = time.perf_counter()
    rng = np.random.default_rng(11)
    n_cases = 0
    for w in (8, 16, 100, 128, 1000, 4096):
        b_rows = 257 if w <= 128 else 33      # bc on the CPU: rows*w*w
        a = rng.integers(0, 3 * w, (b_rows, w)).astype(np.int32)
        a[rng.random((b_rows, w)) < 0.2] = SENTINEL
        b = np.sort(rng.integers(0, 3 * w, (b_rows, w)), axis=1
                    ).astype(np.int32)
        b[rng.random((b_rows, w)) < 0.3] = SENTINEL
        b = np.sort(b, axis=1)                 # SENTINEL tails
        b[0], a[1] = SENTINEL, SENTINEL
        b[2] = np.arange(w)
        upper = rng.integers(0, 3 * w, b_rows).astype(np.int32)
        anc = a[:, :3].copy()
        x = b[:, 0].copy()
        cpu = [torch.from_numpy(t) for t in (a, b, upper, anc, x)]
        card = [t.cuda() for t in cpu]
        for backend in ("bc", "bs"):
            for args, ops in (((0, 1), ("member", "intersect_count",
                                        "intersect", "difference_count",
                                        "difference")),
                              ((0, 1, 2), ("intersect_count", "intersect",
                                           "difference_count",
                                           "difference")),
                              ((4, 1), ("connected",))):
                for op in ops:
                    fn = getattr(setops, op)
                    got = fn(*(card[i] for i in args), backend=backend)
                    want = fn(*(cpu[i] for i in args), backend=backend)
                    check(torch.equal(got.cpu(), want),
                          f"setops.{op} {backend} w={w}: card != CPU")
                    n_cases += 1
        for op, args in (("bounded", (0, 2)), ("exclude", (0, 3)),
                         ("count_valid", (0,)), ("count_valid", (0, 2))):
            fn = getattr(setops, op)
            check(torch.equal(fn(*(card[i] for i in args)).cpu(),
                              fn(*(cpu[i] for i in args))),
                  f"setops.{op} w={w}: card != CPU")
            n_cases += 1
    say(f"setops card == CPU: {n_cases} cases, widths 8-4096 "
        f"({time.perf_counter() - t0:.1f} s)")


def lo_bytes(eng, n_partials):
    """The bytes kernel L must move for an engine's lo tasks: the task
    columns, each bitmap row that a valid task names read once (core rows
    are bm rows), and its n_partials int64 partials."""
    cols = eng.lo_cols
    v, cs = eng.bm.shape[0], eng.bm.shape[0] - eng.core.shape[0]
    ab, cd = cols[:, :2].long(), cols[:, 2:].long()
    ok = ((ab >= 0) & (ab < v)).all(dim=1) & \
        ((cd >= 0) & (cd < eng.core.shape[0])).all(dim=1)
    ids = torch.cat([ab[ok].reshape(-1), cd[ok].reshape(-1) + cs])
    return (cols.numel() * 4 + int(torch.unique(ids).numel()) * eng.words * 4
            + 8 * n_partials)


def x_bytes(base, kw, out):
    """The bytes kernel X must move for one call: its output written, the
    task ids read, and each packed row a valid task names read once (the
    whole of `base` in plain mode)."""
    hw = base.shape[1]
    n = out.numel()
    for ids, tab in ((kw.get("r"), base), (kw.get("cols"), kw.get("tab"))):
        if ids is None:
            continue
        ids = ids.long()
        ok = (ids >= 0) & (ids < tab.shape[0])
        n += ids.numel() * 4 + int(torch.unique(ids[ok]).numel()) * hw * 4
    return n + (base.numel() * 4 if kw.get("r") is None else 0)


def run_clique18(g):
    """Phase 13: CliqueKEngine on rmat18 at k = 4, then (the first freed)
    at k = 5, each against GOLDEN_CK: prep, the native enumerator, task
    counts, the count with launches read from counts reset just before it
    (X once a slab, L once when there are lo tasks), the device count split
    hi / lo (CUDA events; the tail is the frontier's, counted at build),
    X's, torch._int_mm's and L's device time beside their bounds, and the
    peak device memory; then X against its plain version on the first and
    the last slab of each count, and L on each engine's lo tasks. Returns
    ({kernel: timing} for X at k = 4's first slab and L at k = 5,
    {kernel: launches over both counts})."""
    from graphminer_tpu_torch.ops import cuda_cliquek, cuda_expand
    from graphminer_tpu_torch.ops.cliquek import CliqueKEngine
    from graphminer_tpu_torch.utils.profiling import bound_ms
    res, launches = {}, {"expand_bits": 0, "lo_popcount": 0}
    for k in (4, 5):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng = CliqueKEngine(g, k, device="cuda")
        torch.cuda.synchronize()
        say(f"CliqueKEngine rmat18 k={k}: build {time.perf_counter() - t0:.1f}"
            f" s (prep {eng.prep_s:.1f} s, "
            f"{'native' if eng.native else 'numpy'} enumerator; tail by the "
            f"frontier {eng.tail_s:.1f} s, {eng.tail_total} cliques); "
            f"n_core_edges {eng.n_core_edges} n_tri {eng.n_tri} n_lo "
            f"{eng.n_lo} of {eng.n_edges} DAG edges; hi {eng.hi_dim}, "
            f"{eng.n_slabs} slabs of <= {eng.slab} tasks")
        path = ["expand_bits"] + (["lo_popcount"] if eng.n_lo else [])
        total, got = run_path(f"CliqueKEngine rmat18 k={k} count", eng.count,
                              path)
        check(total == GOLDEN_CK[k], f"rmat18 {k}-cliques {total} != "
              f"{GOLDEN_CK[k]}")
        check(got["expand_bits"] == eng.n_slabs, f"X launched "
              f"{got['expand_bits']} times over {eng.n_slabs} slabs")
        check(got.get("lo_popcount", 0) == (1 if eng.n_lo else 0),
              f"L launched {got.get('lo_popcount')} times")
        for key, n in got.items():
            launches[key] += n
        hi_ms, hi = time_ms(lambda: eng.hi_partials().sum())
        lo_ms, lo = time_ms(lambda: eng.lo_partials().sum())
        all_ms, both = time_ms(lambda: eng.hi_partials().sum()
                               + eng.lo_partials().sum())
        check(int(both) + eng.tail_total == GOLDEN_CK[k],
              f"rmat18 k={k} hi + lo + tail")
        slabs = list(eng.slab_args())
        base, kw = slabs[0]
        x_ms, yt = time_ms(lambda: cuda_expand.expand_bits(base, **kw))
        x_bound = bound_ms(x_bytes(base, kw, yt))
        mm_ms, _ = time_ms(lambda: torch._int_mm(yt, yt.t()))
        mm_bound = bound_ms(0, 2 * eng.hi_dim ** 2 * yt.shape[1])
        rows_hi = sum(eng.slab_tasks)
        hi_bound = bound_ms(rows_hi * eng.hi_dim,
                            2 * eng.hi_dim ** 2 * rows_hi)
        say(f"[{CARD}] CliqueKEngine rmat18 k={k}: count {total} (hi "
            f"{int(hi)} + lo {int(lo)} + tail {eng.tail_total}); device "
            f"count {all_ms:.3f} ms (hi {hi_ms:.3f} ms over {eng.n_slabs} "
            f"slabs of {rows_hi} expanded rows in all, bound "
            f"{hi_bound[0]:.3f} ms ({hi_bound[1]}); lo {lo_ms:.4f} ms), "
            f"{eng.n_core_edges / all_ms * 1e3:.4e} core edge tasks/s; first "
            f"slab [{yt.shape[0]}, {yt.shape[1]}]: "
            f"X {x_ms:.4f} ms (bound {x_bound[0]:.4f} ms, bytes), _int_mm "
            f"{mm_ms:.3f} ms (bound {mm_bound[0]:.4f} ms, operations); "
            f"max_memory_allocated {torch.cuda.max_memory_allocated()} B, "
            f"memory_reserved {torch.cuda.memory_reserved()} B")
        del yt
        # X == plain on the first and the last slab of the count (the last
        # is the one with padding rows)
        for i in sorted({0, len(slabs) - 1}):
            base, kw = slabs[i]
            if k == 4 and i == 0:
                kx, px, kv, pv = in_turns(
                    lambda: cuda_expand.expand_bits(base, **kw),
                    lambda: cuda_expand.expand_bits_plain(base, **kw))
                res["expand_bits"] = dict(ms=kx, plain_ms=px,
                                          bound_ms=x_bound[0],
                                          bound_by=x_bound[1],
                                          library_ms=None)
            else:
                kv = cuda_expand.expand_bits(base, **kw)
                pv = cuda_expand.expand_bits_plain(base, **kw)
            compare_rows("expand_bits", kv, pv, f"rmat18 k={k} slab {i} of "
                         f"{len(slabs)} ({sorted(kw)})")
            del kv, pv
        if eng.n_lo:
            kl, pl, kv, pv = in_turns(
                lambda: cuda_cliquek.lo_popcount(eng.bm, eng.core,
                                                 eng.lo_cols),
                lambda: cuda_cliquek.lo_popcount_plain(eng.bm, eng.core,
                                                       eng.lo_cols))
            compare("lo_popcount", kv.sum(), pv.sum(),
                    f"rmat18 k={k} lo tasks")
            nbytes = lo_bytes(eng, kv.numel())
            lb = bound_ms(nbytes)
            if k == 5:
                res["lo_popcount"] = dict(ms=kl, plain_ms=pl, bound_ms=lb[0],
                                          bound_by=lb[1], library_ms=None)
            say(f"[{CARD}] lo_popcount rmat18 k={k} ({eng.n_lo} lo tasks, 1 "
                f"launch): kernel {kl:.4f} ms, plain {pl:.3f} ms, bound "
                f"{lb[0]:.4f} ms ({lb[1]}, {nbytes} B)")
        del eng
    torch.cuda.empty_cache()
    check(set(res) == {"expand_bits", "lo_popcount"},
          f"phase 13 timed only {sorted(res)}")
    return res, launches


def main():
    check_environment()
    build_kernels()
    launches = run_launch_check()
    kernel_checks_random()
    kernel_checks_rmat14()
    n_lo14 = kernel_checks_cliquek14()

    g = write_rmat18()
    launches["stream_bucket_count"] = run_cli()
    ring_eng, ring_launches = run_ring(g)
    launches.update(ring_launches)
    hub_eng, hub_launches = run_triangle_engine(g)
    launches.update(hub_launches)
    pb, pb_launches = run_prof_breakdown()
    launches["fetch_rows_sum"] = pb_launches["fetch_rows_sum"]
    pw, pw_launches = run_prof_window()
    launches.update(pw_launches)

    from graphminer_tpu_torch.ops.stream import StreamEngine
    t0 = time.perf_counter()
    stream_eng = StreamEngine(g, device="cuda")
    say(f"StreamEngine rmat18 build: {time.perf_counter() - t0:.1f} s, "
        f"{len(stream_eng.stream.buckets)} buckets")
    res = timing(stream_eng, ring_eng)
    del stream_eng
    res.update(timing_slice(hub_eng, pb, pw))
    torch.cuda.synchronize()

    run_hybrid18(g)
    del hub_eng, ring_eng
    torch.cuda.empty_cache()
    run_generic_cli(n_lo14)
    run_map_vs_compact()
    run_setops_card_vs_cpu()
    run_hybrid20()
    ck_res, ck_launches = run_clique18(g)
    res.update(ck_res)
    launches.update(ck_launches)
    torch.cuda.synchronize()

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("device_ms", "library_device_ms", "host_us", "library_host_us")
    say(json.dumps({"kernels": [
        dict(name=k, **KERNELS[k], launches=launches[k],
             max_abs_err=MAX_ERR[k], **{x: res[k][x] for x in keys},
             **{x: res[k][x] for x in extra if x in res[k]})
        for k in KERNELS]}))
    say(CARD)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
