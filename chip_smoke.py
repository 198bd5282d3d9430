#!/usr/bin/env python3
"""Smoke test of graphminer_tpu_torch on one NVIDIA GPU (built for the H100).

    python3 chip_smoke.py

Drives the port's paths — exact triangle counting on RMAT scale 18, edge
factor 16, seed 7 (82,947,332 triangles) through the stream, ring,
hub-core and hybrid engines and the generic set-operation path, the
three probe scripts, the generic clique and SgL counts, the fast 4- and
5-clique engine on the same graph (2,280,263,816 and 55,374,832,965),
the large-clique engine (k = 6 at rmat14 and rmat16, k = 7 and 8 at
rmat12), the fast diamond and rectangle engines (45,873,513,836
diamonds and 51,349,430,411 4-cycles at rmat18) and the fast house engine
(71,686,049,455,877 houses at rmat18) with the motif and sc verbs, the
labelled workloads, the dense-core hybrid and clique4 engines and the
scale-out layer (sharded, partitioned and 2-process counts) — and
fails (non-zero exit, no result line) when any phase fails:

  1. card and versions; exits when torch.cuda.is_available() is false;
  2. builds the CUDA kernels from graphminer_tpu_torch/csrc with nvcc, then
     launches kernel R through the port's launch_check script;
  3. holds kernels A, B, C, D, E, m3, m3b, R, X, L, G and Q (its count
     and its emit; S, P, I and W's modes in phase 15, H in 16) against their
     plain PyTorch versions on the card, exactly: random inputs over every
     width class, A, B, C and E also as one grouped launch over random
     multi-bucket sets, X in both layouts, plain and gathered (depth 0-4),
     L over run tables at 2-8 rows a task (random tasks, and runs of 1-5000
     tasks; at 5-7 rows with the last column varying) and with no task (no
     launch), G at 1-128 words and depth 0-6 with a mask that is not
     triangular, Q at 8-160 words, on whole tables and on views, with ids
     outside their tables, 4096-quad tasks and an empty chunk (no launch),
     and refusing tables that are not 16-byte aligned, then
     the real buckets and tail
     groups of rmat14 builds, one by one and grouped (counts 2,860,691,
     also through TriangleEngine), G on the rmat14 spoke, and X's slabs and
     B_hh, G's hi tasks and L's lo tasks of the rmat14 CliqueKEngine at
     k = 4 and 5;
  4. runs `python -m graphminer_tpu_torch tc <rmat18> --fast --json
     --profile` and checks its count and that kernel A launched once;
  5. runs the ring engine on the same graph and checks its count and that
     kernels B and C launched once each;
  6. runs TriangleEngine on the same graph (count, tail + core split,
     kernels E and G launched once each and X never; X is held to its
     plain version on the slab form's first spoke slab and core mask), the
     port's prof_breakdown at rmat18 (kernels E and D) and prof_window at
     its defaults (m1 = m2 = m3 = m3b), in process;
  7. times every kernel with CUDA events (median of 11 after warm-up),
     kernel and plain version side by side, each beside the least time an
     H100 could take for the same work (A, B, C and E as the engines'
     single launch, A also over groups of the rmat18 buckets; B also with
     the bytes it reads past L1), the spoke by G in turns with the slab
     form it replaced (X + torch._int_mm) beside G's bounds, the
     device-busy share of stream, ring and
     hub-core counts from torch.profiler; the device time alone
     (torch.profiler) of D at each of prof_breakdown's shapes, of m3 and
     m3b, and of R and torch.mul,
     failing unless a D call and a window_count call each run one kernel
     and no other device op (a device time that torch.profiler recorded
     no event for, or fewer than 0.9 of the kernel's events a call, in
     three readings is "not measured", null in the kernels line, and only
     the launch counts are held); and R's host
     time a call, split into the
     parts of its wrapper's path (host clock over 10,000 calls);
  8. runs the hybrid engine (ring phase C + sub-core stream) on rmat18:
     count, one launch each of B and A and none of C or E, the coverage
     of the DAG edges, layout bytes, device count time and busy share;
  9. runs `python -m graphminer_tpu_torch` without --cpu: tc on rmat18,
     clique 4 and 5 on rmat14 (36,628,817 and 387,027,732) generic and
     with --fast (CliqueKEngine: X once at build, G once, L once where
     there are lo tasks), sgl diamond and rectangle on rmat12 (57,515,371 and
     52,988,519) generic and with --fast (S once; W's pairs mode and its
     finish once each), each against
     its golden, with its run_s;
 10. holds the frontier's map engine against its compact engine on the
     card at rmat10, cliques k = 3-5 and the four SGL plans;
 11. holds every set operation, both backends, on the card against the
     CPU on random rows of widths 8-4096;
 12. sizes the hybrid's sub-core stream at rmat20 (build_stream
     plan_only), builds the engine and checks its count (423,537,282),
     the estimate against the built bytes, its launches, the peak device
     memory and the device count time;
 13. builds CliqueKEngine on rmat18 at k = 4, then at k = 5, and checks each
     build (X once, for B_hh) and count (2,280,263,816 and 55,374,832,965;
     G and L once each, X never), and prints prep time, task counts, the
     lo run table's runs, the device count split hi / lo, G in turns with
     the slab form it replaced beside G's bounds, X's and L's device time
     beside their bounds and the peak device memory; then holds G to its
     plain version on each count's hi tasks, X on the first and the last
     slab of each count's slab form and L on each lo run table;
 14. runs CliqueBigEngine (k >= 6) against its goldens: rmat14 k = 6
     (3,345,978,434) on the host-streamed path and on the device path
     (kernel Q's count and emit, then G), forced, with equal hi tasks; Q's
     count against its plain version and the chunks' offsets on all the
     count's triangle tasks, Q's emit, G and L against their plain
     versions on the device path's first chunk and first lo dispatch, and
     both Q launches timed beside their bounds (the emit also beside the
     time of Q's first design, one warp a task); rmat12 k = 7 (632,745,449),
     also with small dispatches, and k = 8 (2,295,344,783), also by the
     native DFS counter; rmat16 k = 6 (59,924,973,905) on the path the
     engine picks. Each count launches G once a hi dispatch, L once a lo
     dispatch, Q's emit once a chunk and Q's count once (the device path
     only), and prints its prep, tail and count seconds, the host split of
     its hi part, task counts, launches, device ms of G, L and Q (CUDA
     events) and peak device memory;
 15. runs the fast SgL engines: holds S, P and I against their plain
     versions on every task class of the rmat14 tri_support, W's write
     mode on the first and last case-B chunk of the rmat14 yardstick
     (ops/slab_form.py::rectangle_level0_slab), and W's pairs mode and its
     finish on random inputs (bit 31, bad ids, rows of degree 0 and 1,
     split and unsplit), on rmat14's level-0 plan and on one with a forced
     split; tri_support at rmat14 and rmat18 (S, P and I once each; the
     sum of tri three times the triangle golden) and the rmat18 diamonds;
     rectangle_count_fast at rmat12, 13, 14 and 18 against bench.py:82-85
     (W's pairs mode once and its finish once when the level splits a
     row; no W write mode, X or torch._int_mm); the rmat18 counts once
     more under torch.profiler (host s, device ms, busy share, peak
     memory); the yardstick at rmat18 (W's write mode once a case-B chunk
     with a sub neighbour, equal to the pairs mode); and S, P, I and W's
     three launches timed at rmat18 beside their bounds, level 0 by the
     pairs mode in turns with the yardstick, and the yardstick's Gram and
     case B beside their int8 operation bounds;
 16. runs the fast house engine and the motif and sc verbs: holds kernel H
     against its plain version on random inputs (4-160 words, bit 31, ids
     outside [0, V), empty lists, runs of 1, sorted runs of up to 30,000
     tasks over lists of up to 30,000 ids, no order; graph-like tables
     with and without the sparse view, rows on both sides of the plan's
     density threshold and at it, plans built before the call and the
     wrapper's own, block or warp items alone; no launch without a task)
     and on both calls of the rmat14 and rmat18 counts;
     house_count_fast at rmat14 and rmat18 against bench.py:86-87 (two H
     launches a count); the rmat18 count's t3ss host time and the count
     under torch.profiler; H's calls timed at rmat18 beside their bounds
     and plain versions (the wrapper's plan included, a plan built before,
     the plan alone and the kernel alone; what each plan holds), and both
     in turns with the JAX form they replaced
     (X + torch._int_mm + W's write mode); then the CLI on the card: sgl
     house --fast == generic at rmat12, motif 3 and 4 --fast at rmat18
     against their goldens (B and C; S, P, I, G, L and W's pairs mode once
     each), motif 4 --fast == generic at rmat12, sc hourglass and diamond
     at rmat12 against tri_support's formulas, and motif 5 at rmat10 (its
     5clique against clique 5);
 17. runs the labelled workloads, which launch no kernel of ours (each
     run fails if one launched): FSM on rmat(14, 8, seed=7) labelled by
     default_rng(7).integers(1, 5) at k = 2 against its goldens (50 at
     minsup 300, BENCH_r05.json; 11 at minsup 1500, the JAX package on the
     CPU) with its extensions, host syncs, overflow retries and phase
     seconds; every evaluated pattern's MNI support on the card equal to
     the CPU's on the same labelled rmat12 (k = 2, minsup 100) and on an
     edge-labelled ER graph (k = 3); the query 1,2,3,4:0-1,1-2,0-2,2-3 on
     the labelled rmat14, filtered == unfiltered on the card == the CPU;
     GKS k = 3, keywords 1,2,3 on the labelled rmat11, card == CPU; and the
     CLI's fsm, gks and query on the card on the labelled rmat11 saved with
     vertex and edge labels, against the CPU's counts, with no launch
     (--profile's kernel_launches all 0). Each count prints its seconds;
 18. runs the dense core and clique4 on kernel G and the scale-out layer:
     triangle_count_hybrid on rmat18 at core 16384 (G once and nothing
     else of ours), G == plain on the rmat14 dense core (512 words, base =
     mask), the rmat18 core's G launch timed beside its bound and the
     library form (D as int8, torch._int_mm(D, Dᵀ), the masked sum);
     Clique4Engine on rmat18 (2,280,263,816; build, count and G's device
     ms) and clique4_count_fast on rmat14 (36,628,817), G once a count,
     G == plain on the rmat14 engine's core-dst tasks; then, launching
     nothing of ours, count_pattern_sharded on rmat18 over a (1, 1) mesh,
     every card and a (2, 2) mesh that repeats a card, and diamonds on
     rmat12 (57,515,371); count_pattern_partitioned on rmat18 (4 parts)
     and 4-cycles on rmat12 (2 parts, hops 2: 52,988,519);
     triangle_count_segmented on rmat16 (4 segments: 15,623,664); a
     2-process count_pattern_multiprocess on rmat18, both ranks on the card
     through gloo, each printing the golden; the CLI's tc rmat18 and clique
     4 rmat14 with --sharded and --partition (4 and 2) on the card; and
     graphminer_tpu_torch/scripts/dryrun_multichip.py with n = 4.

Each path of phases 2, 4-6, 8 and 12-18 runs with every launch count set to
0 just before it, and its counts are read just after. The line before the
last is the card's name and power limit; the last line is {"ok": true,
"device": {...}}. The rmat10, rmat12, rmat14, rmat16, rmat18 and rmat20
graphs and the labelled rmat11 are written under the git-ignored
graph_cache/ directory.
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
        "replaces": "graphminer_tpu/ops/cliquek.py:312"},
    "bit_gram": {
        "route": "cuda",
        "source": "graphminer_tpu_torch/csrc/bit_gram.cu",
        "replaces": "graphminer_tpu/ops/cliquek.py:223, "
                    "graphminer_tpu/ops/dense_core.py:25, "
                    "graphminer_tpu/ops/clique4.py:55"},
    "quad_emit": {
        "route": "cuda",
        "source": "graphminer_tpu_torch/csrc/quad_emit.cu",
        "replaces": "graphminer_tpu/ops/cliquebig.py:140"},
    "quad_count": {
        "route": "cuda",
        "source": "graphminer_tpu_torch/csrc/quad_emit.cu",
        "replaces": "graphminer_tpu/ops/cliquebig.py:161"},
    "tri_bitmap": {
        "route": "cuda",
        "source": "graphminer_tpu_torch/csrc/tri_support.cu",
        "replaces": "graphminer_tpu/ops/tri_support.py:79"},
    "tri_probe": {
        "route": "cuda",
        "source": "graphminer_tpu_torch/csrc/tri_support.cu",
        "replaces": "graphminer_tpu/ops/tri_support.py:110"},
    "tri_lists": {
        "route": "cuda",
        "source": "graphminer_tpu_torch/csrc/tri_support.cu",
        "replaces": "graphminer_tpu/ops/tri_support.py:135"},
    "bit_colsum": {
        "route": "cuda",
        "source": "graphminer_tpu_torch/csrc/bit_colsum.cu",
        "replaces": "graphminer_tpu/ops/rectangle.py:149"},
    "colsum_pairs": {
        "route": "cuda",
        "source": "graphminer_tpu_torch/csrc/bit_colsum.cu",
        "replaces": "graphminer_tpu/ops/rectangle.py:93"},
    "colsum_finish": {
        "route": "cuda",
        "source": "graphminer_tpu_torch/csrc/bit_colsum.cu",
        "replaces": "graphminer_tpu/ops/rectangle.py:119"},
    "house_t3": {
        "route": "cuda",
        "source": "graphminer_tpu_torch/csrc/house_t3.cu",
        "replaces": "graphminer_tpu/ops/house.py:65"},
}
#: rmat(18, 16, seed=7) k-cliques (bench.py:64-68)
GOLDEN_CK = {4: 2_280_263_816, 5: 55_374_832_965}
#: rmat(scale, 16, seed=7) k-cliques for k >= 6 (bench.py:74-76,
#: tests/test_cliquebig.py)
GOLDEN_BIG = {(14, 6): 3_345_978_434, (16, 6): 59_924_973_905,
              (12, 7): 632_745_449, (12, 8): 2_295_344_783}
#: kernel L's first design at rmat18, ms a count (PERF.md, PR 7)
PR7_L_MS = {4: 0.1367, 5: 1.5169}
#: kernel Q's first design (one warp a task, offsets from the host) on the
#: rmat14 k = 6 chunk, ms on an H100 80GB HBM3, 700 W (PERF.md)
FIRST_Q_MS = 1.9027
MAX_ERR = {k: 0 for k in KERNELS}
#: window_count's rows_per_step of kernels m3 and m3b
WINDOW_ROWS = {"window_count_m3": 1, "window_count_m3b": 8}


def check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def shown(ms, digits=4):
    """A device time in ms as text, or "not measured" for None."""
    return "not measured" if ms is None else f"{ms:.{digits}f} ms"


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
    from graphminer_tpu_torch.ops import (cuda_check, cuda_cliquebig,
                                          cuda_cliquek, cuda_colsum,
                                          cuda_expand, cuda_gram,
                                          cuda_house, cuda_hubcore,
                                          cuda_ring, cuda_stream, cuda_tri,
                                          cuda_window, fetch)
    return {"stream_bucket_count": cuda_stream.stream_bucket_count,
            "ring_phase_c": cuda_ring.ring_phase_c,
            "ring_tail_pairs": cuda_ring.ring_tail_pairs,
            "fetch_rows_sum": fetch.fetch_rows_sum,
            "hub_tail_count": cuda_hubcore.hub_tail_count,
            "window_count": cuda_window.window_count,
            "times_two": cuda_check.times_two,
            "expand_bits": cuda_expand.expand_bits,
            "lo_popcount": cuda_cliquek.lo_popcount,
            "bit_gram": cuda_gram.bit_gram,
            "quad_emit": cuda_cliquebig.quad_emit,
            "quad_count": cuda_cliquebig.quad_count,
            "tri_bitmap": cuda_tri.tri_bitmap,
            "tri_probe": cuda_tri.tri_probe,
            "tri_lists": cuda_tri.tri_lists,
            "bit_colsum": cuda_colsum.bit_colsum,
            "colsum_pairs": cuda_colsum.colsum_pairs,
            "colsum_finish": cuda_colsum.colsum_finish,
            "house_t3": cuda_house.house_t3}


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
    n_cases += kernel_checks_random_g(rng, t)
    n_cases += kernel_checks_random_big(rng, t)
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
    output layouts; L: run tables at nrow 2-8 of random tasks (SENTINEL
    rows, ids outside the tables) and of runs of 1-5000 tasks (one with an
    all-zero AND), and an empty table, which must launch nothing."""
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
    L, Lp = cuda_cliquek.lo_popcount, cuda_cliquek.lo_popcount_plain
    for words in (8, 128):
        bm = t(_words(rng, (v, words)))
        core = bm[v - c:]
        for nrow in range(2, 9):
            # random tasks (runs of one task, mostly), then runs of 1-5000
            # tasks (long runs span many groups) with an all-zero AND
            n = 100000 if words == 8 else 30000
            vc = 2 if nrow > 2 else 1
            cols = np.concatenate([rng.integers(-1, v + 1, (n, 2)),
                                   rng.integers(-2, c + 2, (n, nrow - 2))],
                                  axis=1).astype(np.int32)
            cols[-4096:] = SENTINEL
            runs = cuda_cliquek.lo_runs(cols, vc, device="cuda")
            compare("lo_popcount", L(bm, core, runs).sum(),
                    Lp(bm, core, runs).sum(),
                    f"random words={words} nrow={nrow}")
            lens = rng.choice([1, 1, 2, 3, 17, 130, 700, 5000], 200)
            first = np.concatenate([rng.integers(0, v, (lens.size, 2)),
                                    rng.integers(0, c, (lens.size,
                                                        nrow - 2))], axis=1)
            cols = np.repeat(first, lens, axis=0)
            lim = v if vc < 2 else c
            cols[:, vc] = rng.integers(-1, lim + 1, cols.shape[0])
            cols[:lens[0], 0] = v - c            # a row with no bit...
            bm[v - c] = 0                        # ...so z == 0 for a run
            runs = cuda_cliquek.lo_runs(cols.astype(np.int32), vc,
                                        device="cuda")
            compare("lo_popcount", L(bm, core, runs).sum(),
                    Lp(bm, core, runs).sum(),
                    f"runs of 1-5000 words={words} nrow={nrow} "
                    f"({runs.n_runs} runs, {runs.n} tasks)")
            n_cases += 2
    before = L.launches
    got = L(bm, core, cuda_cliquek.lo_runs(np.zeros((0, 4), np.int32),
                                           device="cuda"))
    check(L.launches == before and int(got.sum()) == 0,
          "lo_popcount with no tasks launched or counted")
    return n_cases + 1


def kernel_checks_random_g(rng, t):
    """G on random inputs; returns the number of cases: strided rows of hw
    4, 16, 32 and 128 words (every bit 31 in play), gathered at depth 0-6
    (rows explicit, some SENTINEL or outside base, c ids some outside tab)
    and plain, n no multiple of a K-range, a random mask that is not
    triangular with an empty tile row, and hw 1, 2, 5 (4-byte copies)."""
    from graphminer_tpu_torch.ops import cuda_gram
    G, Gp = cuda_gram.bit_gram, cuda_gram.bit_gram_plain
    n_cases = 0
    for hw in (4, 16, 32, 128):
        nb, nt = 5000, 3000
        n = 200_003 if hw <= 32 else 20_011
        base = t(_words(rng, (nb, hw + 4)))[:, 4:]
        tab = t(_words(rng, (nt, hw + 8)))[:, :hw]
        nm = 32 * hw - 5
        mask_np = _words(rng, (nm, hw + 2)) & _words(rng, (nm, hw + 2))
        if hw >= 8:
            mask_np[128:256] = 0
        mask = t(mask_np)[:, 1:hw + 1]
        plan = cuda_gram.plan_gram(mask)
        for depth in range(7):
            r = rng.integers(-2, nb + 2, n).astype(np.int32)
            r[::29] = SENTINEL
            kw = dict(r=t(r))
            if depth:
                cols = rng.integers(-2, nt + 2, (n, depth)).astype(np.int32)
                cols[::31, depth - 1] = SENTINEL
                kw.update(tab=tab, cols=t(cols))
            compare("bit_gram", G(base, mask, plan=plan, **kw),
                    Gp(base, mask, **kw),
                    f"random hw={hw} depth={depth} n={n} "
                    f"({plan.n_tiles} tiles)")
            n_cases += 1
        compare("bit_gram", G(base, mask, plan=plan), Gp(base, mask),
                f"random hw={hw} plain rows n={nb}")
        n_cases += 1
    for hw in (1, 2, 5):
        base, mask = t(_words(rng, (9001, hw))), t(_words(rng, (32 * hw, hw)))
        compare("bit_gram", G(base, mask), Gp(base, mask),
                f"random hw={hw} (4-byte copies)")
        n_cases += 1
    before = G.launches
    got = G(base[:0], mask)
    check(G.launches == before and int(got.sum()) == 0,
          "bit_gram with no tasks launched or counted")
    return n_cases + 1


def kernel_checks_random_big(rng, t):
    """Q, G and L at the large-clique engine's shapes on random inputs;
    returns the number of cases. Q's count and emit: words 8, 32, 128 and
    160 (wider than a warp's load), whole tables and views 4 words in, bit
    31 in play, n_bits inside a word, ids outside their tables, runs of
    equal erow, tasks of 4096 quads (staged in rounds), offsets past 2^31,
    and an empty chunk, which must launch nothing; a view 1 word in (not
    16-byte aligned) must be refused; G: hw 1, 2 and 8 (k = 8, 7 and 6) at depth 2-4
    (k - 4); L: nrow 5-7 (k - 1), the last column varying."""
    from graphminer_tpu_torch.ops import (cuda_cliquebig, cuda_cliquek,
                                          cuda_gram)
    Q, Qp = cuda_cliquebig.quad_emit, cuda_cliquebig.quad_emit_plain
    K, Kp = cuda_cliquebig.quad_count, cuda_cliquebig.quad_count_plain
    n_cases = 0
    for w, shift in ((8, 4), (32, 4), (128, 4), (128, 0), (160, 0)):
        e, c, n = 20000, 4096, 100_000 if w < 128 else 30_000
        y2 = t(_words(rng, (e, w + shift)))[:, shift:]
        core = t(_words(rng, (c, w + shift)))[:, shift:]
        if w == 128:
            y2[:2], core[:2] = -1, -1             # 4096-quad tasks
        erow = rng.integers(-2, e + 2, n).astype(np.int32)
        c1 = rng.integers(-2, c + 2, n).astype(np.int32)
        erow[::41] = SENTINEL
        erow[n // 2:] = np.sort(erow[n // 2:])    # runs of equal erow
        erow[::997], c1[::997] = 1, 0
        n_bits = 32 * w - 5 if w != 128 else 32 * w
        what = f"random words={w} n_bits={n_bits} row shift {shift}"
        ok = (erow >= 0) & (erow < e) & (c1 >= 0) & (c1 < c)
        y = (y2.cpu().numpy()[np.where(ok, erow, 0)]
             & core.cpu().numpy()[np.where(ok, c1, 0)])
        bits = np.unpackbits(y.view(np.uint8), axis=1, bitorder="little")
        want = bits[:, :n_bits].sum(axis=1) * ok
        counts = K(y2, core, t(erow), t(c1), n_bits)
        compare("quad_count", counts, Kp(y2, core, t(erow), t(c1), n_bits),
                what)
        compare("quad_count", counts, want, f"{what} (numpy)")
        off = cuda_cliquebig.quad_offsets(counts) + (1 << 31) + 9
        args = (y2, core, t(erow), t(c1), off, n_bits, int(off[-1] -
                                                           off[0]))
        for kv, pv in zip(Q(*args), Qp(*args)):
            compare("quad_emit", kv, pv, f"{what} ({args[-1]} quads)")
        n_cases += 2
    before = (Q.launches, K.launches)
    r, _ = Q(y2, core, t(erow[:0]), t(c1[:0]), off[:1], n_bits)
    check((Q.launches, K.launches) == before and r.numel() == 0 and
          K(y2, core, t(erow[:0]), t(c1[:0]), n_bits).numel() == 0,
          "quad_emit or quad_count with no tasks launched or wrote")
    for fn, a in ((K, (y2[:, 1:-3], core[:, 1:-3], t(erow), t(c1), n_bits)),
                  (Q, (y2[:, 1:-3], core[:, 1:-3], t(erow), t(c1), off,
                       n_bits))):
        try:
            fn(*a)
        except ValueError:
            pass
        else:
            check(False, "Q took tables that are not 16-byte aligned")
    check((Q.launches, K.launches) == before,
          "quad_emit or quad_count launched on unaligned tables")
    G, Gp = cuda_gram.bit_gram, cuda_gram.bit_gram_plain
    for hw in (1, 2, 8):
        nb, nt, n = 5000, 4096, 200_003
        base = t(_words(rng, (nb, hw)))
        tab = t(_words(rng, (nt, 128)))[:, 128 - hw:]
        mask = t(_words(rng, (32 * hw - 3, hw)))
        for depth in (2, 3, 4):
            r = rng.integers(-2, nb + 2, n).astype(np.int32)
            cols = rng.integers(-2, nt + 2, (n, depth)).astype(np.int32)
            cols[::31, depth - 1] = SENTINEL
            kw = dict(r=t(r), tab=tab, cols=t(cols))
            compare("bit_gram", G(base, mask, **kw), Gp(base, mask, **kw),
                    f"random hw={hw} depth={depth} n={n}")
            n_cases += 1
    L, Lp = cuda_cliquek.lo_popcount, cuda_cliquek.lo_popcount_plain
    v, c = 20000, 4096
    bm = t(_words(rng, (v, 128)) | _words(rng, (v, 128)))
    for nrow in (5, 6, 7):
        lens = rng.choice([1, 1, 2, 3, 17, 130, 700], 300)
        first = np.concatenate([rng.integers(0, v, (lens.size, 2)),
                                rng.integers(0, c, (lens.size, nrow - 2))],
                               axis=1)
        cols = np.repeat(first, lens, axis=0)
        cols[:, -1] = rng.integers(-1, c + 1, cols.shape[0])
        runs = cuda_cliquek.lo_runs(cols.astype(np.int32), nrow - 1,
                                    device="cuda")
        compare("lo_popcount", L(bm, bm[v - c:], runs).sum(),
                Lp(bm, bm[v - c:], runs).sum(),
                f"nrow={nrow} vary_col={nrow - 1} ({runs.n_runs} runs)")
        n_cases += 1
    return n_cases + 1


def kernel_checks_cliquek14():
    """X, G and L on the rmat14 CliqueKEngine inputs at k = 4 and 5: X on
    B_hh and every slab of the slab form (ops/slab_form.py), G on the hi
    tasks and L on the lo
    tasks' run table, each against its plain version; then the count
    against phase 9's generic goldens. Returns {k: lo tasks}, which phase
    9's `clique k --fast` runs share."""
    from graphminer_tpu_torch.io.synth import rmat
    from graphminer_tpu_torch.ops import cuda_cliquek, cuda_expand, cuda_gram
    from graphminer_tpu_torch.ops.cliquek import CliqueKEngine
    from graphminer_tpu_torch.ops.slab_form import CliqueSlab
    g = rmat(14, 16, seed=7)
    n_lo = {}
    for k, want in ((4, 36_628_817), (5, 387_027_732)):
        eng = CliqueKEngine(g, k, device="cuda")
        yard = CliqueSlab(eng)
        compare_rows("expand_bits", yard.bhh, cuda_expand.expand_bits_plain(
            eng.hi_mask, n_out=eng.hi_dim), f"rmat14 k={k} B_hh")
        n_slabs = 0
        for base, kw in yard.slab_args():
            compare_rows("expand_bits", cuda_expand.expand_bits(base, **kw),
                         cuda_expand.expand_bits_plain(base, **kw),
                         f"rmat14 k={k} slab {n_slabs} ({sorted(kw)})")
            n_slabs += 1
        check(n_slabs == yard.n_slabs, f"rmat14 k={k}: {n_slabs} slabs != "
              f"{yard.n_slabs}")
        base, kw = eng.hi_args()
        compare("bit_gram", eng.hi_partials(),
                cuda_gram.bit_gram_plain(base, eng.hi_mask, **kw),
                f"rmat14 k={k} hi tasks ({eng.gram_plan.n_tiles} tiles)")
        if eng.lo_runs is not None:
            compare("lo_popcount",
                    cuda_cliquek.lo_popcount(eng.bm, eng.core,
                                             eng.lo_runs).sum(),
                    cuda_cliquek.lo_popcount_plain(eng.bm, eng.core,
                                                   eng.lo_runs).sum(),
                    f"rmat14 k={k} lo tasks")
        got = eng.count()
        check(got == want, f"rmat14 CliqueKEngine k={k}: {got} != {want}")
        say(f"rmat14 CliqueKEngine k={k}: X == plain on B_hh and {n_slabs} "
            f"slabs, G == plain on the hi tasks, L == plain on {eng.n_lo} lo "
            f"tasks; count {got} (n_core_edges {eng.n_core_edges}, n_tri "
            f"{eng.n_tri})")
        n_lo[k] = eng.n_lo
        del eng, yard
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
    from graphminer_tpu_torch.ops import cuda_gram
    compare("bit_gram", he.core_partials(),
            cuda_gram.bit_gram_plain(he.spoke, he.core_mask)[
                :he.layout.core_size],
            f"rmat14 spoke ({he.spoke.shape[0]} rows, "
            f"{he.gram_plan.n_tiles} tiles)")
    say(f"rmat14: kernel == plain on every bucket and tail group {sizes} "
        f"and as grouped launches of A, B, C and E, G on the spoke; "
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
    is taken again, DEVICE_READS readings in all. When every reading falls
    short, or CUPTI hands the profiler no device event at all
    (utils/profiling.py::device_ms reads again before it gives up), the
    device time is not measured: None, and only the launch counts are held
    (with the check that a call ran no other device op, wherever events
    came)."""
    from graphminer_tpu_torch.utils.profiling import device_ms as profiled

    def alone(f, n):
        try:
            return profiled(f, n)
        except RuntimeError as e:
            say(f"device time not measured: {e}")
            return None, None

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
        if ops is None:
            return None
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
    say(f"device time not measured: torch.profiler recorded fewer than 0.9 "
        f"{kernel} events a call in each of {DEVICE_READS} readings (the "
        f"last {rate}); the wrapper counted one launch a call in each")
    return None


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
                               ["hub_tail_count", "bit_gram"])
    x = read_counts()["expand_bits"]
    check(launches == {"hub_tail_count": 1, "bit_gram": 1} and x == 0,
          f"the hub-core count launched E and G {launches} and X {x} "
          "times, not once, once and never")
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
                             ["hub_tail_count", "fetch_rows_sum",
                              "bit_gram", "expand_bits"])
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
    # the spoke by kernel G: against its plain version, then in turns with
    # the slab form it replaced (X + torch._int_mm, the yardstick)
    from graphminer_tpu_torch.ops import cuda_gram
    from graphminer_tpu_torch.utils.profiling import gram_bounds
    compare("bit_gram", hub_eng.core_partials(),
            cuda_gram.bit_gram_plain(hub_eng.spoke, hub_eng.core_mask)[
                :lay.core_size],
            f"rmat18 spoke ({hub_eng.spoke.shape[0]} rows)")
    s_ms, slab_ms, spoke, slab = in_turns(
        lambda: hub_eng.core_partials().sum(),
        lambda: hub_eng.core_partials_slab().sum())
    check(int(spoke) == int(slab), f"spoke by G {int(spoke)} != slab form "
          f"{int(slab)}")
    gb = gram_bounds(hub_eng.spoke, hub_eng.core_mask,
                     hub_eng.gram_plan.n_tiles, cuda_gram.TILE)
    res["spoke"] = dict(ms=s_ms, slab_ms=slab_ms, bounds=gb)
    say(f"[{CARD}] spoke product by G ({hub_eng.spoke.shape[0]} rows, "
        f"{hub_eng.gram_plan.n_tiles} of {(cpad // cuda_gram.TILE) ** 2} "
        f"tiles, 1 launch): {s_ms:.3f} ms; the slab form (X + "
        f"torch._int_mm) {slab_ms:.3f} ms in turns (5.077 ms in PR 7's "
        f"run; with the torch expansion before kernel X: 25.668 ms, both "
        f"on an H100 80GB HBM3, 700 W); bound {gb['mask'][0]:.4f} ms over "
        f"the mask's set bits ({gb['mask'][1]}, {gb['ops_mask']:.4e} int8 "
        f"ops), {gb['tiles'][0]:.4f} ms over the tiles G walks, "
        f"{gb['full'][0]:.4f} ms over the full Gram; count {int(spoke)}")
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
                           ("library_ms", lib_ms)):
                tot[key] += v
            tot["device_ms"] = None if None in (d_ms, tot["device_ms"]) \
                else tot["device_ms"] + d_ms
            rate = "" if d_ms is None else \
                f", {n * w * 4 / d_ms / 1e6:.1f} GB/s"
            say(f"[{CARD}] fetch_rows_sum w={w} n={n}: kernel {k:.4f} ms "
                f"(device alone {shown(d_ms)}{rate} on {n * w * 4} "
                f"gathered bytes), plain {p:.4f} ms, "
                f"embedding_bag {lib_ms:.4f} ms, bound {b_ms:.4f} ms (bytes)")
            del t64
    res["fetch_rows_sum"] = dict(tot, bound_by="bytes")
    say(f"[{CARD}] fetch_rows_sum, 8 shapes: kernel {tot['ms']:.4f} ms, "
        f"device alone {shown(tot['device_ms'])}, bound "
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
            f"(device alone {shown(d_ms)}), plain {p:.3f} ms, bound "
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
        f"kernel {shown(dev_ms, 5)}, torch.mul {shown(lib_dev_ms, 5)}")
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
#: --fast ones (CliqueKEngine, the diamond and rectangle engines) take the
#: generic path
GENERIC_CLI = ((18, ("tc",), GOLDEN[18]),
               (14, ("clique", "4"), 36_628_817),
               (14, ("clique", "5"), 387_027_732),
               (14, ("clique", "4", "--fast"), 36_628_817),
               (14, ("clique", "5", "--fast"), 387_027_732),
               (12, ("sgl", "diamond"), 57_515_371),
               (12, ("sgl", "rectangle"), 52_988_519),
               (12, ("sgl", "diamond", "--fast"), 57_515_371),
               (12, ("sgl", "rectangle", "--fast"), 52_988_519))


def run_generic_cli(n_lo14):
    """Phase 9: `python -m graphminer_tpu_torch <verb>` on CUDA, without
    --cpu: the generic set-operation path (setops, DeviceGraph, the frontier
    engine), which launches no kernel of ours, and `clique 4|5 --fast`
    (CliqueKEngine at its defaults), which must launch G once, X never
    and, when the engine has lo tasks (`n_lo14`, phase 3's rmat14
    engines), L once."""
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
        engine = ("generic" if not fast else "CliqueKEngine"
                  if args[0] == "clique" else f"fast {args[1]}")
        say(f"[{CARD}] CLI {' '.join(args)} rmat{scale} ({engine}, cuda): "
            f"total={res['total']} run_s={res['run_s']} "
            f"load_s={res['load_s']} device_count_s="
            f"{prof['phases_s'].get('device_count')} device={prof['device']}"
            f" launches={prof['kernel_launches']} "
            f"(wall {time.perf_counter() - t1:.1f} s)")
        check(prof["device"] == "cuda", f"CLI {args} ran on {prof['device']}")
        check(res["total"] == want, f"CLI {args} rmat{scale} total "
              f"{res['total']} != {want}")
        kl = prof["kernel_launches"]
        x_l_g = [kl[k] for k in ("expand_bits", "lo_popcount", "bit_gram")]
        s_p_i_w = [kl[k] for k in ("tri_bitmap", "tri_probe", "tri_lists",
                                   "bit_colsum", "colsum_pairs",
                                   "colsum_finish")]
        if args[0] == "sgl" and fast:
            # rmat12's 4096 ids are all core: S once for the diamonds, and
            # for the 4-cycles level 0 alone: W's pairs mode once and its
            # finish once (the longest row, 1344 slots, is split)
            check((x_l_g, s_p_i_w) ==
                  (([0, 0, 0], [1, 0, 0, 0, 0, 0]) if args[1] == "diamond"
                   else ([0, 0, 0], [0, 0, 0, 0, 1, 1])),
                  f"CLI {args}: launches of X, L, G {x_l_g}, of S, P, I, "
                  f"W (write, pairs, finish) {s_p_i_w}")
        else:
            # X: never (build and count); L: once, unless the engine has no
            # lo task; G: once
            check(x_l_g == [0, int(n_lo14[int(args[1])] > 0), 1]
                  if fast else not any(x_l_g),
                  f"CLI {args}: launches of X, L and G {x_l_g}")
            check(not any(s_p_i_w), f"CLI {args}: S, P, I, W {s_p_i_w}")
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
    at k = 5, each against GOLDEN_CK: the build with its launches read from
    counts reset just before it (none of ours: X is the yardstick's),
    prep, the native enumerator, task counts and the lo run table's runs;
    the count with its launches read the same way (G once, L once when
    there are lo tasks, X never), the device count split hi / lo (CUDA
    events; the tail is the frontier's, counted at build) and the peak
    device memory of the build and count together (as PR 7 measured it)
    and of a count alone; G in turns with the slab form it replaced (X +
    torch._int_mm, ops/slab_form.py, its library_ms) beside G's bounds
    over the mask's set bits, its tiles and the full Gram, G against its
    plain version (timed at k = 4), X's and L's time beside their bounds
    and plain versions; then X against its plain version on the first and
    the last slab of the slab form and L on each engine's lo tasks.
    Returns ({kernel: timing} for X at k = 4's first slab, G at k = 4 and
    L at k = 5, {kernel: launches over the counts})."""
    from graphminer_tpu_torch.ops import cuda_cliquek, cuda_expand, cuda_gram
    from graphminer_tpu_torch.ops.cliquek import CliqueKEngine
    from graphminer_tpu_torch.ops.slab_form import CliqueSlab
    from graphminer_tpu_torch.utils.profiling import (bound_ms, gram_bounds,
                                                      time_ms as timed)
    res = {}
    launches = {"lo_popcount": 0, "bit_gram": 0}
    for k in (4, 5):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        eng, got = run_path(f"CliqueKEngine rmat18 k={k} build",
                            lambda: CliqueKEngine(g, k, device="cuda"), [])
        build_s = time.perf_counter() - t0
        built = {key: n for key, n in read_counts().items() if n}
        check(not built, f"the k={k} build launched {built}, not none")
        runs = eng.lo_runs
        say(f"CliqueKEngine rmat18 k={k}: build {build_s:.1f} s (prep "
            f"{eng.prep_s:.1f} s, {'native' if eng.native else 'numpy'} "
            f"enumerator; tail by the frontier {eng.tail_s:.1f} s, "
            f"{eng.tail_total} cliques); n_core_edges {eng.n_core_edges} "
            f"n_tri {eng.n_tri} n_lo {eng.n_lo} of {eng.n_edges} DAG edges; "
            f"hi {eng.hi_dim}, G over {eng.gram_plan.n_tiles} of "
            f"{(eng.hi_dim // cuda_gram.TILE) ** 2} tiles; lo run table: "
            f"{runs.n_runs} runs, {runs.n / runs.n_runs:.3f} tasks a run, "
            f"{runs.nbytes()} B (the task list {eng.lo_cols.numel() * 4} B)")
        path = ["bit_gram"] + (["lo_popcount"] if eng.n_lo else [])
        total, got = run_path(f"CliqueKEngine rmat18 k={k} count", eng.count,
                              path)
        both_peak = torch.cuda.max_memory_allocated()
        both_reserved = torch.cuda.memory_reserved()
        x = read_counts()["expand_bits"]
        check(total == GOLDEN_CK[k], f"rmat18 {k}-cliques {total} != "
              f"{GOLDEN_CK[k]}")
        check(got["bit_gram"] == 1 and x == 0 and
              got.get("lo_popcount", 0) == (1 if eng.n_lo else 0),
              f"the k={k} count launched {got} and X {x} times, not G and "
              "L once and X never")
        for key, n in got.items():
            launches[key] += n
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        check(eng.count() == total, f"rmat18 k={k}: a second count differs")
        say(f"CliqueKEngine rmat18 k={k}: build and count together (as PR "
            f"7 measured them): max_memory_allocated {both_peak} B, "
            f"memory_reserved {both_reserved} B; a count alone, after "
            f"empty_cache: max_memory_allocated "
            f"{torch.cuda.max_memory_allocated()} B, memory_reserved "
            f"{torch.cuda.memory_reserved()} B")
        yard = CliqueSlab(eng)
        lo_ms, lo = time_ms(lambda: eng.lo_partials().sum())
        all_ms, both = time_ms(lambda: eng.hi_partials().sum()
                               + eng.lo_partials().sum())
        check(int(both) + eng.tail_total == GOLDEN_CK[k],
              f"rmat18 k={k} hi + lo + tail")
        # G: in turns with the slab form it replaced, beside its bounds
        g_ms, slab_ms, hi, slab = in_turns(
            lambda: eng.hi_partials().sum(),
            lambda: yard.hi_partials().sum())
        check(int(hi) == int(slab), f"rmat18 k={k}: hi by G {int(hi)} != "
              f"the slab form's {int(slab)}")
        base, kw = eng.hi_args()
        gb = gram_bounds(base, eng.hi_mask, eng.gram_plan.n_tiles,
                         cuda_gram.TILE, **kw)
        t1 = time.perf_counter()
        if k == 4:
            p_ms, pv = timed(lambda: cuda_gram.bit_gram_plain(
                base, eng.hi_mask, **kw), "cuda", 1)
            res["bit_gram"] = dict(ms=g_ms, plain_ms=p_ms,
                                   bound_ms=gb["mask"][0],
                                   bound_by=gb["mask"][1],
                                   library_ms=slab_ms,
                                   tile_bound_ms=gb["tiles"][0],
                                   full_gram_bound_ms=gb["full"][0])
        else:
            pv = cuda_gram.bit_gram_plain(base, eng.hi_mask, **kw)
        compare("bit_gram", eng.hi_partials(), pv, f"rmat18 k={k} hi tasks")
        plain_s = time.perf_counter() - t1
        say(f"[{CARD}] CliqueKEngine rmat18 k={k}: count {total} (hi "
            f"{int(hi)} + lo {int(lo)} + tail {eng.tail_total}); device "
            f"count {all_ms:.3f} ms, {eng.n_core_edges / all_ms * 1e3:.4e} "
            f"core edge tasks/s; hi part by G {g_ms:.3f} ms (1 launch, "
            f"{eng.n_tri if k == 5 else eng.n_core_edges} tasks), the slab "
            f"form {slab_ms:.3f} ms in turns; G's bound "
            f"{gb['mask'][0]:.3f} ms over the mask's set bits "
            f"({gb['mask'][1]}, {gb['ops_mask']:.4e} int8 ops), "
            f"{gb['tiles'][0]:.3f} ms over its {eng.gram_plan.n_tiles} "
            f"tiles, "
            f"{gb['full'][0]:.3f} ms over the full Gram; G == plain "
            f"({plain_s:.1f} s with the plain version); lo {lo_ms:.4f} ms")
        slabs = list(yard.slab_args())
        if k == 4:
            base, kw = slabs[0]
            kx, px, yt, pv = in_turns(
                lambda: cuda_expand.expand_bits(base, **kw),
                lambda: cuda_expand.expand_bits_plain(base, **kw))
            compare_rows("expand_bits", yt, pv, f"rmat18 k=4 slab 0 of "
                         f"{len(slabs)} ({sorted(kw)})")
            xb = bound_ms(x_bytes(base, kw, yt))
            res["expand_bits"] = dict(ms=kx, plain_ms=px, bound_ms=xb[0],
                                      bound_by=xb[1], library_ms=None)
            say(f"[{CARD}] expand_bits, the slab form's first k=4 slab "
                f"[{yt.shape[0]}, {yt.shape[1]}]: kernel {kx:.4f} ms, plain "
                f"{px:.3f} ms, bound {xb[0]:.4f} ms ({xb[1]})")
            del yt, pv
        # X == plain on the first and the last slab of the slab form (the
        # last is the one with padding rows)
        for i in sorted({0, len(slabs) - 1}):
            base, kw = slabs[i]
            compare_rows("expand_bits", cuda_expand.expand_bits(base, **kw),
                         cuda_expand.expand_bits_plain(base, **kw),
                         f"rmat18 k={k} slab {i} of {len(slabs)} "
                         f"({sorted(kw)})")
        if eng.n_lo:
            kl, pl, kv, pv = in_turns(
                lambda: cuda_cliquek.lo_popcount(eng.bm, eng.core, runs),
                lambda: cuda_cliquek.lo_popcount_plain(eng.bm, eng.core,
                                                       runs))
            compare("lo_popcount", kv.sum(), pv.sum(),
                    f"rmat18 k={k} lo tasks")
            nbytes = lo_bytes(eng, kv.numel())
            lb = bound_ms(nbytes)
            rb = bound_ms(nbytes - eng.lo_cols.numel() * 4 + runs.nbytes())
            if k == 5:
                res["lo_popcount"] = dict(ms=kl, plain_ms=pl, bound_ms=rb[0],
                                          bound_by=rb[1], library_ms=None,
                                          task_list_bound_ms=lb[0])
            say(f"[{CARD}] lo_popcount rmat18 k={k} ({eng.n_lo} lo tasks in "
                f"{runs.n_runs} runs, 1 launch): kernel {kl:.4f} ms (PR 7's "
                f"first design: {PR7_L_MS[k]} ms on an H100 80GB HBM3, "
                f"700 W), plain {pl:.3f} ms, bound {rb[0]:.4f} ms ({rb[1]}, "
                f"over the run table's bytes; {lb[0]:.4f} ms over the task "
                f"list's, {nbytes} B, which L no longer reads)")
        del eng, yard
    torch.cuda.empty_cache()
    check(set(res) == {"expand_bits", "lo_popcount", "bit_gram"},
          f"phase 13 timed only {sorted(res)}")
    return res, launches


# --------------------------------------------------------------------------
# phase 14: the large-clique engine (k >= 6)
# --------------------------------------------------------------------------

def big_count(label, eng, want, min_tris=None):
    """One CliqueBigEngine count with every launch count at 0 before it (the
    k = 6 path forced by DEV6_MIN_TRIS = min_tris when given): the golden,
    one launch of G a hi dispatch, of L a lo dispatch, of Q's emit a chunk
    and of Q's count a count on the device path, and none of another
    kernel, and the count's statistics (the host split of its hi part
    included). Returns the launches."""
    if min_tris is not None:
        eng.DEV6_MIN_TRIS = min_tris
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    total, _ = run_path(label, eng.count, ["bit_gram"])
    peak = torch.cuda.max_memory_allocated()
    got = read_counts()
    d = {key: eng.dispatches.get(key, 0) for key in ("hi", "lo", "quad")}
    check(total == want, f"{label}: {total} != {want}")
    want_launches = {"bit_gram": d["hi"], "lo_popcount": d["lo"],
                     "quad_emit": d["quad"],
                     "quad_count": int(eng.path == "device")}
    check(got == {key: want_launches.get(key, 0) for key in got},
          f"{label}: launches {got}, dispatches {d}")
    check((d["quad"] > 0) == (eng.path == "device") and
          (d["lo"] > 0) == (eng.n_lo_tasks > 0),
          f"{label}: path {eng.path}, dispatches {d}, lo tasks "
          f"{eng.n_lo_tasks}")
    ms = eng.kernel_ms
    say(f"[{CARD}] {label}: count {total} (hi {eng.hi_total} + lo "
        f"{eng.lo_total} + tail {eng.tail_total}), path {eng.path}; prep "
        f"{eng.prep_s:.3f} s, tail {eng.tail_s:.3f} s; count "
        f"{eng.count_s:.3f} s (host s: " + ", ".join(
            f"{k} {v:.3f}" for k, v in eng.stream_s.items())
        + f"); hi tasks {eng.n_hi_tasks}, "
        f"lo tasks {eng.n_lo_tasks}, triangle tasks {eng.n_tri_tasks}; "
        f"launches G {d['hi']}, L {d['lo']}, Q "
        f"{d['quad']}; device ms (CUDA events) hi {ms.get('hi', 0.0):.3f}, "
        f"lo {ms.get('lo', 0.0):.3f}, Q {ms.get('quad', 0.0):.3f}; "
        f"max_memory_allocated {peak} B")
    return got


def build_big(g, k, label):
    """CliqueBigEngine(g, k) on the card; its build launches no kernel of
    ours."""
    from graphminer_tpu_torch.ops.cliquebig import CliqueBigEngine
    eng, _ = run_path(f"{label} build",
                      lambda: CliqueBigEngine(g, k, device="cuda"), [])
    built = {key: n for key, n in read_counts().items() if n}
    check(not built, f"the {label} build launched {built}, not none")
    return eng


def run_cliquebig():
    """Phase 14: CliqueBigEngine against GOLDEN_BIG. rmat14 k = 6 on the
    host-streamed path and on the device path (Q + G), forced, with the
    same hi tasks; Q, G and L against their plain versions on the device
    path's first chunk and first lo dispatch, Q timed there beside its
    bound; rmat12 k = 7, also with small dispatches (many refills of the
    pinned buffers under asynchronous copies), and k = 8, also through the
    native DFS counter (kclique_dfs); rmat16 k = 6 on the path the engine
    picks. Returns ({"quad_emit": timing, "quad_count": timing},
    {kernel: launches})."""
    from graphminer_tpu_torch import native_bridge
    from graphminer_tpu_torch.io.synth import rmat
    from graphminer_tpu_torch.ops import (cliquebig, cuda_cliquebig,
                                          cuda_cliquek, cuda_gram)
    from graphminer_tpu_torch.utils.profiling import (bound_ms, quad_bytes,
                                                      quad_count_bytes,
                                                      time_ms as timed)
    t_phase = time.perf_counter()
    launches = {"bit_gram": 0, "lo_popcount": 0, "quad_emit": 0,
                "quad_count": 0}

    def add(got):
        for key in launches:
            launches[key] += got[key]

    eng = build_big(rmat(14, 16, seed=7), 6, "CliqueBigEngine rmat14 k=6")
    want = GOLDEN_BIG[(14, 6)]
    add(big_count("rmat14 k=6, host-streamed path", eng, want, 1 << 62))
    n_hi = eng.n_hi_tasks
    add(big_count("rmat14 k=6, device path (DEV6_MIN_TRIS = 0)", eng, want,
                  0))
    check(eng.n_hi_tasks == n_hi, f"rmat14 k=6: {eng.n_hi_tasks} hi tasks "
          f"on the device path, {n_hi} on the host path")
    # Q, G and L against their plain versions on the device path's inputs
    chunks = list(eng.quad_chunks())
    args = chunks[0]
    y2full, _, erow, c1, _, n_bits, nq = args
    # Q's count over all the count's triangle tasks, as the engine launches
    # it, against its plain version and the chunks' offsets
    erow_all = torch.cat([ch[2] for ch in chunks])
    c1_all = torch.cat([ch[3] for ch in chunks])
    off_all = torch.cat([chunks[0][4][:1]] + [ch[4][1:] for ch in chunks])
    kc = cuda_cliquebig.quad_count(y2full, eng.core, erow_all, c1_all,
                                   n_bits)
    compare("quad_count", kc, cuda_cliquebig.quad_count_plain(
        y2full, eng.core, erow_all, c1_all, n_bits),
        f"rmat14 k=6, all {erow_all.numel()} triangle tasks")
    compare("quad_count", cuda_cliquebig.quad_offsets(kc),
            off_all - off_all[0], "rmat14 k=6, the chunks' offsets")
    r, cols = cuda_cliquebig.quad_emit(*args)
    rp, cp = cuda_cliquebig.quad_emit_plain(*args)
    compare("quad_emit", r, rp, f"rmat14 k=6 first chunk ({nq} quads)")
    compare("quad_emit", cols, cp, f"rmat14 k=6 first chunk ({nq} quads)")
    del rp, cp
    gk = dict(r=r, tab=eng.core_hi, cols=cols)
    compare("bit_gram",
            cuda_gram.bit_gram(eng.y2hi, eng.hi_mask, plan=eng.gram_plan,
                               **gk),
            cuda_gram.bit_gram_plain(eng.y2hi, eng.hi_mask, **gk),
            f"rmat14 k=6 the first chunk's {nq} quads")
    lo = next(eng.lo_tasks(), None)
    check(lo is not None, "rmat14 k=6: no lo dispatch")
    runs = cuda_cliquek.lo_runs(lo, lo.shape[1] - 1, device="cuda")
    compare("lo_popcount",
            cuda_cliquek.lo_popcount(eng.bm, eng.core, runs).sum(),
            cuda_cliquek.lo_popcount_plain(eng.bm, eng.core, runs).sum(),
            f"rmat14 k=6 first lo dispatch ({runs.n} tasks)")
    del r, cols, gk
    kq, _ = time_ms(lambda: cuda_cliquebig.quad_emit(*args))
    pq, _ = timed(lambda: cuda_cliquebig.quad_emit_plain(*args), "cuda", 1)
    nbytes = quad_bytes(y2full, eng.core, erow, c1, nq)
    qb = bound_ms(nbytes)
    count_args = (y2full, eng.core, erow_all, c1_all, n_bits)
    kk, _ = time_ms(lambda: cuda_cliquebig.quad_count(*count_args))
    pk, _ = timed(lambda: cuda_cliquebig.quad_count_plain(*count_args),
                  "cuda", 1)
    cbytes = quad_count_bytes(*count_args[:4])
    cb = bound_ms(cbytes)
    res = {"quad_emit": dict(ms=kq, plain_ms=pq, bound_ms=qb[0],
                             bound_by=qb[1], library_ms=None),
           "quad_count": dict(ms=kk, plain_ms=pk, bound_ms=cb[0],
                              bound_by=cb[1], library_ms=None)}
    say(f"[{CARD}] quad_emit, rmat14 k=6 first chunk ({erow.numel()} "
        f"triangle tasks, {nq} quads, 1 launch): kernel {kq:.4f} ms (first "
        f"design, recorded in PERF.md: {FIRST_Q_MS} ms), plain {pq:.3f} "
        f"ms, bound {qb[0]:.4f} ms ({qb[1]}, {nbytes} B)")
    say(f"[{CARD}] quad_count, rmat14 k=6 all {erow_all.numel()} triangle "
        f"tasks (1 launch): kernel {kk:.4f} ms, plain {pk:.3f} ms, bound "
        f"{cb[0]:.4f} ms ({cb[1]}, {cbytes} B)")
    del args, count_args, chunks, y2full, erow, c1, erow_all, c1_all
    del off_all, kc, eng

    g12 = rmat(12, 16, seed=7)
    for k in (7, 8):
        eng = build_big(g12, k, f"CliqueBigEngine rmat12 k={k}")
        add(big_count(f"rmat12 k={k}", eng, GOLDEN_BIG[(12, k)]))
        if k == 7:
            n_disp = eng.dispatches["hi"]
            default = cliquebig.DISPATCH_TASKS
            cliquebig.DISPATCH_TASKS = 1 << 21
            try:
                add(big_count("rmat12 k=7, 2^21 tasks a dispatch", eng,
                              GOLDEN_BIG[(12, 7)]))
            finally:
                cliquebig.DISPATCH_TASKS = default
            check(eng.dispatches["hi"] > 4 * n_disp,
                  f"small dispatches: {eng.dispatches} (default {n_disp})")
        del eng
    rg = g12.relabel_by_degree(descending=False).orientation()
    t0 = time.perf_counter()
    dfs = native_bridge.kclique_dfs(rg.rowptr, rg.colidx, 8)
    check(dfs == GOLDEN_BIG[(12, 8)], f"kclique_dfs rmat12 k=8: {dfs}")
    say(f"kclique_dfs rmat12 k=8 (native DFS, no code shared with the "
        f"engine): {dfs} in {time.perf_counter() - t0:.2f} s")

    eng = build_big(rmat(16, 16, seed=7), 6, "CliqueBigEngine rmat16 k=6")
    add(big_count("rmat16 k=6, the engine's path", eng, GOLDEN_BIG[(16, 6)]))
    del eng
    torch.cuda.empty_cache()
    say(f"phase 14 (large cliques): {time.perf_counter() - t_phase:.1f} s")
    return res, launches


# --------------------------------------------------------------------------
# phase 15: the fast SgL engines (diamond and rectangle)
# --------------------------------------------------------------------------

#: rmat(18, 16, seed=7) diamonds (BENCH_r05.json, diamond_count_rmat18)
GOLDEN_DIAMOND18 = 45_873_513_836
#: rmat(scale, 16, seed=7) 4-cycles (bench.py:82-85)
GOLDEN_RECT = {12: 52_988_519, 13: 172_972_822, 14: 571_816_674,
               18: 51_349_430_411}
SGL_KERNELS = ("tri_bitmap", "tri_probe", "tri_lists", "bit_colsum",
               "colsum_pairs", "colsum_finish")
#: a segment cut that splits most rows of rmat14 (the finish checked at
#: scale)
FORCED_CUT = 64


def sgl_inputs(g, core=4096):
    """The arguments that tri_support gives kernels S, P and I (all tasks,
    the sc tasks, the ss tasks), the rectangle engine's level-0 plan for
    W's pairs mode, and the pieces of the product-form yardstick (the
    Gram's rows, FT lists for W's write mode), built as the engines build
    them, on the card."""
    from types import SimpleNamespace
    from graphminer_tpu_torch.ops import tri_support as ts
    from graphminer_tpu_torch.ops.cuda_colsum import plan_pairs
    from graphminer_tpu_torch.ops.cuda_tri import FtLists
    rg = g.relabel_by_degree(descending=False)
    c, cs, words = ts.core_split(rg, core)
    table = torch.from_numpy(ts._pack_full_core_bitmaps(rg, cs, words)).cuda()
    deg, core_nb = ts.core_neighbours(rg, cs)
    ftw = deg - core_nb
    ft = FtLists.from_csr(rg.rowptr, rg.colidx, ftw, "cuda")
    src, dst = rg.orientation().edge_list()
    src, dst = src.astype(np.int64), dst.astype(np.int64)
    t = lambda a: torch.from_numpy(a.astype(np.int32)).cuda()
    cc = src >= cs
    sc, ss = ~cc & (dst >= cs), ~cc & (dst < cs)
    keep = np.nonzero((core_nb >= 2) & (np.arange(rg.n_vertices) < cs))[0]
    u = torch.arange(rg.n_vertices, dtype=torch.int32, device="cuda")
    plan = lambda cut=None: plan_pairs(
        ft.rowptr, ft.colidx, u, cs, c, *([cut] if cut else []))
    return SimpleNamespace(
        c=c, cs=cs, words=words, table=table, ft=ft, keep=keep,
        s=(table, t(src), t(dst)), p=(ft, table, t(src[sc]), t(dst[sc] - cs)),
        i=(ft, t(src[ss]), t(dst[ss])), plan=plan(), plan_at=plan,
        w_chunks=sum(bool(ftw[a:min(cs, a + 4096)].any())
                     for a in range(0, cs, 4096)),
        n_tasks=(int(src.size), int(sc.sum()), int(ss.sum())))


def w_args(inp, last=True):
    """Kernel W's write-mode arguments on one case-B chunk of CHUNK_U
    sub-core u of the yardstick, the last (densest) or the first."""
    from graphminer_tpu_torch.ops.slab_form import CHUNK_U
    a = max(0, inp.cs - CHUNK_U) if last else 0
    u = torch.arange(a, min(inp.cs, a + CHUNK_U), dtype=torch.int32,
                     device="cuda")
    return inp.ft, inp.table, u


def yardstick(inp):
    """Level 0 by the product form W's pairs mode replaced."""
    from graphminer_tpu_torch.ops.slab_form import rectangle_level0_slab
    return rectangle_level0_slab(inp.table, inp.ft, inp.cs, inp.c, inp.keep)


def profiled_count(label, fn, want):
    """Two more calls of fn() under torch.profiler (device activity only),
    the first its warm-up step and the second the one it records: their
    value must be `want`; prints the recorded call's host seconds, the
    device time of its events and their share of the call (the device-busy
    share), then the peak device memory of one more call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, schedule
    torch.cuda.synchronize()
    recorded = []
    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1),
                 on_trace_ready=lambda p: recorded.append(p.events())) as prof:
        check(fn() == want, f"{label}: the warm-up count")
        torch.cuda.synchronize()
        prof.step()
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        host = time.perf_counter() - t0
        prof.step()
    check(got == want, f"{label}: {got} != {want}")
    check(len(recorded) == 1, f"{label}: {len(recorded)} profiler cycles")
    dev = [e for e in recorded[0] if e.device_type == DeviceType.CUDA]
    us = sum(e.time_range.elapsed_us() for e in dev)
    by = {}
    for e in dev:
        by[e.name[:40]] = by.get(e.name[:40], 0) + e.time_range.elapsed_us()
    top = sorted(by.items(), key=lambda kv: -kv[1])[:6]
    torch.cuda.reset_peak_memory_stats()
    check(fn() == want, f"{label}: a second count")
    device = (f"device {us / 1e3:.3f} ms in {len(dev)} events, busy "
              f"{us / 1e6 / host:.4f}; top: " +
              ", ".join(f"{k} {v / 1e3:.3f} ms" for k, v in top)) if dev \
        else "device time and busy share not measured (torch.profiler " \
        "recorded no device event)"
    say(f"[{CARD}] {label} (profiled): host {host:.3f} s, {device}; "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} B")


def pairs_random():
    """W's pairs mode on a random table (bit 31 in every row) and CSR (ids
    outside the table, rows of degree 0 and 1, one row of 3000 slots) at
    8, 40 and 128 words, unsplit and split."""
    from graphminer_tpu_torch.ops import cuda_colsum as cc
    rng = np.random.default_rng(15)
    for w, cut in ((8, 4096), (40, 64), (128, 4096), (128, 1024)):
        v = 3000
        tab = torch.from_numpy(_words(rng, (v, w))).cuda()
        tab[:, -1] |= -2**31
        deg = rng.integers(0, 151, v)
        deg[:5] = [0, 1, 0, 1, 3000]
        rowptr = torch.from_numpy(np.concatenate(
            [[0], np.cumsum(deg)]).astype(np.int64)).cuda()
        colidx = torch.from_numpy(rng.integers(
            -2, v + 2, int(deg.sum())).astype(np.int32)).cuda()
        u = torch.arange(-1, v + 1, dtype=torch.int32, device="cuda")
        plan = cc.plan_pairs(rowptr, colidx, u, v // 2, 32 * w - 5, cut)
        pairs_checks(plan, tab, f"random {w} words, cut {cut}")


def pairs_checks(plan, tab, label):
    """colsum_pairs and, for a plan that splits rows, colsum_finish held
    to their plain versions, and the whole count to the plain one."""
    from graphminer_tpu_torch.ops import cuda_colsum as cc
    total, counts = cc.colsum_pairs(plan, tab)
    want_t, want_c = cc.colsum_pairs_plain(plan, tab)
    what = (f"{label}, {plan.items.shape[0]} segments, "
            f"{plan.long_u.shape[0]} split rows")
    compare("colsum_pairs", total, want_t, what)
    compare("colsum_pairs", counts, want_c, f"{what}: split rows' counts")
    if plan.long_u.shape[0]:
        compare("colsum_finish", cc.colsum_finish(plan, counts, total),
                cc.colsum_finish_plain(plan, want_c, want_t), what)


def sp_runs_checks():
    """S, P and I against their plain versions on random tables (bit 31 in
    every word, 128 words) with tasks in sorted runs of 150-300 (longer
    than the kernels' windows), ids outside [0, V) inside the runs, values
    ascending in each run, P's bits at sector edges (31/32, 255/256, the
    last bit, just outside [0, 32 words)) and lists up to 160 slots; I also
    on lists up to 1,500 ids, half its runs' u and w among those."""
    from graphminer_tpu_torch.ops import cuda_tri
    rng = np.random.default_rng(13)
    v, w, n = 20000, 128, 400_000
    dev = torch.device("cuda")
    tab = _words(rng, (v, w)) | np.int32(-2**31)
    lens = rng.integers(150, 301, n // 150 + 1)
    ids = np.repeat(np.sort(rng.integers(0, v, lens.size)), lens)[:n]
    ids[7::131], ids[11::173], ids[13::197] = -1, v, 2**31 - 1
    run = np.cumsum(np.r_[True, ids[1:] != ids[:-1]])
    in_runs = lambda x: x[np.lexsort((x, run))].astype(np.int32)
    vl = rng.integers(0, 32 * w, n)
    vl[::3] = rng.choice([0, 31, 32, 255, 256, 32 * w - 1, -1, 32 * w],
                         vl[::3].size)
    deg = rng.integers(0, 161, v)
    rowptr = np.concatenate([[0], np.cumsum(deg)])
    colidx = np.concatenate([np.sort(rng.choice(v, d, replace=False))
                             for d in deg]).astype(np.int32)
    ft = cuda_tri.FtLists.from_csr(rowptr, colidx, deg, dev)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(
        a, dtype=np.int32)).to(dev)
    s = (t(tab), t(ids), t(in_runs(rng.integers(-3, v + 3, n))))
    p = (ft, s[0], t(ids), t(in_runs(vl)))
    for name, fn, plain, args, loads in (
            ("tri_bitmap", cuda_tri.tri_bitmap, cuda_tri.tri_bitmap_plain,
             s, cuda_tri.bitmap_loads(*s)),
            ("tri_probe", cuda_tri.tri_probe, cuda_tri.tri_probe_plain, p,
             cuda_tri.probe_loads(*p))):
        compare(name, fn(*args), plain(*args),
                f"sorted long runs, {n} tasks, {loads['runs']} runs")
        say(f"{name} == plain on sorted long runs: {loads}")
    # I: a CSR with 300 long rows (600-1,500 ids)
    n = 100_000
    long_v = rng.choice(v, 300, replace=False)
    deg[long_v] = rng.integers(600, 1501, 300)
    rowptr = np.concatenate([[0], np.cumsum(deg)])
    colidx = np.concatenate([np.sort(rng.choice(v, d, replace=False))
                             for d in deg]).astype(np.int32)
    ft = cuda_tri.FtLists.from_csr(rowptr, colidx, deg, dev)
    lens = rng.integers(150, 301, n // 150 + 1)
    heads = np.where(rng.random(lens.size) < 0.5,
                     rng.choice(long_v, lens.size),
                     rng.integers(0, v, lens.size))
    ids = np.repeat(np.sort(heads), lens)[:n]
    ids[7::131], ids[11::173], ids[13::197] = -1, v, 2**31 - 1
    run = np.cumsum(np.r_[True, ids[1:] != ids[:-1]])
    ws = np.where(rng.random(n) < 0.5, rng.choice(long_v, n),
                  rng.integers(-3, v + 3, n))
    i = (ft, t(ids), t(ws[np.lexsort((ws, run))]))
    loads = cuda_tri.list_loads(*i)
    check(int(ft.lengths(i[1])[1].max()) > 1000, "tri_lists: no long list")
    compare("tri_lists", cuda_tri.tri_lists(*i), cuda_tri.tri_lists_plain(*i),
            f"sorted long runs, lists up to 1,500 ids, {n} tasks")
    say(f"tri_lists == plain on sorted long runs, lists up to 1,500 ids: "
        f"{loads}")


def sgl_kernel_checks(inp, label):
    """S, P and I against their plain versions on every task class of
    `inp`, W's write mode on the yardstick's last and first case-B chunk,
    and its pairs mode on the level-0 plan and on one with FORCED_CUT."""
    from graphminer_tpu_torch.ops import cuda_colsum, cuda_tri
    for name, fn, plain, args in (
            ("tri_bitmap", cuda_tri.tri_bitmap, cuda_tri.tri_bitmap_plain,
             inp.s),
            ("tri_probe", cuda_tri.tri_probe, cuda_tri.tri_probe_plain,
             inp.p),
            ("tri_lists", cuda_tri.tri_lists, cuda_tri.tri_lists_plain,
             inp.i)):
        compare(name, fn(*args), plain(*args),
                f"{label}, {args[-1].numel()} tasks")
    for last in (True, False):
        a = w_args(inp, last)
        compare("bit_colsum", cuda_colsum.bit_colsum(*a),
                cuda_colsum.bit_colsum_plain(*a),
                f"{label}, case-B chunk of {a[-1].numel()} u "
                f"({'last' if last else 'first'})")
    pairs_checks(inp.plan, inp.table, f"{label} level 0")
    forced = inp.plan_at(FORCED_CUT)
    check(forced.long_u.shape[0] > inp.plan.long_u.shape[0],
          f"{label}: cut {FORCED_CUT} splits no more rows")
    pairs_checks(forced, inp.table, f"{label} level 0, cut {FORCED_CUT}")


def sp_loads(inp):
    """What S, P and I load at rmat18 under their designs (cuda_tri's
    bitmap_loads, probe_loads and list_loads): S's runs, windows and src
    rows against the first design's two rows a task; P's runs, lists and
    32-byte sector requests (its warps' and once a run) against one probe a
    list slot a task; I's runs, shorter-list ids, rounds, search loads and
    sector requests, and its dependent loads against the first design's."""
    from graphminer_tpu_torch.ops import cuda_tri
    s = cuda_tri.bitmap_loads(*inp.s)
    say(f"S rmat18 ({cuda_tri.S_WINDOW} tasks a warp): {s['runs']} runs of "
        f"equal src, {s['windows']} windows, {s['src_rows']} src rows and "
        f"{s['dst_rows']} dst rows loaded, {s['row_bytes']} B (first "
        f"design: {2 * s['dst_rows']} rows, "
        f"{2 * s['dst_rows'] * 4 * inp.words} B)")
    p = cuda_tri.probe_loads(*inp.p)
    once = cuda_tri.probe_loads(*inp.p, window=None)
    say(f"P rmat18 ({cuda_tri.P_WINDOW} tasks a warp): {p['runs']} runs of "
        f"equal u, {p['lists']} lists read ({p['list_ids']} ids; once a run "
        f"{once['lists']}, {once['list_ids']} ids), {p['sectors']} 32-byte "
        f"sector requests (once a run {once['sectors']}; 18,346,857 "
        f"expected) against {p['probes']} one-word probes")
    i = cuda_tri.list_loads(*inp.i)
    say(f"I rmat18 ({cuda_tri.I_LANES} lanes a task, {cuda_tri.I_IDS} ids a "
        f"lane a round): {i['runs']} runs of equal u, {i['short_ids']} ids "
        f"of the shorter lists in {i['rounds']} rounds, {i['search_loads']} "
        f"search loads, {i['sectors']} 32-byte sector requests, "
        f"{i['chain']} dependent loads (first design: "
        f"{i['first_chain']})")


def sgl_timing(inp):
    """S, P, I and W's write mode (on the yardstick's last case-B chunk),
    pairs mode and finish at rmat18 beside their bounds and plain versions;
    level 0 by the pairs mode in turns with the product-form yardstick
    (the pairs row's library_ms); the yardstick's Gram and case B beside
    their int8 operation bounds."""
    from graphminer_tpu_torch.ops import cuda_colsum as cc
    from graphminer_tpu_torch.ops import cuda_tri, slab_form
    from graphminer_tpu_torch.ops import tri_support as ts
    from graphminer_tpu_torch.ops.cuda_expand import expand_bits
    from graphminer_tpu_torch.utils import profiling as pf
    res = {}
    wa = w_args(inp)
    plan, table = inp.plan, inp.table
    counts = torch.zeros((plan.long_u.shape[0], 32 * inp.words),
                         dtype=torch.int32, device="cuda")
    total = torch.zeros(1, dtype=torch.int64, device="cuda")
    for name, fn, plain, args, n, nbytes in (
            ("tri_bitmap", cuda_tri.tri_bitmap, cuda_tri.tri_bitmap_plain,
             inp.s, inp.n_tasks[0], pf.tri_bitmap_bytes(*inp.s)),
            ("tri_probe", cuda_tri.tri_probe, cuda_tri.tri_probe_plain,
             inp.p, inp.n_tasks[1], pf.tri_probe_bytes(*inp.p)),
            ("tri_lists", cuda_tri.tri_lists, cuda_tri.tri_lists_plain,
             inp.i, inp.n_tasks[2], pf.tri_lists_bytes(*inp.i)),
            ("bit_colsum", cc.bit_colsum, cc.bit_colsum_plain, wa,
             wa[-1].numel(), pf.colsum_bytes(*wa)),
            ("colsum_pairs", cc.colsum_pairs, cc.colsum_pairs_plain,
             (plan, table), plan.items.shape[0],
             pf.colsum_pairs_bytes(plan, table)),
            ("colsum_finish", cc.colsum_finish, cc.colsum_finish_plain,
             (plan, counts, total), plan.long_u.shape[0],
             4 * counts.numel() + 4 * plan.long_u.numel() + 8)):
        k_ms, kv = time_ms(lambda: fn(*args))
        p_ms, pv = pf.time_ms(lambda: plain(*args), "cuda", 1)
        if name in ("tri_bitmap", "tri_probe", "tri_lists"):
            compare(name, kv, pv, f"rmat18, {n} tasks")
        b = pf.bound_ms(nbytes)
        res[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b[0],
                         bound_by=b[1], library_ms=None)
        say(f"[{CARD}] {name} rmat18 ({n} tasks, 1 launch): "
            f"kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms, bound {b[0]:.4f} "
            f"ms ({b[1]}, {nbytes} B)")
    sp_loads(inp)
    # level 0 whole: the pairs mode (pairs + finish) in turns with the
    # product form it replaced
    l0_ms, y_ms, l0, y = in_turns(lambda: cc.pairs_count(plan, table),
                                  lambda: yardstick(inp))
    check(l0 == y, f"rmat18 level 0: pairs mode {l0} != yardstick {y}")
    res["colsum_pairs"].update(library_ms=y_ms, level0_ms=l0_ms)
    say(f"[{CARD}] rectangle level 0 rmat18 (cases A + B = {l0}): W's "
        f"pairs mode (pairs + finish, {plan.items.shape[0]} segments, "
        f"{plan.long_u.shape[0]} split rows, cut {plan.cut}, scratch "
        f"{counts.numel() * 4} B) {l0_ms:.4f} ms, the product-form "
        f"yardstick {y_ms:.3f} ms (in turns)")
    cpad = 32 * inp.words
    g_ms, _ = time_ms(lambda: ts.gram_rows(inp.table, inp.keep, inp.words))
    ops = 2 * cpad * cpad * inp.keep.size
    b = pf.bound_ms(inp.keep.size * inp.words * 4 + 4 * cpad * cpad, ops)
    say(f"[{CARD}] yardstick's Gram (X + torch._int_mm) rmat18, "
        f"{inp.keep.size} rows: {g_ms:.4f} ms, bound {b[0]:.4f} ms ({b[1]}, "
        f"{ops:.4e} int8 operations)")
    acc = inp.table[inp.cs:]
    m = torch.triu(expand_bits(acc, n_out=cpad), diagonal=1)
    b_ms, _ = time_ms(lambda: slab_form._case_b(
        inp.table, inp.ft, m, inp.cs, inp.c, slab_form.CHUNK_U))
    ops = 2 * inp.cs * cpad * cpad
    b = pf.bound_ms(0, ops)
    say(f"[{CARD}] yardstick's case B (X + torch._int_mm + W's write mode, "
        f"{inp.w_chunks} chunks) rmat18, {inp.cs} sub-core u: {b_ms:.3f} "
        f"ms, bound {b[0]:.4f} ms ({b[1]}, {ops:.4e} int8 operations)")
    return res


class CountIntMm:
    """Counts torch._int_mm calls while it is active."""

    def __enter__(self):
        self.calls, self.real = 0, torch._int_mm

        def counted(*a):
            self.calls += 1
            return self.real(*a)
        torch._int_mm = counted
        return self

    def __exit__(self, *exc):
        torch._int_mm = self.real


def run_sgl(g18):
    """Phase 15: the diamond (tri_support) and rectangle engines against
    their goldens, S, P, I, W's write and pairs modes against their plain
    versions (every rmat14 task class and yardstick chunk, random pairs
    inputs, the rmat14 level-0 plan and a forced split; S, P and I also on
    random sorted long runs and at rmat18), launch counts (S,
    P, I once a tri_support call; W's pairs mode once a rectangle count and
    its finish once when the level splits a row; no W write mode, X or
    torch._int_mm from the rectangle engine), the counts' host seconds,
    device ms, busy share and peak memory, and the kernels timed at rmat18
    (with what S, P and I load). Returns (timings, {kernel: launches})."""
    from graphminer_tpu_torch.io.synth import rmat
    from graphminer_tpu_torch.ops import rectangle as rc
    from graphminer_tpu_torch.ops import tri_support as ts
    from graphminer_tpu_torch.ops.cuda_colsum import pairs_count
    t_phase = time.perf_counter()
    launches = dict.fromkeys(SGL_KERNELS, 0)
    spi = list(SGL_KERNELS[:3])

    def support(label, g, want_tri):
        t0 = time.perf_counter()
        out, _ = run_path(label, lambda: ts.tri_support(g, device="cuda"),
                          spi)
        host = time.perf_counter() - t0
        got = read_counts()
        check([got[k] for k in SGL_KERNELS] == [1, 1, 1, 0, 0, 0],
              f"{label}: launches {got}")
        for k in spi:
            launches[k] += 1
        check(int(out.tri.sum()) == 3 * want_tri,
              f"{label}: sum of tri {int(out.tri.sum())} != 3 x {want_tri}")
        return out, host

    pairs_random()
    g14 = rmat(14, 16, seed=7)
    inp14 = sgl_inputs(g14)
    sgl_kernel_checks(inp14, "rmat14")
    sp_runs_checks()
    support("tri_support rmat14", g14, GOLDEN[14])
    ts18, host = support("tri_support rmat18", g18, GOLDEN[18])
    diamonds = ts.pairs_sum(ts18.tri)
    check(diamonds == GOLDEN_DIAMOND18,
          f"diamonds rmat18 {diamonds} != {GOLDEN_DIAMOND18}")
    say(f"[{CARD}] diamonds rmat18: {diamonds} (tri_support host {host:.3f}"
        f" s)")
    del ts18
    profiled_count("diamond_count_fast rmat18",
                   lambda: ts.diamond_count_fast(g18, device="cuda"),
                   GOLDEN_DIAMOND18)
    inp18 = sgl_inputs(g18)
    say(f"rmat18 tri_support tasks (all, sc, ss): {inp18.n_tasks}; Gram "
        f"rows {inp18.keep.size}; level-0 segments "
        f"{inp18.plan.items.shape[0]}, split rows "
        f"{inp18.plan.long_u.shape[0]}; yardstick case-B chunks with sub "
        f"neighbours {inp18.w_chunks}")
    for scale in (12, 13, 14, 18):
        g = {14: g14, 18: g18}.get(scale) or rmat(scale, 16, seed=7)
        plan = (inp14 if scale == 14 else inp18 if scale == 18 else
                sgl_inputs(g)).plan
        finish = int(plan.long_u.shape[0] > 0)
        t0 = time.perf_counter()
        with CountIntMm() as mm:
            total, _ = run_path(
                f"rectangle rmat{scale}",
                lambda: rc.rectangle_count_fast(g, device="cuda"),
                ["colsum_pairs"] + ["colsum_finish"] * finish)
        host = time.perf_counter() - t0
        got = read_counts()
        check([got[k] for k in SGL_KERNELS] == [0, 0, 0, 0, 1, finish]
              and got["expand_bits"] == 0 and mm.calls == 0,
              f"rectangle rmat{scale}: launches {got}, torch._int_mm "
              f"{mm.calls}; want W's pairs mode once and its finish "
              f"{finish}")
        launches["colsum_pairs"] += 1
        launches["colsum_finish"] += finish
        check(total == GOLDEN_RECT[scale],
              f"rectangle rmat{scale}: {total} != {GOLDEN_RECT[scale]}")
        say(f"[{CARD}] rectangle rmat{scale}: {total} in {host:.3f} s "
            f"(host clock), W pairs launches 1, finish {finish}")
    profiled_count("rectangle_count_fast rmat18",
                   lambda: rc.rectangle_count_fast(g18, device="cuda"),
                   GOLDEN_RECT[18])
    # the yardstick's path: W's write mode once a case-B chunk with a sub
    # neighbour (its launches in the kernels line)
    y18, _ = run_path("rectangle level-0 yardstick rmat18",
                      lambda: yardstick(inp18), ["bit_colsum"])
    got = read_counts()["bit_colsum"]
    check(got == inp18.w_chunks, f"yardstick: W write launches {got} != "
          f"{inp18.w_chunks} case-B chunks")
    launches["bit_colsum"] = got
    check(y18 == pairs_count(inp18.plan, inp18.table),
          "rmat18 level 0: yardstick != pairs mode")
    res = sgl_timing(inp18)
    del inp18, inp14
    torch.cuda.empty_cache()
    say(f"phase 15 (fast SgL): {time.perf_counter() - t_phase:.1f} s")
    return res, launches


# --------------------------------------------------------------------------
# phase 16: the fast house engine, motif and sc
# --------------------------------------------------------------------------

#: rmat(scale, 16, seed=7) houses (bench.py:86-87)
GOLDEN_HOUSE = {14: 294_814_195_705, 18: 71_686_049_455_877}
#: rmat(18, 16, seed=7) induced 3- and 4-motifs: wedges Σ C(d, 2) − 3 T;
#: diamonds 45,873,513,836 − 6 K4; 4-cycles 51,349,430,411 − D − 3 K4
GOLDEN_MOTIF18 = {"3": {"wedge": 4_499_982_120, "triangle": GOLDEN[18]},
                  "4": {"4clique": GOLDEN_CK[4],
                        "diamond": 32_191_930_940,
                        "4cycle": 12_316_708_023}}
#: the CLI's kernel launch keys of each phase-16 verb's fast engines
MOTIF_KERNELS = {"3": ("ring_phase_c", "ring_tail_pairs"),
                 "4": ("tri_bitmap", "tri_probe", "tri_lists", "bit_gram",
                       "lo_popcount", "colsum_pairs")}


#: a row's set bits in h_graph's `exact` rows: cuda_house.LIST_SPARSE, the
#: lists' average at which the plan turns from block to warp items
H_EXACT = 128


def h_graph(rng, v, c, n_long, long_len, exact=200, max_deg=160):
    """A graph-like CSR (sorted rows, no repeated id) whose ids >= cs = v - c
    are the core, and its core table (row x: x's core ids less cs, as the
    house engine packs it): (rowptr, colidx, tab, nbc, cs). Core ids are
    drawn more often, so rows fall on both sides of LIST_SPARSE;
    n_long rows of long_len ids; `exact` rows with exactly H_EXACT core
    ids."""
    cs = v - c
    deg = rng.integers(0, max_deg + 1, v)
    deg[rng.choice(v, n_long, replace=False)] = rng.integers(*long_len,
                                                             n_long)
    rows = [np.unique(np.concatenate([rng.integers(0, v, d),
                                      rng.integers(cs, v, d // 2)]))
            for d in deg]
    for x in rng.choice(v, exact, replace=False):
        rows[x] = np.concatenate([
            np.sort(rng.choice(cs, 20, replace=False)),
            cs + np.sort(rng.choice(c, H_EXACT, replace=False))])
    rowptr = np.concatenate([[0], np.cumsum([r.size for r in rows])])
    colidx = np.concatenate(rows).astype(np.int32)
    src = np.repeat(np.arange(v), np.diff(rowptr))
    core = colidx >= cs
    tab = np.zeros((v, c // 32), dtype=np.uint32)
    cc = colidx[core].astype(np.int64) - cs
    np.bitwise_or.at(tab, (src[core], cc >> 5),
                     np.uint32(1) << (cc & 31).astype(np.uint32))
    nbc = np.bincount(src[core], minlength=v).astype(np.int32)
    return rowptr, colidx, tab.view(np.int32), nbc, cs


def h_tasks(rng, order, v, n):
    """n list owners in `order` ("unsorted", "runs of 1", "runs" of
    150-300, "long runs" of 5,000-30,000), ids outside [0, v) among
    them."""
    if order == "unsorted":
        return rng.integers(-2, v + 2, n)
    if order == "runs of 1":
        return np.resize(np.arange(-2, v + 2), n)
    lens = (rng.integers(150, 301, n // 150 + 1) if order == "runs"
            else rng.integers(5000, 30001, n // 5000 + 1))
    return np.repeat(np.sort(rng.integers(-2, v + 2, lens.size)), lens)[:n]


def h_random():
    """H against its plain version on random inputs: 4-128 words with bit
    31 in every row, lists with ids outside [0, V) and SENTINEL, empty
    lists, runs of 1, sorted runs of 150-300 and of up to 30,000 tasks over
    lists of up to 1,500 and of 5,000-30,000 ids, no order; graph-like
    tables with the sparse view, rows dense and sparse on both sides of
    LIST_SPARSE (rows with exactly that many set bits among them), each
    call with the view and without it, with a plan built before the call
    and with the wrapper's own, and over plans of block items alone and of
    warp items alone; a call with no task launches nothing, and a table
    whose words are no multiple of 4 is refused."""
    from graphminer_tpu_torch.ops import _build
    from graphminer_tpu_torch.ops import cuda_house as ch
    from graphminer_tpu_torch.ops.cuda_tri import FtLists
    rng = np.random.default_rng(16)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(
        a, dtype=np.int32)).cuda()
    v = 20000
    for w, order, n, long_len in (
            (4, "runs", 200_000, (600, 1501)),
            (8, "unsorted", 200_000, (600, 1501)),
            (12, "runs of 1", 100_000, (600, 1501)),
            (40, "runs", 200_000, (600, 1501)),
            (128, "runs", 400_000, (600, 1501)),
            (128, "long runs", 300_000, (600, 1501)),
            (128, "unsorted", 200_000, (600, 1501)),
            (128, "long runs", 300_000, (5000, 30001)),
            (160, "runs", 200_000, (5000, 30001))):
        tab = _words(rng, (v, w)) | np.int32(-2**31)
        sparse = rng.random(v) < 0.5
        tab[sparse] &= _words(rng, (int(sparse.sum()), w)) & \
            _words(rng, (int(sparse.sum()), w)) & \
            _words(rng, (int(sparse.sum()), w)) & \
            _words(rng, (int(sparse.sum()), w))
        deg = rng.integers(0, 161, v)
        deg[rng.choice(v, 300, replace=False)] = rng.integers(*long_len, 300)
        colidx = rng.integers(-2, v + 2, int(deg.sum())).astype(np.int32)
        colidx[::97] = SENTINEL
        ftw = rng.integers(-1, deg + 3)
        ftw[::13] = 0
        ft = FtLists.from_csr(np.concatenate([[0], np.cumsum(deg)]), colidx,
                              ftw, "cuda")
        args = (ft, t(tab), t(h_tasks(rng, order, v, n)),
                t(rng.integers(-2, v + 2, n)))
        plan = ch.plan_house(*args[:3])
        compare("house_t3", ch.house_t3(*args, plan=plan),
                ch.house_t3_plain(*args),
                f"random, {w} words, {order}, {n} tasks, lists of "
                f"{long_len[0]}-{long_len[1] - 1} ids, {plan.n_block} "
                f"block and {plan.items.shape[0] - plan.n_block} warp items")
    for order, n, c in (("runs", 300_000, 4096), ("long runs", 300_000, 4096),
                        ("unsorted", 200_000, 4096),
                        ("runs of 1", 100_000, 4096),
                        ("runs", 200_000, 8192)):
        v = 40000
        rowptr, colidx, tab, nbc, cs = h_graph(rng, v, c, 40, (5000, 30001))
        deg = np.diff(rowptr)
        ftw = np.where(rng.random(v) < 0.5, deg, rng.integers(-1, deg + 3))
        ft = FtLists.from_csr(rowptr, colidx, ftw, "cuda")
        a = h_tasks(rng, order, v, n)
        args = (ft, t(tab), t(a), t(rng.integers(-2, v + 2, n)))
        view = ch.HouseView(nbc=t(nbc), cs=cs)
        plan = ch.plan_house(*args[:3], view)
        plain = ch.house_t3_plain(*args)
        what = (f"graph-like, {c // 32} words, {order}, {n} tasks, lists of "
                f"up to {int(deg.max())} ids, {plan.n_block} block and "
                f"{plan.items.shape[0] - plan.n_block} warp items")
        for label, kw in (("view, plan before", dict(view=view, plan=plan)),
                          ("view, own plan", dict(view=view)),
                          ("no view, plan before", dict(plan=plan)),
                          ("no view, own plan", {})):
            compare("house_t3", ch.house_t3(*args, **kw), plain,
                    f"{what}, {label}")
        entry = _build.entry("gm_house_t3")
        for kind, sparse in (("block", 1 << 20), ("warp", -1)):
            one = ch.plan_house(*args[:3], view, sparse=sparse)
            for v_ in (view, None):
                compare("house_t3", ch.launch(entry, *args, v_, one), plain,
                        f"{what}, {kind} items alone, "
                        f"{'view' if v_ else 'no view'}")
    n0 = ch.house_t3.launches
    e = t(np.zeros(0))
    check(ch.house_t3(ft, t(tab), e, e).numel() == 0 and
          ch.house_t3.launches == n0, "house_t3: a call with no task")
    try:
        ch.house_t3(ft, t(tab)[:, :1].contiguous(), e, e)
        check(False, "house_t3 took a table of 1 word")
    except ValueError:
        pass
    say("house_t3 == plain on random inputs (4-160 words, runs of up to "
        "30,000 tasks, lists of up to 30,000 ids; graph-like tables with "
        "and without the view, plans built before and the wrapper's own, "
        "block or warp items alone); no launch without tasks")


def h_calls(g):
    """(src, dst, cs, [(H's arguments, its view and plan, edges)]) of the
    house count of g, built as edge_t3 builds them, on the card."""
    from graphminer_tpu_torch.ops.house import house_calls
    rg = g.relabel_by_degree(descending=False)
    return house_calls(rg, 4096, "cuda")


def h_timing(calls, g18):
    """H's two calls at rmat18 timed beside their bounds and plain
    versions (and held to them): event times with the wrapper's plan
    included (`ms`, as the first design was timed) and with a plan built
    before the call (`prebuilt_ms`), the plan alone (`plan_ms`), the
    kernel alone on the device (torch.profiler), and what each plan holds
    (cuda_house.house_work); then both calls, their plans included, in
    turns with the JAX form they replaced (ops/slab_form.py::house_t3_slab:
    X + torch._int_mm + W's write mode, the library row), which is timed
    once a turn (~10 s a call)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from graphminer_tpu_torch.ops import cuda_house as ch
    from graphminer_tpu_torch.ops.slab_form import house_t3_slab
    from graphminer_tpu_torch.ops.tri_support import core_neighbours
    from graphminer_tpu_torch.utils import profiling as pf
    src, dst, cs, parts = calls
    rg = g18.relabel_by_degree(descending=False)
    core_nb = core_neighbours(rg, cs)[1]
    res = dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, device_ms=0.0,
               prebuilt_ms=0.0, plan_ms=0.0)
    for i, (args, kw, idx) in enumerate(parts, 1):
        k_ms, kv = time_ms(lambda: ch.house_t3(*args, view=kw["view"]))
        x_ms, xv = time_ms(lambda: ch.house_t3(*args, **kw))
        l_ms, _ = time_ms(lambda: ch.plan_house(*args[:3], kw["view"]).items)
        p_ms, pv = pf.time_ms(lambda: ch.house_t3_plain(*args), "cuda", 1)
        compare("house_t3", kv, pv, f"rmat18 call {i}, {idx.numel()} tasks")
        compare("house_t3", xv, pv, f"rmat18 call {i}, a plan built before")
        for _ in range(DEVICE_READS):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(5):
                    ch.house_t3(*args, **kw)
                torch.cuda.synchronize()
            us = [e.time_range.elapsed_us() for e in prof.events()
                  if e.device_type == DeviceType.CUDA and
                  "house_t3" in e.name]
            if us:
                break
        d_ms = sum(us) / len(us) / 1e3 if us else None
        nbytes = pf.house_bytes(*args)
        b = pf.bound_ms(nbytes)
        host = lambda x: x.cpu().numpy()
        work = ch.house_work(host(args[2]), host(args[3]), rg.rowptr,
                             rg.colidx, host(args[0].ftw), core_nb,
                             host(kw["plan"].items), kw["plan"].n_block,
                             args[1].shape[1])
        res["ms"] += k_ms
        res["prebuilt_ms"] += x_ms
        res["plan_ms"] += l_ms
        res["plain_ms"] += p_ms
        res["bound_ms"] += b[0]
        res["device_ms"] = None if None in (d_ms, res["device_ms"]) \
            else res["device_ms"] + d_ms
        res["bound_by"] = b[1]
        say(f"[{CARD}] house_t3 rmat18 call {i} ({idx.numel()} tasks, 1 "
            f"launch): kernel {k_ms:.4f} ms (the wrapper's plan included; "
            f"with a plan built before {x_ms:.4f} ms; the plan alone "
            f"{l_ms:.4f} ms; the kernel alone on the device "
            f"{shown(d_ms)}), plain {p_ms:.3f} ms, bound "
            f"{b[0]:.4f} ms ({b[1]}, {nbytes} B); plan {json.dumps(work)}")
    table, ft = parts[-1][0][1], parts[-1][0][0]
    s32, d32 = parts[0][0][2], parts[0][0][3]

    def by_h():
        t3 = torch.zeros(src.shape[0], dtype=torch.int64, device="cuda")
        for args, kw, idx in parts:
            t3.index_add_(0, idx, ch.house_t3(
                *args, view=kw["view"]).to(torch.int64))
        return t3

    def yard_once():
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        val = house_t3_slab(table, ft, cs, s32, d32)
        b.record()
        b.synchronize()
        return a.elapsed_time(b), val

    p1, yv = yard_once()
    k1, hv = time_ms(by_h)
    k2, _ = time_ms(by_h)
    p2, _ = yard_once()
    check(torch.equal(hv, yv), "rmat18: H's calls != the JAX-form yardstick")
    res.update(library_ms=statistics.median([p1, p2]),
               both_calls_ms=statistics.median([k1, k2]))
    say(f"[{CARD}] rmat18 core-mid T3 ({src.shape[0]} DAG edges): H's two "
        f"calls {res['both_calls_ms']:.4f} ms, the JAX-form yardstick (X + "
        f"torch._int_mm + W's write mode) {res['library_ms']:.3f} ms (in "
        f"turns: yardstick {p1:.3f}, H {k1:.4f}, H {k2:.4f}, yardstick "
        f"{p2:.3f})")
    return res


def cli_json(args, scale, prefix=None):
    """`python -m graphminer_tpu_torch <args>` on rmat<scale> (or the graph
    at `prefix`) on CUDA with --json --profile, run in this process (its
    main(), every launch count at 0 before it, so the launches it reports
    are its own): its result, after checking it ran on the card."""
    import contextlib
    import io
    from graphminer_tpu_torch.__main__ import main as cli
    t0 = time.perf_counter()
    reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli([args[0], prefix or graph_prefix(scale), *args[1:],
                  "--json", "--profile"])
    check(rc == 0, f"CLI {args} returned {rc}")
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    check(res["profile"]["device"] == "cuda",
          f"CLI {args} ran on {res['profile']['device']}")
    launched = {k: n for k, n in res["profile"]["kernel_launches"].items()
                if n}
    say(f"[{CARD}] CLI {' '.join(args)} rmat{scale}: "
        f"{res.get('total', res.get('counts'))} run_s={res['run_s']} "
        f"launches={launched} (wall {time.perf_counter() - t0:.1f} s)")
    return res


def run_house(g18):
    """Phase 16: kernel H against its plain version (random inputs, both
    calls of the rmat14 and rmat18 counts), the house goldens at rmat14 and
    rmat18 (two H launches a count), sgl house --fast == generic at rmat12,
    the CLI's motif 3|4 --fast at rmat18 against their goldens, motif 4
    --fast == generic and sc hourglass|diamond against tri_support's
    formulas at rmat12, motif 5 at rmat10 against clique 5; H timed at
    rmat18 beside its bound, plain version and the JAX form; the profiled
    rmat18 house count and the host time of t3ss. Returns (timings,
    {kernel: launches})."""
    from graphminer_tpu_torch import native_bridge
    from graphminer_tpu_torch.io.synth import rmat
    from graphminer_tpu_torch.ops import cuda_house as ch
    from graphminer_tpu_torch.ops import tri_support as ts
    from graphminer_tpu_torch.ops.cliquek import cliquek_count_fast
    from graphminer_tpu_torch.ops.house import house_count_fast
    t_phase = time.perf_counter()
    h_random()
    launches = 0
    calls = {}
    for scale in (14, 18):
        g = g18 if scale == 18 else rmat(14, 16, seed=7)
        calls[scale] = h_calls(g)
        for i, (args, kw, idx) in enumerate(calls[scale][3], 1):
            compare("house_t3", ch.house_t3(*args, **kw),
                    ch.house_t3_plain(*args),
                    f"rmat{scale} call {i}, {idx.numel()} tasks")
        t0 = time.perf_counter()
        got, n = run_path(f"house rmat{scale}",
                          lambda: house_count_fast(g, device="cuda"),
                          ["house_t3"])
        check(n["house_t3"] == 2, f"house rmat{scale}: {n} H launches")
        check(got == GOLDEN_HOUSE[scale],
              f"house rmat{scale}: {got} != {GOLDEN_HOUSE[scale]}")
        launches += 2
        say(f"[{CARD}] houses rmat{scale}: {got} in "
            f"{time.perf_counter() - t0:.3f} s (host clock), H launches 2")
    rg18 = g18.relabel_by_degree(descending=False)
    cs18 = calls[18][2]
    t0 = time.perf_counter()
    native_bridge.t3ss(rg18.rowptr, rg18.colidx, cs18)
    say(f"rmat18 t3ss (native, host): {time.perf_counter() - t0:.3f} s")
    profiled_count("house_count_fast rmat18",
                   lambda: house_count_fast(g18, device="cuda"),
                   GOLDEN_HOUSE[18])
    res = h_timing(calls[18], g18)
    del calls

    # the CLI on the card: house, motif and sc
    for scale in (10, 12):
        if not os.path.exists(graph_prefix(scale) + ".meta.txt"):
            write_rmat(scale)
    fast = cli_json(("sgl", "house", "--fast"), 12)
    check(fast["profile"]["kernel_launches"]["house_t3"] == 1,
          "sgl house --fast rmat12: H must launch once (no sub-core "
          "vertex at core 4096)")
    gen = cli_json(("sgl", "house"), 12)
    check(fast["total"] == gen["total"] > 0,
          f"rmat12 house: --fast {fast['total']} != generic {gen['total']}")
    for k in ("3", "4"):
        out = cli_json(("motif", k, "--fast"), 18)
        for name, want in GOLDEN_MOTIF18[k].items():
            check(out["counts"][name] == want,
                  f"motif {k} rmat18 {name}: {out['counts'][name]} != {want}")
        kl = out["profile"]["kernel_launches"]
        check(all(kl[x] == 1 for x in MOTIF_KERNELS[k]),
              f"motif {k} --fast rmat18: launches {kl}")
    m_fast = cli_json(("motif", "4", "--fast"), 12)["counts"]
    m_gen = cli_json(("motif", "4"), 12)["counts"]
    check(m_fast == m_gen, f"motif 4 rmat12: --fast {m_fast} != {m_gen}")
    g12 = rmat(12, 16, seed=7)
    tri = ts.tri_support(g12, device="cuda")
    d = torch.from_numpy(tri.src).cuda(), torch.from_numpy(tri.dst).cuda()
    tv = torch.zeros(tri.n_vertices, dtype=torch.int64, device="cuda")
    tv.index_add_(0, d[0], tri.tri).index_add_(0, d[1], tri.tri)
    tv //= 2
    c2 = lambda x: int((x * (x - 1) // 2).sum())
    want = {"hourglass": c2(tv) - 2 * c2(tri.tri),
            "diamond": c2(tri.tri) - 6 * cliquek_count_fast(g12, 4,
                                                            device="cuda")}
    for p, w in want.items():
        got = cli_json(("sc", p), 12)["total"]
        check(got == w, f"sc {p} rmat12: {got} != {w} by tri_support")
    m5 = cli_json(("motif", "5"), 10)["counts"]
    k5 = cli_json(("clique", "5"), 10)["total"]
    check(m5["5clique"] == k5 > 0 and len(m5) == 21,
          f"motif 5 rmat10: 5clique {m5['5clique']} != clique 5 {k5}")
    torch.cuda.empty_cache()
    say(f"phase 16 (house, motif, sc): {time.perf_counter() - t_phase:.1f} "
        "s")
    return {"house_t3": res}, {"house_t3": launches}


# --------------------------------------------------------------------------
# phase 17: the labelled workloads (FSM, query, GKS)
# --------------------------------------------------------------------------

#: labelled rmat(14, 8, seed=7) frequent patterns at k = 2 by minsup: 50
#: (BENCH_r05.json fsm_rmat14_k2_ms300_frequent; with 4 labels the most
#: k = 2 allows) and 11 (the JAX package on the CPU)
GOLDEN_FSM14 = {300: 50, 1500: 11}
#: the phase's query: a triangle 1-2-3 with a tail 3-4 (vertex labels)
QUERY17 = "1,2,3,4:0-1,1-2,0-2,2-3"


def no_launches(label, fn):
    """fn() with every launch count at 0 before it; fails if it launched a
    kernel of ours. Returns (fn's result, host seconds)."""
    reset_counts()
    t0 = time.perf_counter()
    val = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = {k: n for k, n in read_counts().items() if n}
    check(not launched, f"{label}: launched {launched}")
    return val, dt


def timed(fn):
    t0 = time.perf_counter()
    return fn(), time.perf_counter() - t0


def fsm_supports(g, minsup, k, device):
    """(frequent patterns, {canonical key: MNI support} of every pattern
    the search evaluated)."""
    from graphminer_tpu_torch.workloads import fsm
    f = fsm._FSM(g, minsup, device=device)
    return f.run(k), f.supports


def run_labelled():
    """Phase 17: FSM, query and GKS on the card (see the module docstring).
    No kernel of ours runs here, so it adds no line to the kernels JSON."""
    import dataclasses
    from graphminer_tpu_torch.io.loader import save_graph
    from graphminer_tpu_torch.io.synth import labeled_er
    from graphminer_tpu_torch.scripts.prof_fsm import labelled_rmat
    from graphminer_tpu_torch.utils.profiling import PROFILER
    from graphminer_tpu_torch.workloads import fsm, keyword, query
    t_phase = time.perf_counter()
    g14 = labelled_rmat(14)
    for minsup, want in GOLDEN_FSM14.items():
        PROFILER.seconds.clear()
        PROFILER.counters.clear()
        got, dt = no_launches(f"fsm rmat14 minsup {minsup}", lambda: (
            fsm.fsm_count(g14, 2, minsup, device="cuda")))
        check(got == want, f"fsm rmat14 k = 2 minsup {minsup}: {got} != "
              f"{want}")
        c = PROFILER.counters
        check(c["fsm_overflow_retries"] == 0,
              f"fsm rmat14 minsup {minsup}: {c['fsm_overflow_retries']} "
              "overflow retries past the label bound")
        say(f"[{CARD}] fsm labelled rmat14 k = 2 minsup {minsup}: {got} "
            f"frequent in {dt:.3f} s (host clock); {c['fsm_extensions']} "
            f"extensions, {c.get('fsm_filters', 0)} filters, "
            f"{c['fsm_host_syncs']} host syncs, "
            f"{c['fsm_overflow_retries']} overflow retries; phases "
            f"{ {k: round(v, 4) for k, v in PROFILER.seconds.items()} }")

    g12 = labelled_rmat(12)
    ger = labeled_er(300, 0.03, n_vlabels=3, n_elabels=2, seed=4)
    for label, g, minsup, k in (("labelled rmat12", g12, 100, 2),
                                ("edge-labelled ER(300, 0.03)", ger, 5, 3)):
        card, dt = no_launches(f"fsm {label}",
                               lambda: fsm_supports(g, minsup, k, "cuda"))
        cpu, dt_cpu = timed(lambda: fsm_supports(g, minsup, k, "cpu"))
        check(card == cpu and card[0] > 0,
              f"fsm {label}: card {card[0]} != CPU {cpu[0]} or their "
              "supports differ")
        say(f"[{CARD}] fsm {label} k = {k} minsup {minsup}: {card[0]} "
            f"frequent, {len(card[1])} supports == CPU; card {dt:.3f} s, "
            f"CPU {dt_cpu:.3f} s")

    labs, _, edges = QUERY17.partition(":")
    q = query.make_query([tuple(int(x) for x in e.split("-"))
                          for e in edges.split(",")],
                         [int(x) for x in labs.split(",")])
    filt, dt_f = no_launches("query rmat14", lambda: query.query_count(
        g14, q, device="cuda"))
    unf, dt_u = no_launches("query rmat14 unfiltered", lambda: (
        query.query_count(g14, q, use_filter=False, device="cuda")))
    cpu, dt_cpu = timed(lambda: query.query_count(g14, q, device="cpu"))
    check(filt == unf == cpu > 0,
          f"query rmat14: filtered {filt}, unfiltered {unf}, CPU {cpu}")
    say(f"[{CARD}] query {QUERY17} labelled rmat14: {filt} (card "
        f"{dt_f:.3f} s filtered, {dt_u:.3f} s unfiltered; CPU {dt_cpu:.3f} "
        "s)")

    g11 = labelled_rmat(11)
    gks, dt = no_launches("gks rmat11", lambda: keyword.gks_count(
        g11, 3, (1, 2, 3), device="cuda"))
    gks_cpu, dt_cpu = timed(lambda: keyword.gks_count(g11, 3, (1, 2, 3),
                                                      device="cpu"))
    check(gks == gks_cpu > 0, f"gks rmat11: card {gks} != CPU {gks_cpu}")
    say(f"[{CARD}] gks k = 3 keywords 1,2,3 labelled rmat11: {gks} (card "
        f"{dt:.3f} s, CPU {dt_cpu:.3f} s)")

    # the CLI on the card, on rmat11 saved with vertex and edge labels
    src = np.repeat(np.arange(g11.n_vertices), np.diff(g11.rowptr))
    lo = np.minimum(src, g11.colidx).astype(np.int64)
    hi = np.maximum(src, g11.colidx).astype(np.int64)
    g11e = dataclasses.replace(
        g11, elabels=((lo * 7 + hi * 3) % 2).astype(np.uint16))
    prefix = os.path.join(REPO, "graph_cache", "rmat11_labelled", "graph")
    save_graph(g11e, prefix)
    want = {"fsm": fsm.fsm_count(g11e, 2, 100, device="cpu"), "gks": gks,
            "query": query.query_count(g11, q, device="cpu")}
    for args in (("fsm", "2", "100"), ("gks", "3", "1,2,3"),
                 ("query", QUERY17)):
        res = cli_json(args, 11, prefix=prefix)
        check(res["total"] == want[args[0]],
              f"CLI {args[0]}: {res['total']} != {want[args[0]]}")
        check(not any(res["profile"]["kernel_launches"].values()),
              f"CLI {args[0]}: launches {res['profile']['kernel_launches']}")
        if args[0] == "fsm":
            check(res["profile"]["counters"]["fsm_overflow_retries"] == 0,
                  f"CLI fsm: {res['profile']['counters']}")
    torch.cuda.empty_cache()
    say(f"phase 17 (fsm, query, gks): {time.perf_counter() - t_phase:.1f} s")


# --------------------------------------------------------------------------
# phase 18: the dense core and clique4 on kernel G, and scale-out
# --------------------------------------------------------------------------

#: rmat(16, 16, seed=7) triangles (bench.py:62-63)
GOLDEN16_TC = 15_623_664
#: rmat(14, 16, seed=7) 4-cliques and rmat(12, 16, seed=7) diamonds
GOLDEN_C4_14 = 36_628_817
GOLDEN_DIAMOND12 = 57_515_371
#: the phase's 2-rank count: each rank loads rmat18 and counts its induced
#: partition on cuda:{rank % cards}, summed over gloo
WORKER18 = """
import sys, time, torch
from graphminer_tpu_torch import load_graph
from graphminer_tpu_torch.core.plan import TRIANGLE
from graphminer_tpu_torch.parallel.distributed import (
    count_pattern_multiprocess, init_distributed)
init_distributed()
rank = torch.distributed.get_rank()
g = load_graph(sys.argv[1])
t0 = time.perf_counter()
total = count_pattern_multiprocess(g, TRIANGLE)
torch.cuda.synchronize()
print(f"RANK={rank} TOTAL={total} "
      f"device=cuda:{rank % torch.cuda.device_count()} "
      f"count_s={time.perf_counter() - t0:.3f} "
      f"jax_loaded={'jax' in sys.modules}", flush=True)
torch.distributed.destroy_process_group()
"""


def cached_rmat(scale):
    """rmat(scale, 16, seed=7) from graph_cache/, written there first when
    an earlier phase has not."""
    from graphminer_tpu_torch import load_graph
    if not os.path.exists(graph_prefix(scale) + ".meta.txt"):
        return write_rmat(scale)
    return load_graph(graph_prefix(scale))


def only_g(label, fn, want):
    """fn() with every count at 0 before it; fails unless it returns
    `want` and launched G once and nothing else of ours. Returns host s."""
    reset_counts()
    t0 = time.perf_counter()
    got = fn()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launched = {k: n for k, n in read_counts().items() if n}
    check(got == want, f"{label}: {got} != {want}")
    check(launched == {"bit_gram": 1},
          f"{label}: launched {launched}, not G once")
    say(f"[{CARD}] {label}: {got} in {dt:.3f} s (host clock), G once")
    return dt


def dense_core_g(g18):
    """The hybrid on rmat18 and its core's G launch: timed with CUDA events
    beside its bound over the mask's set bits and the library form (D as
    int8, torch._int_mm(D, Dᵀ), the masked sum); G == plain on the rmat14
    core (the whole graph). Returns G's timing keys."""
    from graphminer_tpu_torch.ops import cuda_expand, cuda_gram, dense_core
    from graphminer_tpu_torch.utils.profiling import gram_bounds
    from graphminer_tpu_torch.workloads.triangle import triangle_count_hybrid
    only_g("triangle_count_hybrid rmat18 core 16384",
           lambda: triangle_count_hybrid(g18, device="cuda"), GOLDEN[18])
    rg14 = cached_rmat(14).relabel_by_degree(descending=False).orientation()
    d14 = dense_core.core_rows(rg14, 0, "cuda")
    compare("bit_gram", cuda_gram.bit_gram(d14, d14),
            cuda_gram.bit_gram_plain(d14, d14), "rmat14 dense core (512 "
            "words, base = mask)")

    rg = g18.relabel_by_degree(descending=False).orientation()
    cs = rg.n_vertices - 16384
    t0 = time.perf_counter()
    d = dense_core.core_rows(rg, cs, "cuda")
    plan = cuda_gram.plan_gram(d)
    prep_s = time.perf_counter() - t0
    g_ms, core = time_ms(lambda: cuda_gram.bit_gram(d, d, plan=plan).sum())
    x = cuda_expand.expand_bits_plain(d)
    lib_ms, lib = time_ms(lambda: (torch._int_mm(x, x.t()) * x).sum())
    del x
    check(int(core) == int(lib), f"rmat18 core: G {int(core)} != "
          f"torch._int_mm's {int(lib)}")
    gb = gram_bounds(d, d, plan.n_tiles, cuda_gram.TILE)
    side = d.shape[1] * 32 // cuda_gram.TILE
    say(f"[{CARD}] dense core rmat18 (C = 16384, {d.shape[1]} words, "
        f"{int(core)} core triangles): G {g_ms:.4f} ms over "
        f"{plan.n_tiles} of {side * side} tiles, bound {gb['mask'][0]:.4f} "
        f"ms over the mask's set bits ({gb['mask'][1]}), "
        f"{gb['tiles'][0]:.4f} ms over its tiles, {gb['full'][0]:.4f} ms "
        f"over the full Gram; torch._int_mm + masked sum {lib_ms:.4f} ms; "
        f"rows and plan built in {prep_s:.3f} s")
    return {"dense_core_ms": g_ms, "dense_core_bound_ms": gb["mask"][0],
            "dense_core_library_ms": lib_ms}


def clique4_g(g18):
    """Clique4Engine on rmat18 (core 4096) and clique4_count_fast on
    rmat14, one G launch a count; G == plain on the rmat14 engine's
    core-dst tasks; G's rmat18 launch timed beside its bound."""
    from graphminer_tpu_torch.ops import cuda_gram
    from graphminer_tpu_torch.ops.clique4 import (Clique4Engine,
                                                  clique4_count_fast)
    from graphminer_tpu_torch.utils.profiling import gram_bounds
    eng, build_s = no_launches("Clique4Engine rmat18 build",
                               lambda: Clique4Engine(g18, device="cuda"))
    count_s = only_g("Clique4Engine rmat18 count", eng.count, GOLDEN_CK[4])
    base, mask, kw = eng.gram_args()
    g_ms, _ = time_ms(eng.core_partials)
    gb = gram_bounds(base, mask, eng.gram_plan.n_tiles, cuda_gram.TILE, **kw)
    say(f"[{CARD}] Clique4Engine rmat18: build {build_s:.3f} s (tail "
        f"{eng.tail_total} by the frontier), count {count_s:.3f} s; G "
        f"{g_ms:.4f} ms ({eng.n_core_edges} core-dst tasks, gathered, "
        f"depth 1, {eng.gram_plan.n_tiles} tiles), bound "
        f"{gb['mask'][0]:.4f} ms ({gb['mask'][1]})")
    del eng
    g14 = cached_rmat(14)
    only_g("clique4_count_fast rmat14",
           lambda: clique4_count_fast(g14, device="cuda"), GOLDEN_C4_14)
    eng14 = Clique4Engine(g14, device="cuda")
    base, mask, kw = eng14.gram_args()
    compare("bit_gram", eng14.core_partials(),
            cuda_gram.bit_gram_plain(base, mask, **kw),
            "rmat14 clique4 core-dst tasks (gathered, depth 1)")
    return {"clique4_ms": g_ms, "clique4_bound_ms": gb["mask"][0]}


def counted(label, fn, want):
    """no_launches with the count checked and its seconds printed."""
    got, dt = no_launches(label, fn)
    check(got == want, f"{label}: {got} != {want}")
    say(f"[{CARD}] {label}: {got} in {dt:.3f} s (host clock)")


def two_ranks():
    """Two processes on the card through gloo on 127.0.0.1, each counting
    its induced partition of rmat18; each must print the golden. Both are
    killed if they outlast the timeout."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    procs = []
    for rank in range(2):
        env = dict(os.environ, PYTHONPATH=REPO,
                   GRAPHMINER_COORDINATOR=f"127.0.0.1:{port}",
                   GRAPHMINER_NUM_PROCESSES="2",
                   GRAPHMINER_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-c", WORKER18, PREFIX], cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        line = [ln for ln in out.splitlines() if ln.startswith("RANK=")]
        check(p.returncode == 0 and line and
              f"TOTAL={GOLDEN[18]} " in line[0] and
              "jax_loaded=False" in line[0],
              f"rank {rank} of 2: rc {p.returncode}\n{out[-2000:]}")
        say(f"[{CARD}] count_pattern_multiprocess rmat18, 2 ranks over "
            f"gloo: {line[0]}")
    say(f"count_pattern_multiprocess rmat18: both ranks in "
        f"{time.perf_counter() - t0:.1f} s (their start included)")


def run_scale_out(g18):
    """Phase 18: the hybrid's dense core and clique4 on kernel G, then the
    sharded, partitioned, segmented and 2-process counts, the CLI's
    --sharded and --partition on the card and the port's multichip dryrun
    (see the module docstring). Returns ({"bit_gram": G's timing keys},
    {"bit_gram": G's launches here})."""
    from graphminer_tpu_torch.core.plan import SGL_PLANS, TRIANGLE
    from graphminer_tpu_torch.parallel import distributed, mesh, partition
    from graphminer_tpu_torch.scripts import dryrun_multichip
    t_phase = time.perf_counter()
    res = dense_core_g(g18)
    res.update(clique4_g(g18))
    #: the hybrid's count and the two clique4 counts, each held by only_g
    #: to one G launch
    g_launches = 3
    torch.cuda.empty_cache()

    n = torch.cuda.device_count()
    meshes = {"(1, 1)": mesh.make_mesh(devices=["cuda:0"], shape=(1, 1)),
              f"every card {(1, n)}": mesh.make_mesh(),
              "(2, 2)": mesh.make_mesh(
                  devices=[f"cuda:{i % n}" for i in range(4)],
                  shape=(2, 2))}
    for name, m in meshes.items():
        counted(f"count_pattern_sharded rmat18 triangles, mesh {name} on "
                f"{[str(d) for d in m.devices.flat]}",
                lambda: mesh.count_pattern_sharded(g18, TRIANGLE, mesh=m),
                GOLDEN[18])
    g12 = cached_rmat(12)
    counted("count_pattern_sharded rmat12 diamonds, every card",
            lambda: mesh.count_pattern_sharded(g12, SGL_PLANS["diamond"]),
            GOLDEN_DIAMOND12)
    counted("count_pattern_partitioned rmat18 triangles, 4 parts",
            lambda: distributed.count_pattern_partitioned(
                g18, TRIANGLE, 4, device="cuda"), GOLDEN[18])
    counted("count_pattern_partitioned rmat12 4-cycles, 2 parts (hops 2)",
            lambda: distributed.count_pattern_partitioned(
                g12, SGL_PLANS["rectangle"], 2, device="cuda"),
            GOLDEN_RECT[12])
    g16 = cached_rmat(16)
    counted("triangle_count_segmented rmat16, 4 segments",
            lambda: partition.triangle_count_segmented(g16, 4,
                                                       device="cuda"),
            GOLDEN16_TC)
    del g16
    torch.cuda.empty_cache()
    two_ranks()

    for scale, args, want in ((18, ("tc", "--sharded"), GOLDEN[18]),
                              (18, ("tc", "--partition", "4"), GOLDEN[18]),
                              (14, ("clique", "4", "--sharded"),
                               GOLDEN_C4_14),
                              (14, ("clique", "4", "--partition", "2"),
                               GOLDEN_C4_14)):
        out = cli_json(args, scale)
        check(out["total"] == want, f"CLI {args}: {out['total']} != {want}")
        check(not any(out["profile"]["kernel_launches"].values()),
              f"CLI {args}: launches {out['profile']['kernel_launches']}")

    t0 = time.perf_counter()
    dry = dryrun_multichip.main(["--n", "4"])
    say(f"[{CARD}] dryrun_multichip n = 4: {dry} in "
        f"{time.perf_counter() - t0:.1f} s")
    torch.cuda.empty_cache()
    say(f"phase 18 (dense core, clique4, scale-out): "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"bit_gram": res}, {"bit_gram": g_launches}


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
    launches["expand_bits"] = pb_launches["expand_bits"]   # the spoke slab
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
    big_res, big_launches = run_cliquebig()
    res.update(big_res)
    sgl_res, sgl_launches = run_sgl(g)
    res.update(sgl_res)
    launches.update(sgl_launches)
    house_res, house_launches = run_house(g)
    res.update(house_res)
    launches.update(house_launches)
    run_labelled()
    scale_res, scale_launches = run_scale_out(g)
    res["bit_gram"].update(scale_res["bit_gram"])
    for part in (ck_launches, big_launches, scale_launches):
        # G: the hub-core count's too
        for key, n in part.items():
            launches[key] = launches.get(key, 0) + n
    torch.cuda.synchronize()

    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    extra = ("device_ms", "library_device_ms", "host_us", "library_host_us",
             "tile_bound_ms", "full_gram_bound_ms", "task_list_bound_ms",
             "level0_ms", "both_calls_ms", "prebuilt_ms", "plan_ms",
             "dense_core_ms", "dense_core_bound_ms", "dense_core_library_ms",
             "clique4_ms", "clique4_bound_ms")
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
