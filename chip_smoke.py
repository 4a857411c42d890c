"""Drive the PyTorch/CUDA port of LSM-VEC (src/repro_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

`python3 chip_smoke.py --kernel-shapes [SRC]` runs only the per-shape
timing of `gather_l2`, `l2_distance` and `simhash_encode`
(`kernel_shapes`), for the port under SRC (default: this checkout's
src/), so two trees can be timed in one call on one card.
`python3 chip_smoke.py --beam-ab SRC` times this checkout's beam kernel
against SRC's in one process (`beam_ab`).  `python3 chip_smoke.py
--fetch-ab SRC` times a loop trip's prefilter and fetch, SRC's separate
`collision_count_rows` and gather launches against this checkout's one
`prefilter_gather`, and SRC's `gather_l2_q8` against this checkout's
(`fetch_ab`).  `python3 chip_smoke.py --encode-ab SRC` times SRC's
`simhash_encode` against this checkout's at a search's, an insert
batch's and the build's row counts (`encode_ab`).

Phases, each printing one JSON line (a failed phase raises, so the
script exits non-zero and prints no result):

  env        nvidia-smi's card name and power limit, torch and CUDA versions
  build      compile the port's CUDA kernels from src/repro_torch/kernels/csrc
  kernels    gather_l2, gather_l2_q8, l2_distance, the three SimHash
             entries (simhash_encode, collision_count and its gathered
             form collision_count_rows) and prefilter_gather (a loop
             trip's prefilter and fetch in one launch, both lanes)
             against their plain PyTorch versions on the card, at the
             main path's shapes; median
             times, bounds, library yardsticks; `gather_l2` and
             `l2_distance` also timed at every shape class the main
             path launches them at (`kernel_shapes`: the gather's
             search, insert phase A and phase B shapes, the dense
             kernel's ground truth and build ramp) and the gather's
             host time per call with its entry point bound once and,
             in the same run, bound on every call; `simhash_encode` at
             a search's, an insert batch's and the build's row counts
  main_path  SIFT1M's shape (d=128, f32, default HNSWConfig) with state
             allocated at cap = 1,048,576 on the card: build -> search (LSM
             probe, snapshot and fused routes) -> insert_batch 2 x 1,024 ->
             delete_batch 1% -> maintain("consolidate") -> search ->
             maintain("tier") -> tiered search (snapshot and fused routes),
             with recall@10 against brute_force_knn; kernel launch counts
             are zeroed before and read after every step (every search
             launches simhash_encode, every loop-route search and every
             insert_batch prefilter_gather and no collision_count_rows),
             and gather_l2's, l2_distance's and prefilter_gather's by
             the kernel variant each call takes; the fused route's
             ids equal the snapshot route's at every step;
             insert_batch's phase B (the upper connects: filter off,
             rho = 1) launches no collision_count_rows; each
             insert_batch patches the fresh snapshot, checked bitwise
             against a fresh resolve and timed against it; then the
             insert_batch step times beside the gather's host time per
             call
  beam       the beam megakernel over the built index's snapshot, for
             B in {1, 4} and rho in {1.0, 0.5}: bitwise against the loop
             route on the card, ids against its plain version; times,
             hops and trips per query, microseconds per trip
  parity     a small integer-valued run, card against the plain route on
             the CPU, search ids bitwise at every step, on the loop,
             fused and tiered routes, then through an eager delete, a
             compaction and a reordering (perm and every state field
             too); a float-data run (`make_clustered_vectors`) through
             insert_batch and consolidate, every state field bitwise;
             the full-size queries re-run with the kernels (the fused
             prefilter_gather too) swapped for their plain versions,
             and on the CPU from a copy of the final state, ids and
             dists bitwise
  profile    torch.profiler over one search on each route and one
             insert_batch: the device's busy share and the kernels that
             take its time
  maintenance  on the final index: eager delete (Algorithm 2) of 1 % of
             the live ids, maintain("compact"), maintain("reorder") on the
             recorded heat, insert_batch of 256 after it; every route
             searched after each, results checked against the searches
             before (bitwise; through perm after the reordering), and
             the LSM runs a lookup walks counted after each
  backend    on that index: a consolidation overlapped with fused
             searches (begin_maintain -> poll_maintain; its return time,
             the searches served and their QPS against none in flight,
             the state bitwise equal to a synchronous one on a clone),
             the write barrier, save -> restore at full size (in a
             temporary directory under build/, removed after; bitwise,
             seconds, bytes, the next insert_batch bitwise on both),
             stats() and memory_bytes() beside the card's allocation
  serve      the serving engine (`repro_torch.serve.ServeEngine`) over
             that index, with its WAL (group commit 1) and covering
             checkpoints under build/ (removed after): a deterministic
             mode (about 4,096 queries, 256 inserts and 128 deletes of
             live ids, submitted one at a time in chunks of 64, each
             drained) and a live mode (`start()`/`stop()`, a few seconds
             of mixed traffic), each with requests/s and p50/p99 per op;
             an overlapped consolidation and a covering checkpoint must
             fire.  Checked: every served query (ids distinct, live, none
             whose delete was acked, distances those of the rows), a
             final 1,000-query batch equal to a direct fused search of
             the same state with recall@10 >= 0.15, recovery from the
             checkpoint and the WAL tail bitwise equal to the live
             engine, the four-point crash matrix with no acked write
             lost, and a guarded steady state (the sync sentinel's
             Python and CUDA layers on) that raises nothing and launches
             no new kernel variant; WAL, checkpoint and recovery seconds
             and the declared host syncs per served request
  sharded    sharded search (`repro_torch.core.distributed`): the flat
             index over 1,000,000 x 128 rows on 8 shards (recall@10 1.0,
             distances allclose to the plain version's) and on 7 (the
             last shard padded with +inf rows: no padded id returned);
             a 4-shard backend of the main path's 1,048,576 ids (32,768
             base rows): every route bitwise equal to the shards searched
             alone and merged, insert_batch of 1,024, 1 % deletes,
             consolidation, an overlapped consolidation under fused
             searches, a short served stream (every query checked),
             reorder (ids through the composed perm), save -> restore
             bitwise; a small integer-valued run, card against the CPU
  baselines  DiskANN (32,768 rows) and SPFresh (131,072 rows) at the
             settings of benchmarks/common.py: build seconds, QPS and
             recall@10 of 1,000 queries, 256 inserts, 1 % deletes,
             memory and I/O counters, results checked; small runs, card
             against the CPU

The `kernels` line counts each kernel's launches on the main path, and
apart those of the serve, sharded and baselines phases (checks not
counted).  The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  It needs no network and one card, and
exits non-zero when no card is present or the port's sources are not
beside it.
"""

from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
import tempfile
import time
from collections import Counter
from contextlib import contextmanager
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

CAP = 1 << 20                 # id space allocated on the card
DIM = 128                     # SIFT1M's width
N_BASE = 131_072              # rows built (SIFT1M has 1,000,000)
N_QUERIES, K = 1000, 10
# two batches, and 256 rows after the reordering, since the serve phase
# came (PERF.md §4: the time limit)
INSERT_BATCHES, INSERT_WIDTH = 2, 1024
REORDER_INSERTS = 256
DELETE_FRACTION = 0.01
TIER_POLICY = dict(hot_frac=0.25, max_demote=CAP, max_promote=64)
# published peaks of one H100 SXM (NVIDIA data sheet, 700 W): HBM rate,
# the f32 rate outside the tensor cores, and the f64 rate on the tensor
# cores (DMMA, an IEEE f64 FMA per product; the f64 pipe outside them
# does half of it)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12
F64_FLOPS = 67e12
RECALL_FLOOR = 0.15
SPIN_CYCLES_PER_S = 2e9       # about the H100's SM clock under load
# gather_l2's calls on the main path, [B, K, caller]
GATHER_SHAPES = ((1000, 16, "search: bottom beam"),
                 (1000, 8, "search: upper descent"),
                 (1024, 64, "insert_batch: phase A beam (4 x 16 ids)"),
                 (1, 8, "insert_batch: phase B connect"),
                 (1, 16, "insert_batch: phase B connect"))
RAMP_SAMPLE = 32              # time every 32nd block of the build ramp
# the serve phase: the engine's batch caps (its pad widths), the
# deterministic mode's mix, sent in chunks drained one by one, the live
# mode's seconds and the most tickets its client holds open, the guarded
# steady state's requests and the crash matrix's short stream
SERVE_BATCH = 32
SERVE_QUERIES, SERVE_INSERTS, SERVE_DELETES, SERVE_CHUNK = 4096, 256, 128, 64
LIVE_SECONDS, LIVE_OPEN = 3.0, 256
# write batches between maintenance checks and between checkpoints
SERVE_CHECK_EVERY, SERVE_CKPT_EVERY = 16, 64
GUARD_REQUESTS = 320
MATRIX_OPS, MATRIX_CHUNK, MATRIX_CKPT_EVERY = 60, 10, 8
#: kernels every served stream launches (queries through the beam
#: megakernel, inserts through the gathers and the fused prefilter)
SERVE_PATH = ("beam", "simhash_encode", "gather_l2", "prefilter_gather")
# the sharded phase: the flat index over SIFT1M's count and width on 8
# shards, and on 7 (ragged: the last shard padded with 6 rows of +inf);
# the backend on 4 shards of the main path's id space (4 x 262,144 =
# 1,048,576 ids), its base cut from 131,072 rows (the bulk build is host
# numpy), and a short served stream over it (queries, inserts, deletes)
FLAT_ROWS, FLAT_SHARDS, RAGGED_SHARDS = 1_000_000, 8, 7
SHARDS, SHARD_CAP, SHARD_BASE, SHARD_INSERTS = 4, 1 << 18, 32_768, 1024
SHARD_SERVE = (512, 64, 32)
# the baselines at the settings of benchmarks/common.py
DISKANN_ROWS, DISKANN_KW = 32_768, dict(M=12, ef=48)
SPFRESH_ROWS, SPFRESH_KW = 131_072, dict(posting_cap=64, n_probe=3)
BASELINE_INSERTS = 256
#: kernels the sharded phase's run launches: the flat index's dense
#: distances, and the shards' searches (both routes) and inserts
SHARDED_PATH = ("l2_distance", "beam", "simhash_encode", "gather_l2",
                "prefilter_gather")


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, args_list, warmup: int = 3) -> float:
    """Median device time of one call of `fn`, cycling through inputs.

    Each timed call is queued behind a spin kernel that lasts about twice
    as long as the host takes to enqueue the call, so the CUDA events
    bracket the device's work alone, not the Python and launch overhead
    in front of it (which a small kernel's time would otherwise be).
    `fn` must not wait for the device."""
    import torch
    for a in args_list[:warmup]:
        fn(*a)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn(*args_list[0])
    host_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    spin = int(2 * host_s * SPIN_CYCLES_PER_S) + 1_000_000
    times = []
    for a in args_list:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin)
        start.record()
        fn(*a)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def build_ramp(n: int, batch: int = 64):
    """The [rows, placed] blocks `hnsw._incremental_graph` hands
    `l2_distance` for a layer of n nodes: a geometric ramp up to `batch`
    rows, then `batch` rows at a time."""
    bounds, step = [1], 1
    while bounds[-1] < n:
        bounds.append(min(bounds[-1] + step, n))
        step = min(batch, step * 2)
    return [(e - s, s) for s, e in zip(bounds[:-1], bounds[1:])]


def _bound(n_bytes, flops):
    """(bound ms, what bounds it) on the H100's f32 and HBM peaks."""
    t_b, t_f = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS
    return 1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


def _encode_bound(n, m_bits, d=DIM):
    """(bound ms, what bounds it) of `simhash_encode` over [n, d] rows and
    m_bits projections: 2 n m d f64 operations on the tensor cores against
    the bytes of the rows, the projections and the codes."""
    n_bytes = 4 * (n * d + m_bits * d) + 8 * n * (m_bits // 32)
    t_b, t_f = n_bytes / HBM_BYTES_PER_S, 2 * n * m_bits * d / F64_FLOPS
    return 1e3 * max(t_b, t_f), "bytes" if t_b >= t_f else "operations"


def host_us_per_call(gather_l2, q, table, ids, calls=1000, rounds=5):
    """Host µs per `gather_l2` call (wall time of `calls` back-to-back
    calls, median of `rounds`), with the entry point bound once as the
    wrapper does, and bound on every call (the library looked up under
    the build lock and its ctypes types set, as the wrappers did before
    they bound once); the two alternate, round by round."""
    import ctypes
    import torch
    from unittest import mock
    ops = sys.modules[gather_l2.__module__]

    def per_call(name, argtypes):
        fn = getattr(ops._build.library("gather_l2"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        return fn

    def wall_us():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            gather_l2(q, table, ids)
        us = (time.perf_counter() - t0) * 1e6 / calls
        torch.cuda.synchronize()
        return us

    wall_us()
    once, each = [], []
    for _ in range(rounds):
        once.append(wall_us())
        with mock.patch.object(ops, "_kernel", per_call):
            each.append(wall_us())
    return dict(bound_once=float(np.median(once)),
                bound_per_call=float(np.median(each)), calls=calls,
                rounds=rounds)


def kernel_shapes(dev, gather_l2, l2_distance, simhash_encode):
    """Device times of `gather_l2`, `l2_distance` and `simhash_encode` at
    the main path's shapes, each beside its bound: the encode at a
    search's 1,000 queries, an insert batch's 1,024 rows and the bulk
    build's 131,072 (d = 128, m = 64); the gather at `GATHER_SHAPES` over a
    cap-sized table (fresh ids every call, so rows come from device
    memory), the dense kernel at ground truth (1,000 x the base) and
    over the bottom layer's build ramp (`build_ramp`: every
    `RAMP_SAMPLE`-th block timed, each standing for the blocks up to the
    next sample: the middle block of each run of that many;
    `torch.cdist` timed at the same shapes), and the host
    time of one `gather_l2` call at [1, 8] (`host_us_per_call`);
    beside them the time the same timing reads for an empty kernel.
    Takes the wrappers as arguments, so it times another tree's."""
    import torch

    from repro_torch.data.synth import make_clustered_vectors
    # what the timing reads for a kernel that does nothing
    floor_ms = median_ms(lambda: torch.cuda._sleep(0), [()] * 30)
    g = torch.Generator(device=dev).manual_seed(2)
    table = torch.randn((CAP, DIM), generator=g, device=dev)
    qs = torch.randn((max(b for b, _, _ in GATHER_SHAPES), DIM), generator=g,
                     device=dev)
    gathers = []
    for b, k, caller in GATHER_SHAPES:
        q = qs[:b]
        id_sets = [torch.randint(0, N_BASE, (b, k), generator=g,
                                 device=dev).int() for _ in range(30)]
        ms = median_ms(lambda i: gather_l2(q, table, i),
                       [(i,) for i in id_sets])
        rows = float(np.median([int(torch.unique(i).numel())
                                for i in id_sets]))
        bound, by = _bound(4 * (b * DIM + 2 * b * k + rows * DIM),
                           3 * b * k * DIM)
        gathers.append(dict(shape=f"[{b}, {k}]", b=b, k=k, caller=caller,
                            ms=ms,
                            bound_ms=bound, bound_by=by))
    host_us = host_us_per_call(gather_l2, qs[:1], table, torch.randint(
        0, N_BASE, (1, 8), generator=g, device=dev).int())
    del table
    proj = torch.randn((64, DIM), generator=g, device=dev)
    encodes = []
    for n, caller in ((N_QUERIES, "search: query codes"),
                      (INSERT_WIDTH, "insert_batch: row codes"),
                      (N_BASE, "build: row codes")):
        x = torch.randn((n, DIM), generator=g, device=dev)
        bound, by = _encode_bound(n, 64)
        encodes.append(dict(shape=f"[{n}, {DIM}] m=64", caller=caller,
                            ms=median_ms(simhash_encode, [(x, proj)] * 10),
                            bound_ms=bound, bound_by=by))

    cv = torch.from_numpy(make_clustered_vectors(N_BASE, DIM, seed=11)).to(dev)
    qv = torch.from_numpy(make_clustered_vectors(N_QUERIES, DIM,
                                                 seed=12)).to(dev)

    def cdist(a, b):
        return torch.cdist(a, b, compute_mode="use_mm_for_euclid_dist")

    def dense_bound(nq, nc):
        return _bound(4 * (nq * DIM + nc * DIM + nq * nc), 2 * nq * nc * DIM)

    # yardstick of what the card's FFMA pipe sustains: cuBLAS's strict
    # f32 product alone (no norms, no clamp) at the same shapes
    cvt = cv.T.contiguous()
    gt_ms = median_ms(l2_distance, [(qv, cv)] * 10)
    gt_bound, gt_by = dense_bound(N_QUERIES, N_BASE)
    gt = dict(shape=f"{N_QUERIES}x{N_BASE}", ms=gt_ms, bound_ms=gt_bound,
              bound_by=gt_by,
              product_only_mm_ms=median_ms(torch.mm, [(qv, cvt)] * 10))
    last = cv[N_BASE - 64:]
    block = dict(shape=f"64x{N_BASE - 64} (the ramp's last block)",
                 ms=median_ms(l2_distance, [(last, cv[:N_BASE - 64])] * 10),
                 product_only_mm_ms=median_ms(
                     torch.mm, [(last, cvt[:, :N_BASE - 64])] * 10))
    del cvt
    blocks = build_ramp(N_BASE)
    ramp = dict(blocks=len(blocks), sampled=0, ms=0.0, bound_ms=0.0,
                cdist_ms=0.0)
    samples = []        # [rows, placed, ms, cdist ms] of each sample
    for first in range(0, len(blocks), RAMP_SAMPLE):
        weight = min(RAMP_SAMPLE, len(blocks) - first)
        rows, placed = blocks[first + weight // 2]
        a, b = cv[placed:placed + rows], cv[:placed]
        samples.append([rows, placed, median_ms(l2_distance, [(a, b)] * 5),
                        median_ms(cdist, [(a, b)] * 5)])
        ramp["ms"] += weight * samples[-1][2]
        ramp["cdist_ms"] += weight * samples[-1][3]
        ramp["sampled"] += 1
        ramp["bound_ms"] += weight * dense_bound(rows, placed)[0]
    ramp["shape"] = (f"[<=64, placed] x {len(blocks)} blocks, placed "
                     f"1..{blocks[-1][1]}, d={DIM}")
    return dict(gather=gathers, host_us_1x8=host_us, encode=encodes,
                ground_truth=gt,
                ramp=ramp, ramp_samples=samples, last_block=block,
                empty_kernel_ms=floor_ms)


def phase_kernels(dev):
    """The gather and dense-distance kernels against their plain versions
    on the card (the beam kernel needs a built index: `phase_beam`)."""
    import torch

    from repro_torch.data.synth import make_clustered_vectors
    from repro_torch.kernels.gather_l2.ops import gather_l2, gather_l2_q8
    from repro_torch.kernels.gather_l2.ref import (
        gather_l2_q8_ref,
        gather_l2_ref,
    )
    from repro_torch.kernels.l2_distance.ops import l2_distance
    from repro_torch.kernels.l2_distance.ref import l2_distance_ref

    g = torch.Generator(device=dev).manual_seed(0)
    checks = []
    # gather_l2: the per-hop fetch.  B=1000 query lanes, K = 16 (one
    # expanded row of M=16), 48, 64 (insert_batch's 4 x 16); d=128 rows
    # of the cap-sized table, and a ragged d=65
    for d, n_rows in ((128, CAP), (65, N_BASE)):
        table_i = torch.randint(-8, 9, (n_rows, d), generator=g,
                                device=dev).float()
        table_r = torch.randn((n_rows, d), generator=g, device=dev)
        for k in (16, 48, 64):
            ids = torch.randint(0, n_rows, (N_QUERIES, k), generator=g,
                                device=dev)
            ids[torch.rand((N_QUERIES, k), generator=g, device=dev) < 0.1] = -1
            ids = ids.int()
            for integer, tab in ((True, table_i), (False, table_r)):
                q = (torch.randint(-8, 9, (N_QUERIES, d), generator=g,
                                   device=dev).float()
                     if integer else torch.randn((N_QUERIES, d), generator=g,
                                                 device=dev))
                out = gather_l2(q, tab, ids)
                ref = gather_l2_ref(q, tab, ids)
                torch.cuda.synchronize()
                fin = torch.isfinite(ref)
                err = float((out[fin] - ref[fin]).abs().max())
                # bitwise on float data too: the plain version sums a row
                # in the kernel's order
                ok = torch.equal(out, ref)
                checks.append(dict(kernel="gather_l2", d=d, k=k,
                                   integer=integer, max_abs_err=err, ok=ok))
                if not ok:
                    raise AssertionError(f"gather_l2 disagrees: {checks[-1]}")
        del table_i, table_r
    # the chunk edges of the redesigned kernel (8 ids a warp): a lone
    # query (insert phase B) and K below, at, past and not a multiple of
    # one chunk, bitwise on integer and float data
    table_r = torch.randn((N_BASE, DIM), generator=g, device=dev)
    table_i = table_r.mul(4).round()
    for b, k in ((1, 1), (1, 7), (1, 8), (1, 9), (1, 16), (1, 100),
                 (N_QUERIES, 1), (N_QUERIES, 7), (N_QUERIES, 9),
                 (N_QUERIES, 100)):
        ids = torch.randint(-1, N_BASE, (b, k), generator=g,
                            device=dev).int()
        for integer, tab in ((True, table_i), (False, table_r)):
            q = torch.randn((b, DIM), generator=g, device=dev)
            if integer:
                q = q.mul(4).round()
            ok = torch.equal(gather_l2(q, tab, ids),
                             gather_l2_ref(q, tab, ids))
            checks.append(dict(kernel="gather_l2", b=b, d=DIM, k=k,
                               integer=integer, ok=ok))
            if not ok:
                raise AssertionError(f"gather_l2 disagrees: {checks[-1]}")
    del table_i, table_r
    # timing at the search path's shape: fresh ids every launch, so the
    # rows come from device memory as a hop's would
    table = torch.randn((CAP, DIM), generator=g, device=dev)
    q = torch.randn((N_QUERIES, DIM), generator=g, device=dev)
    id_sets = [torch.randint(0, N_BASE, (N_QUERIES, 16), generator=g,
                             device=dev).int() for _ in range(30)]
    out = gather_l2(q, table, id_sets[0])
    ref = gather_l2_ref(q, table, id_sets[0])
    g_err = float((out - ref).abs().max())
    g_ms = median_ms(lambda i: gather_l2(q, table, i), [(i,) for i in id_sets])
    g_plain = median_ms(lambda i: gather_l2_ref(q, table, i),
                        [(i,) for i in id_sets])
    rows = [int(torch.unique(i).numel()) for i in id_sets]
    g_bytes = 4 * (N_QUERIES * DIM + 2 * N_QUERIES * 16
                   + float(np.median(rows)) * DIM)
    g_flops = 3 * N_QUERIES * 16 * DIM
    g_bound = 1e3 * max(g_bytes / HBM_BYTES_PER_S, g_flops / F32_FLOPS)
    del table

    # gather_l2_q8: the cold lane's fetch, the same pairs over int8 rows of
    # a cap-sized table (and a ragged d=65): integer queries with
    # power-of-two scales (every distance exact) and float queries with
    # real scales, bitwise both
    for d, n_rows in ((DIM, CAP), (65, N_BASE)):
        qt = torch.randint(-127, 128, (n_rows, d), generator=g, device=dev,
                           dtype=torch.int8)
        sc_pow2 = 2.0 ** torch.randint(-3, 3, (n_rows,), generator=g,
                                       device=dev).float()
        sc_real = 0.1 * torch.rand((n_rows,), generator=g, device=dev)
        ids = torch.randint(0, n_rows, (N_QUERIES, 16), generator=g,
                            device=dev)
        ids[torch.rand((N_QUERIES, 16), generator=g, device=dev) < 0.1] = -1
        ids = ids.int()
        for integer in (True, False):
            q = (torch.randint(-20, 21, (N_QUERIES, d), generator=g,
                               device=dev).float()
                 if integer else torch.randn((N_QUERIES, d), generator=g,
                                             device=dev))
            sc = sc_pow2 if integer else sc_real
            out = gather_l2_q8(q, qt, sc, ids)
            ref = gather_l2_q8_ref(q, qt, sc, ids)
            torch.cuda.synchronize()
            fin = torch.isfinite(ref)
            err = float((out[fin] - ref[fin]).abs().max())
            ok = torch.equal(out, ref)
            checks.append(dict(kernel="gather_l2_q8", d=d, k=16,
                               integer=integer, max_abs_err=err, ok=ok))
            if not ok:
                raise AssertionError(f"gather_l2_q8 disagrees: {checks[-1]}")
        if d == DIM:
            # timing at the search path's shape, float queries, the same
            # fresh id sets as gather_l2's
            out = gather_l2_q8(q, qt, sc_real, id_sets[0])
            ref = gather_l2_q8_ref(q, qt, sc_real, id_sets[0])
            q8_err = float((out - ref).abs().max())
            q8_ms = median_ms(lambda i: gather_l2_q8(q, qt, sc_real, i),
                              [(i,) for i in id_sets])
            q8_plain = median_ms(
                lambda i: gather_l2_q8_ref(q, qt, sc_real, i),
                [(i,) for i in id_sets])
    # the chunk edges of the redesigned cold-lane kernel (8 ids a warp),
    # bitwise on float data
    qt = torch.randint(-127, 128, (N_BASE, DIM), generator=g, device=dev,
                       dtype=torch.int8)
    sc = 0.1 * torch.rand((N_BASE,), generator=g, device=dev)
    for b, k in ((1, 1), (1, 7), (1, 9), (1, 16), (N_QUERIES, 7),
                 (N_QUERIES, 9), (N_QUERIES, 64)):
        ids = torch.randint(-1, N_BASE, (b, k), generator=g,
                            device=dev).int()
        q = torch.randn((b, DIM), generator=g, device=dev)
        ok = torch.equal(gather_l2_q8(q, qt, sc, ids),
                         gather_l2_q8_ref(q, qt, sc, ids))
        checks.append(dict(kernel="gather_l2_q8", b=b, d=DIM, k=k, ok=ok))
        if not ok:
            raise AssertionError(f"gather_l2_q8 disagrees: {checks[-1]}")
    q8_bytes = (4 * N_QUERIES * DIM + 2 * 4 * N_QUERIES * 16
                + float(np.median(rows)) * (DIM + 4))
    q8_flops = 4 * N_QUERIES * 16 * DIM
    q8_bound = 1e3 * max(q8_bytes / HBM_BYTES_PER_S, q8_flops / F32_FLOPS)
    del qt, id_sets

    # l2_distance: ground truth (1,000 queries x the base) and the
    # bulk-build block (64 arrivals x the placed nodes), plus ragged
    cv = torch.from_numpy(make_clustered_vectors(N_BASE, DIM, seed=11)).to(dev)
    qv = torch.from_numpy(make_clustered_vectors(N_QUERIES, DIM,
                                                 seed=12)).to(dev)
    l_err = None
    for qq, cc in ((qv, cv), (qv[:37], cv[:1001]), (cv[:64], cv[64:80000]),
                   (qv[:100, :65].contiguous(), cv[:3000, :65].contiguous())):
        out = l2_distance(qq, cc)
        ref = l2_distance_ref(qq, cc)
        torch.cuda.synchronize()
        scale = max(float((qq * qq).sum(1).max()), float((cc * cc).sum(1).max()))
        err = float((out - ref).abs().max())
        ok = bool(torch.allclose(out, ref, rtol=1e-5, atol=1e-3 * scale)) \
            and bool((out >= 0).all())
        checks.append(dict(kernel="l2_distance", q=qq.shape[0], n=cc.shape[0],
                           d=qq.shape[1], max_abs_err=err,
                           atol=1e-3 * scale, ok=ok))
        if not ok:
            raise AssertionError(f"l2_distance disagrees: {checks[-1]}")
        if l_err is None:
            l_err = err
    # integer-valued data: every product and partial sum is exact in
    # f32, so the kernel must give the plain version's bits, on both
    # tiles (a build block and ground truth)
    qi, ci = qv.mul(4).round(), cv.mul(4).round()
    for qq, cc in ((qi, ci), (ci[:64], ci[64:80000]), (ci[:37], ci[37:5000])):
        ok = torch.equal(l2_distance(qq, cc), l2_distance_ref(qq, cc))
        checks.append(dict(kernel="l2_distance", q=qq.shape[0],
                           n=cc.shape[0], d=DIM, integer=True, ok=ok))
        if not ok:
            raise AssertionError(f"l2_distance disagrees: {checks[-1]}")
    del qi, ci
    reps = [(qv, cv)] * 10
    l_ms = median_ms(l2_distance, reps)
    l_plain = median_ms(l2_distance_ref, reps)
    l_lib = median_ms(lambda a, b: torch.cdist(
        a, b, compute_mode="use_mm_for_euclid_dist"), reps)
    l_flops = 2 * N_QUERIES * N_BASE * DIM
    l_bytes = 4 * (N_QUERIES * DIM + N_BASE * DIM + N_QUERIES * N_BASE)
    l_bound = 1e3 * max(l_bytes / HBM_BYTES_PER_S, l_flops / F32_FLOPS)
    simhash_rows = _simhash_kernels(dev, g, checks)
    fused_row = _prefilter_kernel(dev, g, checks)
    emit({"phase": "kernels", "checks": checks})
    from repro_torch.kernels.simhash.ops import simhash_encode
    shapes = kernel_shapes(dev, gather_l2, l2_distance, simhash_encode)
    emit({"phase": "kernel_shapes", **shapes})
    simhash_rows["simhash_encode"]["shapes"] = shapes["encode"]
    return {**simhash_rows, FUSED_FETCH: fused_row,
        "gather_l2": dict(
            name="gather_l2", route="cuda",
            source="src/repro_torch/kernels/csrc/gather_l2.cu",
            replaces="src/repro/kernels/gather_l2/kernel.py:38",
            max_abs_err=g_err, ms=g_ms, plain_ms=g_plain, bound_ms=g_bound,
            bound_by=("bytes" if g_bytes / HBM_BYTES_PER_S
                      >= g_flops / F32_FLOPS else "operations"),
            library_ms=None,
            shape=f"B={N_QUERIES} K=16 d={DIM} table={CAP}x{DIM}",
            shapes=shapes["gather"], host_us_1x8=shapes["host_us_1x8"]),
        "gather_l2_q8": dict(
            name="gather_l2_q8", route="cuda",
            source="src/repro_torch/kernels/csrc/gather_l2.cu",
            replaces="src/repro/kernels/gather_l2/kernel.py:79",
            max_abs_err=q8_err, ms=q8_ms, plain_ms=q8_plain,
            bound_ms=q8_bound,
            bound_by=("bytes" if q8_bytes / HBM_BYTES_PER_S
                      >= q8_flops / F32_FLOPS else "operations"),
            library_ms=None,
            shape=f"B={N_QUERIES} K=16 d={DIM} int8 table={CAP}x{DIM}"),
        "l2_distance": dict(
            name="l2_distance", route="cuda",
            source="src/repro_torch/kernels/csrc/l2_distance.cu",
            replaces="src/repro/kernels/l2_distance/kernel.py:35",
            max_abs_err=l_err, ms=l_ms, plain_ms=l_plain, bound_ms=l_bound,
            bound_by=("operations" if l_flops / F32_FLOPS
                      >= l_bytes / HBM_BYTES_PER_S else "bytes"),
            library_ms=l_lib, library="torch.cdist (the root of this)",
            shape=f"Q={N_QUERIES} N={N_BASE} d={DIM}",
            shapes=[shapes["ground_truth"], shapes["ramp"]]),
    }


def _encode_cases(dev, g):
    """(label, x, proj) at the encode's edges, float data unless named:
    every n x d x m of the grid below (the narrow and the wide tile, ragged
    tiles, depths that are not a whole DMMA step, one to eight words, and
    m x d too large to hold in shared memory at d = 256, m = 256), a row
    block that is not 16-byte aligned (scalar loads), 2,048 projections
    (staged per pass), and integer rows and projections built so that
    the projections of every third row are exactly 0."""
    import torch

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    for n in (0, 1, 15, 16, 17, 1000, 1024, 4097, 131072):
        for d in (16, 65, 128, 256):
            x = randn(n, d)
            for m in (32, 64, 128, 256):
                yield f"n={n} d={d} m={m}", x, randn(m, d)
    yield "x[1:] of [1001, 65] (not 16-byte aligned), m=64", \
        randn(1001, 65)[1:], randn(64, 65)
    yield "n=4097 d=128 m=2048", randn(4097, DIM), randn(2048, DIM)
    # every projection's second half repeats its first and every third
    # row's second half negates its first: those rows' projections are 0
    h = DIM // 2
    for n in (4097, N_BASE):
        x = torch.randint(-3, 4, (n, DIM), generator=g, device=dev).float()
        proj = torch.randint(-3, 4, (64, DIM), generator=g,
                             device=dev).float()
        proj[:, h:] = proj[:, :h]
        x[::3, h:] = -x[::3, :h]
        yield f"integer, exact zeros, n={n} d={DIM} m=64", x, proj


def _simhash_kernels(dev, g, checks):
    """The three SimHash entries against their plain versions, bitwise:
    encode at the bulk build's call (131,072 rows, d = 128, m = 64), a
    search's and `_encode_cases`; all pairs (1,000 query codes x 131,072);
    gathered (1,000 x 16 ids over a cap-sized code table, with -1 and
    out-of-range ids).  No single PyTorch call computes these functions,
    so there is no library yardstick."""
    import torch

    from repro_torch.kernels.simhash.ops import (
        collision_count,
        collision_count_rows,
        simhash_encode,
    )
    from repro_torch.kernels.simhash.ref import (
        collision_count_ref,
        collision_count_rows_ref,
        simhash_encode_ref,
    )

    m_bits = 64
    words = m_bits // 32
    proj = torch.randn((m_bits, DIM), generator=g, device=dev)
    x = torch.randn((N_BASE, DIM), generator=g, device=dev)
    qx = torch.randn((N_QUERIES, DIM), generator=g, device=dev)
    for xx, pp in ((x, proj), (qx, proj)):
        ok = torch.equal(simhash_encode(xx, pp), simhash_encode_ref(xx, pp))
        checks.append(dict(kernel="simhash_encode", n=xx.shape[0],
                           d=xx.shape[1], m_bits=pp.shape[0], ok=ok))
        if not ok:
            raise AssertionError(f"simhash_encode disagrees: {checks[-1]}")
    labels = []
    for label, xx, pp in _encode_cases(dev, g):
        got = simhash_encode(xx, pp)
        ok = torch.equal(got, simhash_encode_ref(xx, pp))
        if ok and label.startswith("integer"):
            ok = bool((got[::3] == 2 ** 32 - 1).all())
        if not ok:
            raise AssertionError(f"simhash_encode disagrees: {label}")
        labels.append(label)
    checks.append(dict(kernel="simhash_encode", bitwise_cases=len(labels),
                       edges=labels[-4:], ok=True))
    codes_c = simhash_encode(x, proj)
    codes_q = simhash_encode(qx, proj)
    e_ms = median_ms(simhash_encode, [(x, proj)] * 10)
    e_plain = median_ms(simhash_encode_ref, [(x, proj)] * 10)
    e_bound, e_by = _encode_bound(N_BASE, m_bits)

    out = collision_count(codes_q, codes_c, m_bits)
    ok = torch.equal(out, collision_count_ref(codes_q, codes_c, m_bits))
    checks.append(dict(kernel="collision_count", q=N_QUERIES, n=N_BASE,
                       m_bits=m_bits, ok=ok))
    if not ok:
        raise AssertionError(f"collision_count disagrees: {checks[-1]}")
    del out
    a_ms = median_ms(collision_count, [(codes_q, codes_c, m_bits)] * 10)
    a_plain = median_ms(collision_count_ref,
                        [(codes_q, codes_c, m_bits)] * 5, warmup=1)
    a_bytes = 8 * (N_QUERIES + N_BASE) * words + 4 * N_QUERIES * N_BASE

    table = torch.randint(0, 2 ** 32, (CAP, words), generator=g, device=dev)
    id_sets = []
    for _ in range(30):
        ids = torch.randint(0, CAP, (N_QUERIES, 16), generator=g, device=dev)
        ids[torch.rand((N_QUERIES, 16), generator=g, device=dev) < 0.1] = -1
        id_sets.append(ids.int())
    edge = id_sets[0].clone()
    edge[:, :3] = torch.tensor([CAP - 1, CAP, CAP + 7], dtype=torch.int32,
                               device=dev)
    for ids in (id_sets[0], edge):
        got = collision_count_rows(codes_q, table, ids, m_bits)
        ok = torch.equal(got, collision_count_rows_ref(codes_q, table, ids,
                                                       m_bits))
        checks.append(dict(kernel="collision_count_rows", q=N_QUERIES,
                           n=16, table=CAP, m_bits=m_bits, ok=ok))
        if not ok:
            raise AssertionError(f"collision_count_rows disagrees: "
                                 f"{checks[-1]}")
    r_ms = median_ms(lambda i: collision_count_rows(codes_q, table, i,
                                                    m_bits),
                     [(i,) for i in id_sets])
    r_plain = median_ms(lambda i: collision_count_rows_ref(codes_q, table, i,
                                                           m_bits),
                        [(i,) for i in id_sets])
    rows = float(np.median([int(torch.unique(i[i >= 0]).numel())
                            for i in id_sets]))
    r_bytes = 2 * 4 * N_QUERIES * 16 + 8 * words * (N_QUERIES + rows)
    del table, id_sets
    src = "src/repro_torch/kernels/csrc/simhash.cu"
    return {
        "simhash_encode": dict(
            name="simhash_encode", route="cuda", source=src,
            replaces="src/repro/kernels/simhash/kernel.py:38",
            max_abs_err=0.0, ms=e_ms, plain_ms=e_plain,
            bound_ms=e_bound, bound_by=e_by, library_ms=None,
            shape=f"N={N_BASE} d={DIM} m_bits={m_bits} (f64 sums)"),
        # one row for the TPU function, keyed by the counter of its
        # gathered entry, the form on the main path; the all-pairs entry,
        # the TPU function itself, is held and timed beside it
        "collision_count_rows": dict(
            name="collision_count", route="cuda", source=src,
            replaces="src/repro/kernels/simhash/kernel.py:70",
            max_abs_err=0.0, ms=r_ms, plain_ms=r_plain,
            bound_ms=1e3 * r_bytes / HBM_BYTES_PER_S, bound_by="bytes",
            library_ms=None,
            shape=f"collision_count_rows: Q={N_QUERIES} n=16 "
                  f"table={CAP}x{words}",
            entries={"collision_count_rows": "the numbers above",
                     "collision_count": dict(
                         ms=a_ms, plain_ms=a_plain,
                         bound_ms=1e3 * a_bytes / HBM_BYTES_PER_S,
                         bound_by="bytes", library_ms=None,
                         shape=f"Q={N_QUERIES} N={N_BASE} W={words}")}),
    }


def _trip_operands(dev, g, b, n, d, n_rows):
    """A loop trip's fetch operands over `n_rows` rows (ids drawn from the
    first N_BASE, fresh each call): f32 queries and table, int64 SimHash
    codes (m = 64), int32 rows, eligible bytes (3 in 4, as a trip's
    unvisited live neighbours) and a threshold that 96 % of random codes
    clear (a trip filters about 4 % of the eligible, PERF.md §6), -inf on
    every tenth query (a beam not yet full); the tier lanes: half the
    rows resident, int8 rows, real scales."""
    import torch
    table = torch.randn((n_rows, d), generator=g, device=dev)
    qs = torch.randn((b, d), generator=g, device=dev)
    codes = torch.randint(0, 2 ** 32, (n_rows, 2), generator=g, device=dev)
    code_q = torch.randint(0, 2 ** 32, (b, 2), generator=g, device=dev)
    thr = torch.full((b,), 25.0, device=dev)
    thr[::10] = -float("inf")
    tier = (torch.rand((n_rows,), generator=g, device=dev) < 0.5,
            torch.randint(-127, 128, (n_rows, d), generator=g, device=dev,
                          dtype=torch.int8),
            0.1 * torch.rand((n_rows,), generator=g, device=dev))

    def blocks(count):
        out = []
        for _ in range(count):
            row = torch.randint(0, min(N_BASE, n_rows), (b, n), generator=g,
                                device=dev).int()
            out.append((row, torch.rand((b, n), generator=g, device=dev)
                        < 0.75))
        return out
    return (qs, table, code_q, codes, thr), tier, blocks


def _fetch_bytes(base, tier, row, eligible, mask):
    """Bytes one prefilter_gather call must move, each distinct row once:
    ids, eligible bytes, the code rows of the distinct eligible ids (and
    their resident bytes under the tier), the rows of the distinct
    survivors (4 d f32, d + 4 int8 with its scale), the queries, their
    codes and thresholds, and the mask and distance outputs."""
    import torch
    qs, codes = base[0], base[3]
    b, n = row.shape
    d, words = qs.shape[1], codes.shape[1]
    elig_ids = torch.unique(row[eligible])
    fetched = torch.unique(row[mask])
    n_bytes = (4 + 1) * b * n + 8 * words * elig_ids.numel() \
        + b * (4 * d + 8 * words + 4) + (1 + 4) * b * n
    if tier is None:
        return n_bytes + 4 * d * fetched.numel()
    res = tier[0][fetched.long()]
    return n_bytes + elig_ids.numel() + 4 * d * int(res.sum()) \
        + (d + 4) * int((~res).sum())


def _prefilter_kernel(dev, g, checks):
    """prefilter_gather against its plain version on the card, bitwise on
    float data, mask and distances, at a search trip's [1,000, 16], an
    insert batch's [1,024, 16], a lone item's [1, 16] and n_expand = 4's
    [1,000, 64], d in {128, 65}, both lanes; timed at [1,000, 16] over the
    cap-sized table (fresh rows every call), f32 lane and tier, beside
    its bound (`_fetch_bytes`: the run's own survivors) and the plain
    version.  No single PyTorch call computes the function."""
    import torch

    from repro_torch.kernels.prefilter_gather.ops import prefilter_gather
    from repro_torch.kernels.prefilter_gather.ref import prefilter_gather_ref

    for d, n_rows in ((DIM, N_BASE), (65, 20_000)):
        base, tier_lanes, blocks = _trip_operands(dev, g, N_QUERIES + 24, 64,
                                                  d, n_rows)
        for b, n in ((N_QUERIES, 16), (INSERT_WIDTH, 16), (1, 16),
                     (N_QUERIES, 64)):
            qs, table, code_q, codes, thr = base
            args = (qs[:b], table, code_q[:b], codes)
            row, elig = blocks(1)[0]
            row, elig = row[:b, :n].contiguous(), elig[:b, :n].contiguous()
            for tier in (None, tier_lanes):
                got = prefilter_gather(*args, row, elig, thr[:b], tier=tier)
                want = prefilter_gather_ref(*args, row, elig, thr[:b],
                                            tier=tier)
                ok = torch.equal(got[0], want[0]) \
                    and torch.equal(got[1], want[1])
                checks.append(dict(kernel=FUSED_FETCH, b=b, n=n, d=d,
                                   tier=tier is not None, ok=ok,
                                   survivors=int(got[0].sum())))
                if not ok:
                    raise AssertionError(f"{FUSED_FETCH} disagrees: "
                                         f"{checks[-1]}")
    base, tier_lanes, blocks = _trip_operands(dev, g, N_QUERIES, 16, DIM, CAP)
    sets = blocks(30)
    shapes = []
    for tier in (None, tier_lanes):
        def call(row, elig):
            return prefilter_gather(*base[:4], row, elig, base[4], tier=tier)

        def plain(row, elig):
            return prefilter_gather_ref(*base[:4], row, elig, base[4],
                                        tier=tier)
        ms = median_ms(call, sets)
        plain_ms = median_ms(plain, sets)
        n_bytes = float(np.median([_fetch_bytes(base, tier, r, e,
                                                call(r, e)[0])
                                   for r, e in sets]))
        got, want = call(*sets[0]), plain(*sets[0])
        fin = torch.isfinite(want[1])
        shapes.append(dict(
            shape=f"[{N_QUERIES}, 16] d={DIM} table={CAP}x{DIM}",
            **{"class": "f32" if tier is None else "tier"},
            ms=ms, plain_ms=plain_ms,
            bound_ms=1e3 * n_bytes / HBM_BYTES_PER_S, bound_by="bytes",
            max_abs_err=float((got[1][fin] - want[1][fin]).abs().max()),
            survivors_per_call=float(got[0].sum())))
    del base, tier_lanes, sets
    f32 = shapes[0]
    return dict(
        name=FUSED_FETCH, route="cuda",
        source="src/repro_torch/kernels/csrc/gather_l2.cu",
        # on the loop trip it stands for the gathered collision count and
        # the gathers of both lanes
        replaces="src/repro/kernels/simhash/kernel.py:70",
        fuses=["src/repro/kernels/simhash/kernel.py:70",
               "src/repro/kernels/gather_l2/kernel.py:38",
               "src/repro/kernels/gather_l2/kernel.py:79"],
        max_abs_err=f32["max_abs_err"], ms=f32["ms"],
        plain_ms=f32["plain_ms"], bound_ms=f32["bound_ms"],
        bound_by="bytes", library_ms=None, shapes=shapes)


KERNEL_NAMES = ("gather_l2", "gather_l2_q8", "l2_distance", "beam",
                "simhash_encode", "collision_count_rows", "collision_count",
                "prefilter_gather")
# the wrappers that also count their launches by shape class
BY_CLASS = ("gather_l2", "l2_distance", "prefilter_gather")
# the all-pairs collision count lies on no path of the system (the
# reference's core runs only the plain form too).  On the main path's
# configuration (filter on, rho = 1) every loop trip's prefilter and
# fetch are one prefilter_gather launch, so the standalone gathered
# count and the cold-lane gather serve only the sampling cap (rho < 1,
# the `beam` phase's loop runs); all three are held against their plain
# versions and timed in the kernels phase
OFF_PATH = ("collision_count", "collision_count_rows", "gather_l2_q8")
#: the loop trip's fused prefilter + fetch, on every loop-route search
#: and every insert_batch's phase A
FUSED_FETCH = "prefilter_gather"


def launch_counters():
    """The wrappers whose `.launches` count each kernel's launches."""
    from repro_torch.kernels.beam.ops import fused_beam_search
    from repro_torch.kernels.gather_l2.ops import gather_l2, gather_l2_q8
    from repro_torch.kernels.l2_distance.ops import l2_distance
    from repro_torch.kernels.prefilter_gather.ops import prefilter_gather
    from repro_torch.kernels.simhash.ops import (
        collision_count,
        collision_count_rows,
        simhash_encode,
    )
    return dict(zip(KERNEL_NAMES, (gather_l2, gather_l2_q8, l2_distance,
                                   fused_beam_search, simhash_encode,
                                   collision_count_rows, collision_count,
                                   prefilter_gather)))


def counted(step, fn):
    """Run one step of the main path with the kernel launch counts and
    host-sync count zeroed just before it and read just after."""
    import torch

    from repro_torch._device import host_any
    wrappers = launch_counters()
    for w in wrappers.values():
        w.launches = 0
    for n in BY_CLASS:
        wrappers[n].by_class.clear()
    host_any.syncs = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out, dict(step=step, seconds=secs,
                     launches={n: w.launches for n, w in wrappers.items()},
                     by_class={n: dict(wrappers[n].by_class)
                               for n in BY_CLASS},
                     host_syncs=host_any.syncs)


def check_result(res, queries, vectors, live) -> None:
    """A search result is well formed: [nq, K], ids distinct, live and in
    range, dists ascending and equal to the returned rows' distances."""
    ids, dists = res.ids, res.dists
    if ids.shape != (len(queries), K) or dists.shape != ids.shape:
        raise AssertionError(f"result shape {ids.shape}")
    found = ids >= 0
    if not found.all(1).any() or not np.isfinite(dists[found]).all():
        raise AssertionError("empty or non-finite search result")
    if (ids >= len(vectors)).any() or not live[ids[found]].all():
        raise AssertionError("search returned a dead or unallocated id")
    if any(len(set(r[r >= 0].tolist())) != int((r >= 0).sum()) for r in ids):
        raise AssertionError("search returned a repeated id")
    if (np.diff(np.where(found, dists, np.inf), axis=1) < 0).any():
        raise AssertionError("search distances are not ascending")
    rows = vectors[np.maximum(ids, 0)]
    exact = ((rows - queries[:, None, :].astype(np.float64)) ** 2).sum(-1)
    if not np.allclose(dists[found], exact[found], rtol=1e-5, atol=1e-3):
        raise AssertionError("search distances disagree with the rows")


def search_step(name, index, snap, queries, truth, vectors, live, dels=(),
                id_map=None):
    """One counted 1,000-query search, checked and emitted: no deleted id
    returned, a well-formed result (`check_result`), the SimHash query
    encode launched on every route, on the loop routes `prefilter_gather`
    launched and the standalone `collision_count_rows` not (every trip's
    prefilter runs inside the fused fetch, so nothing counts twice),
    recall@10 against `truth` (ids mapped through `id_map` first, where
    the index renumbered them)."""
    from repro_torch.core.backend import SearchParams
    from repro_torch.core.index import recall_at_k
    res, rec = counted(name, lambda: index.search(
        queries, K, params=SearchParams(use_snapshot=snap)))
    n_bad = int(np.isin(res.ids, dels).sum())
    found = res.ids if id_map is None else np.where(
        res.ids >= 0, id_map[np.maximum(res.ids, 0)], -1)
    rec.update(qps=N_QUERIES / rec["seconds"],
               recall_at_10=recall_at_k(found, truth),
               deleted_returned=n_bad)
    emit(rec)
    if n_bad:
        raise AssertionError(f"{n_bad} deleted ids returned")
    check_result(res, queries, vectors, live)
    # recall on this data is low at this size (0.1995 for the first
    # search, the same on the CPU route): the floor only catches breakage
    if rec["recall_at_10"] < RECALL_FLOOR:
        raise AssertionError(f"recall too low: {rec}")
    fused = index.cfg.fused_beam and snap
    for kname in ("simhash_encode",) + (() if fused else (FUSED_FETCH,)):
        if rec["launches"][kname] == 0:
            raise AssertionError(f"{name} never launched {kname}")
    if rec["launches"]["collision_count_rows"]:
        raise AssertionError(f"{name} launched collision_count_rows beside "
                             f"{FUSED_FETCH}: {rec['launches']}")
    return res, rec


@contextmanager
def phase_b_collisions():
    """Count, while the block runs, the upper-layer routings of inserted
    items (`hnsw._insert_upper`: insert_batch's phase B) and the
    `collision_count_rows` launches made inside them."""
    from repro_torch.core import hnsw
    from repro_torch.kernels.simhash.ops import collision_count_rows
    insert_upper = hnsw._insert_upper
    out = dict(calls=0, launches=0)

    def counted_upper(*args, **kw):
        before = collision_count_rows.launches
        try:
            return insert_upper(*args, **kw)
        finally:
            out["calls"] += 1
            out["launches"] += collision_count_rows.launches - before

    hnsw._insert_upper = counted_upper
    try:
        yield out
    finally:
        hnsw._insert_upper = insert_upper


@contextmanager
def overlay_capture():
    """Keep, while the block runs, the overlay (staged rows and their
    mask) of every `hnsw.insert_batch` that returns one: what the index
    patches its fresh snapshot with."""
    from repro_torch.core import hnsw
    insert_batch = hnsw.insert_batch
    out = []

    def capturing(*args, **kw):
        res = insert_batch(*args, **kw)
        if kw.get("return_overlay"):
            out.append(res[2])
        return res

    hnsw.insert_batch = capturing
    try:
        yield out
    finally:
        hnsw.insert_batch = insert_batch


def wall_s(fn, reps: int = 3):
    """(median wall seconds of `reps` synchronized calls, last result)."""
    import torch
    times, out = [], None
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def check_patch(index, snap_before, overlays, step):
    """The snapshot `insert_batch` patched against a fresh resolve of the
    tree, bitwise, with the seconds of the patch and of the re-resolve
    it replaced."""
    import torch

    from repro_torch.core import lsm
    from repro_torch.core.index import patch_snapshot
    if snap_before is None or len(overlays) != 1 or index.snapshot_stale:
        raise AssertionError(f"{step}: the fresh snapshot was not patched")
    patch_s, _ = wall_s(lambda: patch_snapshot(snap_before, *overlays[0]))
    resolve_s, fresh = wall_s(lambda: lsm.snapshot_rows(
        index.cfg.lsm_cfg, index.state.store, index.cfg.cap))
    same = bool(torch.equal(index._snap, fresh))
    rec = {"step": step + "_snapshot_patch", "patched_equals_fresh": same,
           "patch_seconds": patch_s, "resolve_seconds": resolve_s,
           "rows_patched": int(overlays[0][1][:index.cfg.cap].sum()),
           "snap_patches": index.snap_patches}
    emit(rec)
    if not same:
        raise AssertionError(f"{step}: the patched snapshot differs from a "
                             "fresh resolve")
    return rec


def view(idx, **flags):
    """An index over `idx`'s state under another configuration (the
    fused route, the tier lanes), its snapshot resolved up front as the
    serving index's cached one is."""
    from repro_torch.core.index import LSMVecIndex
    v = LSMVecIndex(idx.cfg._replace(**flags), state=idx.state,
                    device=idx.device)
    v.snapshot()
    return v


def phase_main_path(dev):
    import torch

    from repro_torch.core.hnsw import HNSWConfig
    from repro_torch.core.index import LSMVecIndex, brute_force_knn
    from repro_torch.data.synth import make_clustered_vectors
    from repro_torch.tier import TierPolicy

    cfg = HNSWConfig(cap=CAP, dim=DIM)
    n_ins = INSERT_BATCHES * INSERT_WIDTH
    data = make_clustered_vectors(N_BASE + n_ins, DIM, seed=0)
    base, extra = data[:N_BASE], data[N_BASE:]
    queries = make_clustered_vectors(N_QUERIES, DIM, seed=1)
    emit({"phase": "main_path", "reduced": {
        "base_rows": N_BASE, "of": 1_000_000, "cap": CAP,
        "why": "bulk build is host numpy with a Python loop over every "
               "node and one [64, placed] distance block copied to the host "
               "per 64 nodes; 1,000,000 rows do not fit the run's time"}})
    steps = []
    totals = dict.fromkeys(KERNEL_NAMES, 0)
    class_totals = {n: Counter() for n in BY_CLASS}

    def tally(rec):
        for kname, n in rec["launches"].items():
            totals[kname] += n
        for kname in BY_CLASS:
            class_totals[kname].update(rec["by_class"][kname])
        steps.append(rec)

    def step(name, fn, **extra_fields):
        out, rec = counted(name, fn)
        rec.update(extra_fields)
        tally(rec)
        return out, rec

    def search(name, index, snap, truth, vectors, live, dels=()):
        res, rec = search_step(name, index, snap, queries, truth, vectors,
                               live, dels)
        tally(rec)
        return res, rec

    def search_routes(prefix, truth, vectors, live, dels=(), probe=True):
        """The loop routes, then the fused route, whose ids and dists
        must equal the snapshot loop route's bitwise."""
        if probe:
            search(prefix + "_lsm_probe", idx, False, truth, vectors, live,
                   dels)
        idx.snapshot()
        snap, _ = search(prefix + "_snapshot", idx, True, truth, vectors,
                         live, dels)
        fused = view(idx, fused_beam=True)
        res, rec = search(prefix + "_fused", fused, True, truth, vectors,
                          live, dels)
        same = bool(np.array_equal(res.ids, snap.ids)
                    and np.array_equal(res.dists, snap.dists))
        emit({"step": rec["step"], "ids_and_dists_equal_snapshot": same})
        if not same:
            raise AssertionError(f"{rec['step']}: the fused route's ids "
                                 "differ from the snapshot route's")
        return snap

    torch.cuda.reset_peak_memory_stats(dev)
    idx, rec = step("build", lambda: LSMVecIndex.build(cfg, base, seed=0))
    emit(rec)
    truth, rec = step("ground_truth",
                      lambda: brute_force_knn(base, queries, K))
    emit(rec)
    all_live = np.ones(N_BASE, bool)
    search_routes("search", truth, base, all_live)
    for b in range(INSERT_BATCHES):
        rows = extra[b * INSERT_WIDTH:(b + 1) * INSERT_WIDTH]
        snap_before = None if idx.snapshot_stale else idx._snap
        with phase_b_collisions() as phase_b, overlay_capture() as overlays:
            res, rec = step(f"insert_batch_{b}",
                            lambda: idx.insert_batch(rows))
        want = np.arange(N_BASE + b * INSERT_WIDTH,
                         N_BASE + (b + 1) * INSERT_WIDTH)
        if not np.array_equal(res.ids, want):
            raise AssertionError("insert_batch returned unexpected ids")
        rec.update(inserts_per_s=INSERT_WIDTH / rec["seconds"],
                   phase_b_upper_connects=phase_b["calls"],
                   phase_b_collision_count_rows=phase_b["launches"])
        emit(rec)
        # phase B's upper connects search with the filter off and rho = 1,
        # where no decision reads a collision count; phase A's trips count
        # theirs inside the fused fetch
        if phase_b["calls"] == 0 or phase_b["launches"]:
            raise AssertionError(f"insert_batch phase B: {phase_b}")
        if rec["launches"]["collision_count_rows"] \
                or not rec["launches"][FUSED_FETCH]:
            raise AssertionError(f"insert_batch phase A: {rec['launches']}")
        check_patch(idx, snap_before, overlays, f"insert_batch_{b}")
    allv = data
    n_all = len(allv)
    truth_all, rec = step("ground_truth_all",
                          lambda: brute_force_knn(allv, queries, K))
    emit(rec)
    search_routes("search_after_insert", truth_all, allv,
                  np.ones(n_all, bool), probe=False)

    rng = np.random.default_rng(3)
    dels = rng.choice(n_all, int(DELETE_FRACTION * n_all), replace=False)
    _, rec = step("delete_batch", lambda: idx.delete_batch(dels),
                  deleted=len(dels))
    emit(rec)
    live = np.ones(n_all, bool)
    live[dels] = False
    truth_live, rec = step("ground_truth_live", lambda: brute_force_knn(
        allv, queries, K, live=live))
    emit(rec)
    search_routes("search_after_delete", truth_live, allv, live, dels)
    rep, rec = step("consolidate", lambda: idx.maintain("consolidate"))
    rec.update(reclaimed=rep.reclaimed)
    emit(rec)
    if rep.reclaimed != len(dels) or idx.n_tombstones != 0:
        raise AssertionError(f"consolidate reclaimed {rep.reclaimed}")
    final = {}
    for snap in (False, True):
        if snap:
            idx.snapshot()
        res, rec = search("search_after_consolidate"
                          + ("_snapshot" if snap else "_lsm_probe"),
                          idx, snap, truth_live, allv, live, dels)
        final[snap] = (res, rec["recall_at_10"])
    res, _ = search("search_after_consolidate_fused",
                    view(idx, fused_beam=True), True, truth_live, allv,
                    live, dels)
    if not (np.array_equal(res.ids, final[True][0].ids)
            and np.array_equal(res.dists, final[True][0].dists)):
        raise AssertionError("the fused route's ids differ after "
                             "consolidate")

    # the tiered store: demote the cold three quarters by the heat the
    # searches above recorded, then search on the int8 lane with the
    # exact rerank, by the snapshot loop route and by the fused route
    peak_gib = torch.cuda.max_memory_allocated(dev) / 2 ** 30
    torch.cuda.reset_peak_memory_stats(dev)
    rep, rec = step("tier_maintain", lambda: idx.maintain(
        "tier", policy=TierPolicy(**TIER_POLICY)))
    rec.update(demoted=rep.demoted, promoted=rep.promoted)
    emit(rec)
    if rep.demoted == 0:
        raise AssertionError("the tier pass demoted nothing")
    t_loop, _ = search("search_tier_snapshot", view(idx, tier=True), True,
                       truth_live, allv, live, dels)
    t_fused, _ = search("search_tier_fused",
                        view(idx, tier=True, fused_beam=True), True,
                        truth_live, allv, live, dels)
    same = bool(np.array_equal(t_loop.ids, t_fused.ids)
                and np.array_equal(t_loop.dists, t_fused.dists))
    emit({"phase": "tier", "demoted": rep.demoted, "promoted": rep.promoted,
          "cold_rows": int((~(idx.state.hot | (idx.state.levels > 0))
                            & (idx.state.levels >= 0)).sum()),
          "ids_and_dists_equal_fused": same,
          "peak_memory_gib_since_tier_step":
              torch.cuda.max_memory_allocated(dev) / 2 ** 30})
    if not same:
        raise AssertionError("tiered search: the fused route's ids differ "
                             "from the loop route's")
    for kname, n in totals.items():
        if n == 0 and kname not in OFF_PATH:
            raise AssertionError(f"main path never launched {kname}")
    class_totals = {n: dict(c) for n, c in class_totals.items()}
    emit({"phase": "main_path", "launches": totals,
          "launches_by_class": class_totals,
          "peak_memory_gib_before_tier_step": peak_gib,
          "host_syncs_per_search": {
              r["step"]: r["host_syncs"] for r in steps
              if r["step"].startswith("search")}})
    insert_s = [r["seconds"] for r in steps
                if r["step"].startswith("insert_batch")]
    return idx, queries, truth_live, final, totals, class_totals, insert_s


def phase_parity(dev, idx, queries, truth_live, final):
    """Card against the plain route: a small integer-valued run on both
    devices, on the loop, fused and tiered routes, then through an eager
    delete, a compaction and a reordering; the full-size queries with the
    kernels swapped out on the card; and the final full-size state copied
    to the CPU and searched there."""
    from repro_torch.bridge import hnsw_state_from_numpy, hnsw_state_to_numpy
    from repro_torch.core import hnsw, simhash, traversal
    from repro_torch.core.backend import SearchParams
    from repro_torch.core.hnsw import HNSWConfig
    from repro_torch.core.index import LSMVecIndex, recall_at_k
    from repro_torch.kernels.gather_l2.ref import gather_l2_ref
    from repro_torch.kernels.prefilter_gather.ref import prefilter_gather_ref
    from repro_torch.kernels.simhash.ref import (
        collision_count_rows_ref,
        simhash_encode_ref,
    )
    from repro_torch.tier import TierPolicy

    cfg = HNSWConfig(cap=4096, dim=65)
    rng = np.random.default_rng(21)

    def ints(n):
        # integer-valued, and every row's last coordinate 254: its absmax,
        # so a demoted row's int8 scale is exactly 2 and every cold-lane
        # distance an exact integer, whatever order a device sums it in
        x = rng.integers(-4, 5, (n, 65)).astype(np.float32)
        x[:, -1] = 254.0
        return x
    base, extra, qs = ints(2000), ints(512), ints(200)
    dels = rng.choice(2512, 25, replace=False)
    # some of these were reclaimed by the consolidation: counted no-ops
    eager_dels = rng.choice(2512, 25, replace=False)

    def run(device):
        out, fused_same = [], []
        t0 = time.perf_counter()
        small = LSMVecIndex.build(cfg, base, seed=7, device=device)

        def routes(index, tier=False):
            loop = view(index, tier=True) if tier else index
            res = [loop.search(qs, K, params=SearchParams(use_snapshot=snap))
                   for snap in (False, True)]
            res.append(view(index, fused_beam=True, tier=tier).search(
                qs, K, params=SearchParams(use_snapshot=True)))
            out.extend((r.ids, r.dists) for r in res)
            fused_same.append(bool(np.array_equal(res[1].ids, res[2].ids)
                                   and np.array_equal(res[1].dists,
                                                      res[2].dists)))
        routes(small)
        small.insert_batch(extra[:256])
        small.insert_batch(extra[256:])
        routes(small)
        small.delete_batch(dels)
        routes(small)
        small.maintain("consolidate")
        routes(small)
        small.maintain("tier", policy=TierPolicy(
            hot_frac=0.25, max_demote=cfg.cap, max_promote=64))
        routes(small, tier=True)
        # eager delete, compaction and reordering on the same state
        eager = view(small, lazy_delete=False)
        eager.delete_batch(eager_dels)
        routes(eager)
        eager.maintain("compact")
        routes(eager)
        perm = eager.maintain("reorder", window=8, lam=1.0).perm
        routes(eager)
        return out, hnsw_state_to_numpy(eager.state), \
            time.perf_counter() - t0, fused_same, perm

    card, card_state, card_s, card_fused, card_perm = run(dev)
    cpu, cpu_state, cpu_s, cpu_fused, cpu_perm = run("cpu")
    mismatched = [i for i, (a, b) in enumerate(zip(card, cpu))
                  if not (np.array_equal(a[0], b[0])
                          and np.array_equal(a[1], b[1]))]
    state_diff = sorted(k for k in card_state
                        if not np.array_equal(card_state[k], cpu_state[k]))
    same_perm = bool(np.array_equal(card_perm, cpu_perm))
    emit({"phase": "parity_small", "cap": cfg.cap, "dim": cfg.dim,
          "searches": len(card), "mismatched_searches": mismatched,
          "state_fields_differing": state_diff, "same_perm": same_perm,
          "fused_equals_snapshot": {"card": card_fused, "cpu": cpu_fused},
          "card_seconds": card_s, "cpu_seconds": cpu_s})
    if mismatched or state_diff or not same_perm:
        raise AssertionError(f"card and CPU differ: searches {mismatched}, "
                             f"state fields {state_diff}, perm {same_perm}")
    if not all(card_fused + cpu_fused):
        raise AssertionError("the fused route differs from the snapshot "
                             "route on the small run")
    _float_parity(dev)

    # full size: the final index's queries with every kernel of the loop
    # routes swapped for its plain version on the card
    swaps = [(hnsw, "gather_l2", gather_l2_ref),
             (hnsw, "prefilter_gather", prefilter_gather_ref),
             (traversal, "gather_l2", gather_l2_ref),
             (traversal, "collision_count_rows", collision_count_rows_ref),
             (simhash, "simhash_encode", simhash_encode_ref)]
    saved = [getattr(mod, name) for mod, name, _ in swaps]
    for mod, name, fn in swaps:
        setattr(mod, name, fn)
    try:
        plain = {snap: idx.search(queries, K,
                                  params=SearchParams(use_snapshot=snap))
                 for snap in (False, True)}
    finally:
        for (mod, name, _), fn in zip(swaps, saved):
            setattr(mod, name, fn)
    rows = []
    for snap, res in plain.items():
        kern = final[snap][0]
        rows.append(dict(
            route="snapshot" if snap else "lsm_probe",
            recall_kernel=final[snap][1],
            recall_plain=recall_at_k(res.ids, truth_live),
            queries_with_same_ids=float((res.ids == kern.ids).all(1).mean()),
            same_dists=bool(np.array_equal(res.dists, kern.dists))))
    cpu_idx = LSMVecIndex(idx.cfg, state=hnsw_state_from_numpy(
        hnsw_state_to_numpy(idx.state), "cpu"), device="cpu")
    t0 = time.perf_counter()
    res = cpu_idx.search(queries, K)
    rows.append(dict(route="lsm_probe_on_cpu", recall_kernel=final[False][1],
                     recall_plain=recall_at_k(res.ids, truth_live),
                     queries_with_same_ids=float(
                         (res.ids == final[False][0].ids).all(1).mean()),
                     same_dists=bool(np.array_equal(
                         res.dists, final[False][0].dists)),
                     cpu_seconds=time.perf_counter() - t0))
    emit({"phase": "parity_full", "runs": rows})
    # the plain versions sum rows in the kernels' order, and the upper
    # descent measures through the gather too: the same ids and dists for
    # every query, on the card's plain routes and on the CPU
    for row in rows:
        if row["queries_with_same_ids"] != 1.0 or not row["same_dists"]:
            raise AssertionError(f"{row['route']} differs from the kernel "
                                 f"route: {row}")


def _float_parity(dev):
    """Card against the CPU on float data through the update paths: one
    state bulk-built on the CPU from `make_clustered_vectors` rows (the
    build's host graph is not under test) and copied to both devices,
    then on each one insert_batch, a search, a lazy delete, a
    consolidation and a search.  Every state field after the insert and
    after the consolidation, and the searches' ids and dists, must be
    bitwise equal: every distance of those paths sums in row_dist.cuh's
    order on both devices."""
    from repro_torch.bridge import hnsw_state_from_numpy, hnsw_state_to_numpy
    from repro_torch.core.backend import SearchParams
    from repro_torch.core.hnsw import HNSWConfig
    from repro_torch.core.index import LSMVecIndex
    from repro_torch.data.synth import make_clustered_vectors

    cfg = HNSWConfig(cap=4096, dim=DIM)
    data = make_clustered_vectors(2000 + 256, DIM, seed=31)
    qs = make_clustered_vectors(200, DIM, seed=32)
    t0 = time.perf_counter()
    built = hnsw_state_to_numpy(LSMVecIndex.build(
        cfg, data[:2000], seed=7, device="cpu").state)
    build_s = time.perf_counter() - t0
    dels = np.random.default_rng(33).choice(2256, 25, replace=False)

    def run(device):
        t0 = time.perf_counter()
        idx = LSMVecIndex(cfg, state=hnsw_state_from_numpy(built, device),
                          device=device)
        idx.insert_batch(data[2000:])
        # copies: on the CPU the arrays would alias the state that the
        # delete and the consolidation then update in place
        after_insert = {k: v.copy() for k, v in
                        hnsw_state_to_numpy(idx.state).items()}
        found = [idx.search(qs, K, params=SearchParams(use_snapshot=False))]
        idx.delete_batch(dels)
        rep = idx.maintain("consolidate")
        found.append(idx.search(qs, K,
                                params=SearchParams(use_snapshot=False)))
        return (after_insert, hnsw_state_to_numpy(idx.state), found,
                rep.reclaimed, time.perf_counter() - t0)

    card, cpu = run(dev), run("cpu")
    diff = {step: sorted(k for k in card[i] if not np.array_equal(
        card[i][k], cpu[i][k])) for i, step in ((0, "insert_batch"),
                                               (1, "consolidate"))}
    same_search = [bool(np.array_equal(a.ids, b.ids)
                        and np.array_equal(a.dists, b.dists))
                   for a, b in zip(card[2], cpu[2])]
    emit({"phase": "parity_small_float", "cap": cfg.cap, "dim": cfg.dim,
          "built_rows": 2000, "inserted": 256, "deleted": len(dels),
          "reclaimed": {"card": card[3], "cpu": cpu[3]},
          "state_fields": len(card[0]), "state_fields_differing": diff,
          "searches_equal": same_search, "cpu_build_seconds": build_s,
          "card_seconds": card[4], "cpu_seconds": cpu[4]})
    if any(diff.values()) or not all(same_search) or card[3] != len(dels) \
            or cpu[3] != len(dels):
        raise AssertionError(f"card and CPU differ on float data: {diff}, "
                             f"searches {same_search}")


def _beam_rows(cfg, snap, routable, entries, out):
    """Distinct rows one beam launch had to read, from its heat lanes:
    the expanded nodes (adjacency rows), the fetched candidates (vector
    rows) and the candidates that were eligible at some trip (code
    rows): every live neighbour of a query's expanded nodes but the
    query's own entry, which is visited from the start."""
    import torch
    nodes, mask = out[3], out[4]
    expanded = nodes >= 0
    nbrs = snap[nodes.clamp_min(0).long()]              # [Bq, T, M]
    fetched = nbrs[mask]
    valid = expanded[..., None] & (nbrs >= 0) & (nbrs < cfg.cap)
    live = valid & routable[nbrs.clamp(0, cfg.cap - 1).long()] \
        & (nbrs != entries[:, None, None])
    return (int(torch.unique(nodes[expanded]).numel()),
            int(torch.unique(fetched).numel()),
            int(torch.unique(nbrs[live]).numel()))


def _beam_operands(dev, idx, queries):
    """The beam kernel's operands over `idx`'s snapshot for `queries`, as
    the fused route builds them, with a lazy-delete lane (1 % of the
    nodes marked not returnable) and the tier lanes."""
    import torch

    from repro_torch.core import hnsw, simhash
    cfg, st = idx.cfg, idx.state
    snap = idx.snapshot()
    qs = torch.from_numpy(queries).to(dev)
    ep, d_ep = hnsw._descend_upper(cfg, st, qs)
    ep, d_ep = ep.to(torch.int32).contiguous(), d_ep.contiguous()
    code_q = simhash.encode(st.proj, qs)
    q_norm = hnsw._norm(qs)
    routable = st.levels >= 0
    g = torch.Generator(device=dev).manual_seed(5)
    returnable = routable & ~st.tombstone & (
        torch.rand((cfg.cap,), generator=g, device=dev) >= 0.01)
    args = (qs, ep, d_ep, snap, st.vectors, st.codes, code_q, routable,
            q_norm, st.mean_norm)
    tier_lanes = dict(resident=hnsw._exact_resident(st), qvecs=st.qvecs,
                      qscale=st.qscale)
    return args, returnable, tier_lanes


def _trips(out, B):
    """(max, mean) trips per query and (max, mean) hops per query of one
    beam launch: a trip that expanded a node left it in the heat lanes."""
    nodes = out[3].reshape(out[3].shape[0], -1, B)
    trips = (nodes >= 0).any(-1).sum(1).float()
    hops = out[2][:, 3].float()
    return (int(trips.max()), float(trips.mean()), int(hops.max()),
            float(hops.mean()))


def _beam_bytes(cfg, rows):
    """Bytes one B = 1 search of the query block must move, each distinct
    row read once over the whole block (`_beam_rows`): the adjacency rows
    of the expanded nodes, the vector rows of the fetched candidates (the
    entries' distances come in), the 4-byte SimHash words and the live
    byte of every candidate that was eligible; the queries with their
    codes, norms and entries; and the outputs (heap, stats, heat lanes)."""
    from repro_torch.kernels.beam.ops import beam_iter_cap
    n_adj, n_vec, n_code = rows
    ef = cfg.ef_search
    iter_cap = beam_iter_cap(2 * ef, 1, ef)
    return (4 * cfg.M * n_adj + 4 * DIM * n_vec
            + (4 * cfg.words + 1) * n_code
            + N_QUERIES * (4 * DIM + 4 * cfg.words + 12)
            + N_QUERIES * (8 * ef + 16 + iter_cap * (4 + cfg.M)))


def beam_ab(dev, parent_src):
    """`--beam-ab SRC`: this tree's beam kernel against SRC's on one card,
    in one process, over a freshly built main-path index (the base rows
    and queries of `phase_main_path`): 1,000 queries, ef = 48, B = 1,
    rho = 1, filter on, lazy lane.  SRC's beam.cu is compiled with this
    tree's flags and called through this tree's wrapper (the C interface
    is the same), the two must agree bitwise, and each is timed twice in
    the order SRC, this, this, SRC."""
    import ctypes
    from unittest import mock

    import torch

    from repro_torch.core.hnsw import HNSWConfig
    from repro_torch.core.index import LSMVecIndex
    from repro_torch.data.synth import make_clustered_vectors
    from repro_torch.kernels import _build
    from repro_torch.kernels.beam import ops

    source = parent_src / "repro_torch" / "kernels" / "csrc" / "beam.cu"
    lib = _build.BUILD_DIR / "parent_beam.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(source)], check=True, capture_output=True)
    change = ops._kernel()
    parent = ctypes.CDLL(str(lib)).beam_search_f32
    parent.argtypes, parent.restype = change.argtypes, change.restype

    cfg = HNSWConfig(cap=CAP, dim=DIM)
    base = make_clustered_vectors(N_BASE + INSERT_BATCHES * INSERT_WIDTH,
                                  DIM, seed=0)[:N_BASE]
    t0 = time.perf_counter()
    idx = LSMVecIndex.build(cfg, base, seed=0)
    build_s = time.perf_counter() - t0
    queries = make_clustered_vectors(N_QUERIES, DIM, seed=1)
    args, returnable, _ = _beam_operands(dev, idx, queries)
    ef = cfg.ef_search
    kw = dict(ef=ef, k=K, m_bits=cfg.m_bits, eps=cfg.eps, rho=1.0,
              max_iters=2 * ef, use_filter=True, n_expand=1)

    def search():
        return ops.fused_beam_search(*args, returnable=returnable, **kw)

    outs, times = {}, []
    for name in ("parent", "change", "change", "parent"):
        with mock.patch.object(ops, "_fn", parent if name == "parent"
                               else change):
            outs[name] = search()
            times.append([name, median_ms(search, [()] * 15, warmup=3)])
    torch.cuda.synchronize()
    same = {n: bool(torch.equal(a, b)) for n, a, b in zip(
        ("ids", "dists", "stats", "heat_nodes", "heat_mask"),
        outs["parent"], outs["change"])}
    max_trips, mean_trips, max_hops, mean_hops = _trips(outs["change"], 1)
    rows = _beam_rows(cfg, args[3], args[7], args[1], outs["change"])
    change_ms = [t for n, t in times if n == "change"]
    emit({"phase": "beam_ab", "parent_src": str(parent_src),
          "times_ms": times, "bitwise_equal": same,
          "bound_ms": 1e3 * _beam_bytes(cfg, rows) / HBM_BYTES_PER_S,
          "max_trips": max_trips, "mean_trips": mean_trips,
          "max_hops": max_hops, "mean_hops": mean_hops,
          "us_per_trip": [1e3 * t / max_trips for _, t in times],
          "change_us_per_trip": 1e3 * float(np.mean(change_ms)) / max_trips,
          "build_seconds": build_s,
          "shape": f"Bq={N_QUERIES} ef={ef} M={cfg.M} B=1 d={DIM} "
                   f"base={N_BASE} cap={CAP}"})
    if not all(same.values()):
        raise AssertionError(f"the two beam kernels disagree: {same}")


def _binder(lib):
    """A stand-in for a wrapper module's `_kernel` that binds the entry
    points of another build of its library."""
    import ctypes

    def bind(name, argtypes):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn
    return bind


def fetch_ab(dev, parent_src):
    """`--fetch-ab SRC`: a loop trip's SimHash prefilter and fetch at a
    search's [1,000, 16] over the cap-sized table (d = 128, m = 64, fresh
    rows every call; `_trip_operands`), SRC's kernels against this
    tree's, in one process, each timed in the order SRC, this, this, SRC:

    - kernels alone: SRC's `collision_count_rows` then its `gather_l2`
      (tier: and its `gather_l2_q8`) over the survivors, against this
      tree's one `prefilter_gather`;
    - the whole trip: SRC's `traversal.beam_search` sequence (count,
      threshold masks, `where`, then the gather; tier: the resident
      lookup, the lane masks, both gathers and their min, as
      `hnsw._tier_dist_fn`), against this tree's (threshold fold, one
      `prefilter_gather`, `where`);
    - `gather_l2_q8` alone, SRC's and this tree's, on the same cold ids;
    - the device launches of one trip of each, by torch.profiler.

    SRC's `gather_l2.cu` and `simhash.cu` are compiled with this tree's
    flags and called through this tree's wrappers (their C interfaces
    are unchanged); the two trips must agree bitwise."""
    import ctypes
    from unittest import mock

    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.gather_l2 import ops as g_ops
    from repro_torch.kernels.prefilter_gather.ops import prefilter_gather
    from repro_torch.kernels.simhash import ops as s_ops

    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    csrc = parent_src / "repro_torch" / "kernels" / "csrc"
    libs, procs = {}, []
    for name in ("gather_l2", "simhash"):
        lib = _build.BUILD_DIR / f"parent_{name}.so"
        procs.append((name, lib, subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
             str(csrc / f"{name}.cu")], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT)))
    for name, lib, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"parent {name}.cu: {out.decode()[-2000:]}")
        libs[name] = ctypes.CDLL(str(lib))

    g = torch.Generator(device=dev).manual_seed(17)
    base, tier_lanes, blocks = _trip_operands(dev, g, N_QUERIES, 16, DIM, CAP)
    qs, table, code_q, codes, thr = base
    sets = blocks(30)
    delta_sq = torch.where(torch.isfinite(thr), 1.0, float("inf"))
    m_bits = 64

    def parent_dist(ids, tier):
        if tier is None:
            return g_ops.gather_l2(qs, table, ids)
        res = tier[0][ids.clamp_min(0).long()]
        hot_ids = torch.where((ids >= 0) & res, ids, -1)
        cold_ids = torch.where((ids >= 0) & ~res, ids, -1)
        return torch.minimum(g_ops.gather_l2(qs, table, hot_ids),
                             g_ops.gather_l2_q8(qs, tier[1], tier[2],
                                                cold_ids))

    def parent_trip(row, elig, tier):
        cols = s_ops.collision_count_rows(code_q, codes, row, m_bits)
        pass_thr = (cols.to(torch.float32) >= thr[:, None]) \
            | ~torch.isfinite(delta_sq)[:, None]
        mask = elig & pass_thr
        ids = torch.where(mask, row, -1)
        return mask, ids, parent_dist(ids, tier)

    def change_trip(row, elig, tier):
        t = torch.where(delta_sq < float("inf"), thr, -float("inf"))
        mask, dists = prefilter_gather(qs, table, code_q, codes, row, elig,
                                       t, tier=tier)
        return mask, torch.where(mask, row, -1), dists

    # the parent's kernels alone need the survivors' ids up front
    fetched = [torch.where(change_trip(r, e, None)[0], r, -1)
               for r, e in sets]

    def parent_kernels(i, tier):
        row, _ = sets[i]
        s_ops.collision_count_rows(code_q, codes, row, m_bits)
        if tier is None:
            g_ops.gather_l2(qs, table, fetched[i])
        else:
            g_ops.gather_l2(qs, table, fetched[i])
            g_ops.gather_l2_q8(qs, tier[1], tier[2], fetched[i])

    def change_kernels(i, tier):
        prefilter_gather(qs, table, code_q, codes, *sets[i], thr, tier=tier)

    @contextmanager
    def parent():
        with mock.patch.object(g_ops, "_kernel",
                               _binder(libs["gather_l2"])), \
                mock.patch.object(s_ops, "_kernel",
                                  _binder(libs["simhash"])):
            yield

    @contextmanager
    def change():
        yield

    def launches(fn, *args):
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn(*args)
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA)

    runs = []
    for tier_name, tier in (("f32", None), ("tier", tier_lanes)):
        outs = {}
        trip_launches = {}
        for name, ctx, fn in (("parent", parent, parent_trip),
                              ("change", change, change_trip)):
            with ctx():
                fn(*sets[0], tier)
                trip_launches[name] = launches(fn, *sets[0], tier)
        for what, p_fn, c_fn, args in (
                ("kernels", parent_kernels, change_kernels,
                 [(i, tier) for i in range(len(sets))]),
                ("trip", parent_trip, change_trip,
                 [(r, e, tier) for r, e in sets])):
            times = []
            for name in ("parent", "change", "change", "parent"):
                ctx, fn = (parent, p_fn) if name == "parent" \
                    else (change, c_fn)
                with ctx():
                    if what == "trip":
                        outs[name] = fn(*args[0])
                    times.append([name, median_ms(fn, args)])
            runs.append(dict(lane=tier_name, what=what, times_ms=times))
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(outs["parent"],
                                                     outs["change"]))
        runs[-1]["bitwise_equal"] = same
        runs[-1]["device_launches_per_trip"] = trip_launches
        if not same:
            raise AssertionError(f"the parent's trip and this tree's differ "
                                 f"({tier_name})")
    cold = [(torch.where(r >= 0, r, -1),) for r, _ in sets]
    q8 = []
    for name in ("parent", "change", "change", "parent"):
        with (parent if name == "parent" else change)():
            q8.append([name, median_ms(
                lambda i: g_ops.gather_l2_q8(qs, tier_lanes[1],
                                             tier_lanes[2], i), cold)])
    emit({"phase": "fetch_ab", "parent_src": str(parent_src), "runs": runs,
          "gather_l2_q8_times_ms": q8,
          "shape": f"[{N_QUERIES}, 16] d={DIM} m=64 table={CAP}x{DIM}"})


def encode_ab(dev, parent_src):
    """`--encode-ab SRC`: SRC's `simhash_encode` against this tree's on one
    card, in one process, at a search's 1,000 query rows, an insert
    batch's 1,024 and the bulk build's 131,072 (d = 128, m = 64, float
    data), each timed in the order SRC, this, this, SRC beside its bound
    (`_encode_bound`); the two trees' codes must be bitwise equal.  SRC's
    `simhash.cu` is compiled with this tree's flags and called through
    this tree's wrapper (the C interface is unchanged).  Beside them,
    `torch.mm` of f64 copies of x and proj.T made beforehand: the product
    alone (no conversion, sign or packing), a yardstick of what the f64
    tensor cores sustain at these shapes and not the same function; and
    the time the same timing reads for an empty kernel."""
    import ctypes
    from contextlib import nullcontext
    from unittest import mock

    import torch

    from repro_torch.kernels import _build
    from repro_torch.kernels.simhash import ops

    source = parent_src / "repro_torch" / "kernels" / "csrc" / "simhash.cu"
    lib = _build.BUILD_DIR / "parent_simhash.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib),
                    str(source)], check=True, capture_output=True)
    parent = _binder(ctypes.CDLL(str(lib)))
    floor_ms = median_ms(lambda: torch.cuda._sleep(0), [()] * 30)
    g = torch.Generator(device=dev).manual_seed(20)
    proj = torch.randn((64, DIM), generator=g, device=dev)
    shapes = []
    for n in (N_QUERIES, INSERT_WIDTH, N_BASE):
        x = torch.randn((n, DIM), generator=g, device=dev)
        codes, times = {}, []
        for name in ("parent", "change", "change", "parent"):
            with (mock.patch.object(ops, "_kernel", parent)
                  if name == "parent" else nullcontext()):
                codes[name] = ops.simhash_encode(x, proj)
                times.append([name, median_ms(ops.simhash_encode,
                                              [(x, proj)] * 20)])
        torch.cuda.synchronize()
        xd, pt = x.double(), proj.double().T.contiguous()
        bound, by = _encode_bound(n, 64)
        change = float(np.mean([t for k, t in times if k == "change"]))
        shapes.append(dict(
            shape=f"[{n}, {DIM}] m=64", times_ms=times, bound_ms=bound,
            bound_by=by, change_share_of_bound=bound / change,
            bitwise_equal=bool(torch.equal(codes["parent"],
                                           codes["change"])),
            product_alone_f64_mm_ms=median_ms(torch.mm, [(xd, pt)] * 20)))
    emit({"phase": "encode_ab", "parent_src": str(parent_src),
          "shapes": shapes, "empty_kernel_ms": floor_ms})
    if not all(e["bitwise_equal"] for e in shapes):
        raise AssertionError("the parent's codes and this tree's differ")


def phase_beam(dev, idx, queries):
    """The beam megakernel over the built index's snapshot, 1,000 queries
    at ef = 48 with the filter on and a lazy-delete lane (1 % of the
    nodes marked not returnable), for B in {1, 4} and rho in {1.0, 0.5},
    and once with the tier lanes: bitwise against the loop route on the
    card (which fetches through prefilter_gather at rho = 1, through
    collision_count_rows and gather_l2 at rho = 0.5) and against its
    plain version.  Timed at B = 1, rho = 1 (the default configuration);
    the bound counts the distinct rows the run's own heat lanes say it
    had to read (`_beam_rows`).  What sets the time is the slowest
    query's chain of trips, so each run prints the maximum and mean
    hops and trips per query, and the timed one the microseconds per
    trip (the kernel's time over the maximum trips).  The plain version
    sums rows in the kernel's order, so it too must agree bitwise, on
    this float data."""
    import torch

    from repro_torch.core import hnsw, traversal
    from repro_torch.kernels.beam.ops import fused_beam_search
    from repro_torch.kernels.beam.ref import beam_search_ref

    cfg, st = idx.cfg, idx.state
    snap = idx.snapshot()
    args, returnable, tier_lanes = _beam_operands(dev, idx, queries)
    qs, ep, d_ep, _, _, _, code_q, routable, q_norm, _ = args
    ef = cfg.ef_search
    rows, timed = [], None
    for B, rho, tier in ((1, 1.0, False), (1, 0.5, False), (4, 1.0, False),
                         (4, 0.5, False), (1, 1.0, True)):
        kw = dict(ef=ef, k=K, m_bits=cfg.m_bits, eps=cfg.eps, rho=rho,
                  max_iters=2 * ef, use_filter=True, n_expand=B)
        opt = dict(returnable=returnable, **(tier_lanes if tier else {}))
        got = fused_beam_search(*args, **opt, **kw)
        if tier:
            resident = hnsw._exact_resident(st)
            dist_fn = hnsw._tier_dist_fn(st, qs, resident)
            fetch_fn = hnsw._tier_fetch_fn(st, qs, code_q, resident)
        else:
            dist_fn = hnsw._dist_fn(st, qs)
            fetch_fn = hnsw._fetch_fn(st, qs, code_q)
        loop = traversal.beam_search(
            qs, ep, d_ep, hnsw._snapshot_adj_fn(snap), dist_fn, st.codes,
            code_q, routable, cap=cfg.cap, ef=ef, k=K, m_bits=cfg.m_bits,
            eps=cfg.eps, rho=rho, max_iters=2 * ef, use_filter=True,
            q_norm=q_norm, mean_norm=st.mean_norm, n_expand=B, M=cfg.M,
            returnable=returnable, fetch_fn=fetch_fn)
        loop = (loop.ids, loop.dists, torch.stack(list(loop.stats), 1),
                loop.heat_nodes, loop.heat_mask)
        plain = beam_search_ref(*args, **opt, **kw)
        torch.cuda.synchronize()
        names = ("ids", "dists", "stats", "heat_nodes", "heat_mask")
        vs_loop = {n: bool(torch.equal(a, b))
                   for n, a, b in zip(names, got, loop)}
        vs_plain = {n: bool(torch.equal(a, b))
                    for n, a, b in zip(names, got, plain)}
        ids_same = float((got[0] == plain[0]).all(1).float().mean())
        fin = torch.isfinite(plain[1]) & torch.isfinite(got[1])
        err = float((got[1][fin] - plain[1][fin]).abs().max())
        max_trips, mean_trips, max_hops, mean_hops = _trips(got, B)
        rows.append(dict(B=B, rho=rho, tier=tier, bitwise_vs_loop=vs_loop,
                         bitwise_vs_plain=vs_plain,
                         queries_with_plain_ids=ids_same,
                         max_abs_err_vs_plain=err, max_hops=max_hops,
                         mean_hops=mean_hops, max_trips=max_trips,
                         mean_trips=mean_trips))
        if not (all(vs_loop.values()) and all(vs_plain.values())):
            raise AssertionError(f"beam kernel disagrees: {rows[-1]}")
        if (B, rho, tier) == (1, 1.0, False):
            stats = got[2].sum(0).tolist()
            ms = median_ms(lambda: fused_beam_search(*args, **opt, **kw),
                           [()] * 7, warmup=2)
            plain_ms = median_ms(lambda: beam_search_ref(*args, **opt, **kw),
                                 [()] * 3, warmup=1)
            timed = dict(err=err, ms=ms, plain_ms=plain_ms, stats=stats,
                         kw=kw, rows=_beam_rows(cfg, snap, routable, ep, got),
                         us_per_trip=1e3 * ms / max_trips,
                         max_trips=max_trips)
    n_adj, n_vec, n_code = timed["rows"]
    b_bytes = _beam_bytes(cfg, timed["rows"])
    emit({"phase": "beam", "runs": rows, "stats_totals": timed["stats"],
          "distinct_rows": dict(adjacency=n_adj, vectors=n_vec, codes=n_code),
          "bytes": b_bytes, "ms": timed["ms"],
          "max_trips": timed["max_trips"],
          "us_per_trip": timed["us_per_trip"]})
    return dict(
        name="beam", route="cuda",
        source="src/repro_torch/kernels/csrc/beam.cu",
        replaces="src/repro/kernels/beam/kernel.py:347",
        max_abs_err=timed["err"], ms=timed["ms"], plain_ms=timed["plain_ms"],
        bound_ms=1e3 * b_bytes / HBM_BYTES_PER_S, bound_by="bytes",
        library_ms=None,
        shape=f"Bq={N_QUERIES} ef={ef} M={cfg.M} B=1 d={DIM} cap={CAP}")


def phase_profile(idx, queries, rows):
    """Where the time goes: one snapshot search of the 1,000 queries on
    the loop route and on the fused route, and one insert_batch of 256
    fresh rows, under torch.profiler; the device's busy share is the
    summed kernel time over the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.backend import SearchParams
    out = []
    idx.snapshot()
    fused = view(idx, fused_beam=True)
    for name, fn in (
            ("search_snapshot", lambda: idx.search(
                queries, K, params=SearchParams(use_snapshot=True))),
            ("search_fused", lambda: fused.search(
                queries, K, params=SearchParams(use_snapshot=True))),
            ("insert_batch_256", lambda: idx.insert_batch(rows))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        kernels = [e for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA]
        device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
        if device_ms <= 0:
            raise AssertionError("the profiler traced no device time")
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]
        out.append(dict(
            run=name, wall_ms=wall_ms, device_ms=device_ms,
            busy_share=device_ms / wall_ms,
            kernel_launches=sum(e.count for e in kernels),
            top=[dict(kernel=e.key[:60], ms=e.self_device_time_total / 1e3,
                      calls=e.count) for e in top]))
    emit({"phase": "profile", "runs": out})


def _lookup_runs(index, queries) -> dict:
    """One more LSM-probe search of `queries`, untimed and recording no
    heat, with the tree's batch lookup wrapped: the lookups it made (keys
    >= 0) and, per lookup, the non-empty runs a newest-first point lookup
    walks (the memtable, then each level, up to the one that holds the
    key; all of them for a key the tree lacks).  The port's `get_batch`
    probes every run at once and charges one read (`n_probes`) by the
    paper's cost model; this counts the runs the tree's layout makes a
    lookup consult."""
    import torch

    from repro_torch.core import lsm
    from repro_torch.core.backend import SearchParams
    store = index.state.store
    counts = [int(store.mem_count)] + [int(c) for c in store.level_counts]
    tiers = [keys[:c] for keys, c in zip(
        (store.mem_keys,) + tuple(store.level_keys), counts) if c]
    total = [0, 0]
    get_batch = lsm.get_batch

    def walked(cfg, st, keys):
        k = keys[keys >= 0].to(torch.int32)
        found = torch.zeros_like(k, dtype=torch.bool)
        runs = torch.zeros_like(k, dtype=torch.int64)
        for tier in tiers:
            runs += (~found).long()
            found |= torch.isin(k, tier)
        total[0] += k.numel()
        total[1] += int(runs.sum())
        return get_batch(cfg, st, keys)

    lsm.get_batch = walked
    try:
        index.search(queries, K, params=SearchParams(record_heat=False))
    finally:
        lsm.get_batch = get_batch
    return dict(lookups_per_query=total[0] / N_QUERIES,
                runs_per_lookup=total[1] / max(total[0], 1),
                lsm_run_entries=counts)


def phase_maintenance(dev, idx, queries):
    """The maintenance path on the final full-size index, each step timed
    and followed by a search on every route (LSM probe, snapshot, fused):

    1. eager delete (Algorithm 2) of 1 % of the live ids through a
       `lazy_delete=False` view: n_live drops by exactly that count, no
       deleted id comes back, the fused route equals the snapshot route;
    2. maintain("compact"): every route returns the ids and dists of the
       searches just before it, bitwise; the LSM runs a lookup walks
       (`_lookup_runs`, after every step) fall to one;
    3. maintain("reorder") on the heat the earlier searches recorded:
       perm is a permutation of the allocated ids with the dead last, the
       layout score rises, and every route returns perm[ids before] with
       the same dists, bitwise (every tie-break in the port is by
       position, not by id);
    4. insert_batch of 1,024 rows on the reordered index, then search.
    """
    import torch

    from repro_torch.core import lsm, reorder
    from repro_torch.core.index import brute_force_knn
    from repro_torch.data.synth import make_clustered_vectors

    eager = view(idx, lazy_delete=False)
    n = eager._count
    vectors = eager.state.vectors[:n].cpu().numpy()
    live = (eager.state.levels[:n] >= 0).cpu().numpy()
    rng = np.random.default_rng(9)
    dels = rng.choice(np.flatnonzero(live), int(DELETE_FRACTION * live.sum()),
                      replace=False)
    out = {}

    def routes(tag, index, truth, vecs, lv, id_map=None):
        got = {}
        for route, flags, snap in (("lsm_probe", {}, False),
                                   ("snapshot", {}, True),
                                   ("fused", {"fused_beam": True}, True)):
            ix = view(index, **flags) if flags else index
            if snap:
                index.snapshot()
            res, rec = search_step(f"{tag}_{route}", ix, snap, queries, truth,
                                   vecs, lv, dels, id_map)
            if route == "lsm_probe":
                rec = dict(step=f"{tag}_lsm_runs",
                           **_lookup_runs(index, queries))
                emit(rec)
                out[f"{tag}_lsm"] = rec
            got[route] = res
        if not (np.array_equal(got["fused"].ids, got["snapshot"].ids)
                and np.array_equal(got["fused"].dists, got["snapshot"].dists)):
            raise AssertionError(f"{tag}: the fused route differs from the "
                                 "snapshot route")
        return got

    size0 = eager.size
    _, rec = counted("eager_delete", lambda: eager.delete_batch(dels))
    rec.update(deleted=len(dels), deletes_per_s=len(dels) / rec["seconds"],
               n_live_before=size0, n_live_after=eager.size)
    emit(rec)
    if size0 - eager.size != len(dels):
        raise AssertionError(f"eager delete: n_live {size0} -> {eager.size} "
                             f"for {len(dels)} ids")
    live[dels] = False
    truth = brute_force_knn(vectors, queries, K, live=live)
    before = routes("after_eager_delete", eager, truth, vectors, live)

    _, rec = counted("compact", lambda: eager.maintain("compact"))
    emit(rec)
    after = routes("after_compact", eager, truth, vectors, live)
    for route, res in after.items():
        if not (np.array_equal(res.ids, before[route].ids)
                and np.array_equal(res.dists, before[route].dists)):
            raise AssertionError(f"compaction changed the {route} route's "
                                 "results")

    lv8, rows = lsm.resolve_all(eager.cfg.lsm_cfg, eager.state.store, n)
    rows = rows.cpu().numpy()
    heat = eager.state.heat[:n].cpu().numpy()
    rep, rec = counted("reorder", lambda: eager.maintain(
        "reorder", window=8, lam=1.0))
    perm = rep.perm
    score0 = reorder.layout_score(rows, np.arange(n), heat)
    score1 = reorder.layout_score(rows, perm, heat)
    # gorder's live set: a live row in the tree and a level
    placed = (lv8.cpu().numpy() > 0) & live
    n_placed = int(placed.sum())
    rec.update(gorder_seconds=rep.detail["gorder_seconds"], rows=n,
               live_rows=n_placed, layout_score_before=score0,
               layout_score_after=score1)
    emit(rec)
    if not (np.array_equal(np.sort(perm), np.arange(n))
            and (perm[placed] < n_placed).all()
            and (perm[~placed] >= n_placed).all()):
        raise AssertionError("reorder: perm is not a permutation with the "
                             "dead nodes last")
    if not score1 > score0:
        raise AssertionError(f"reorder: layout score {score0} -> {score1}")
    inv = np.argsort(perm)
    dels = perm[dels]                   # the deleted ids, renamed
    moved = routes("after_reorder", eager, truth, vectors[inv], live[inv],
                   id_map=inv)
    for route, res in moved.items():
        want = np.where(after[route].ids >= 0,
                        perm[np.maximum(after[route].ids, 0)], -1)
        if not (np.array_equal(res.ids, want)
                and np.array_equal(res.dists, after[route].dists)):
            raise AssertionError(f"reordering changed the {route} route's "
                                 "results beyond renaming")

    rows_new = make_clustered_vectors(REORDER_INSERTS, DIM, seed=4)
    res, rec = counted("insert_batch_after_reorder",
                       lambda: eager.insert_batch(rows_new))
    rec.update(inserts_per_s=REORDER_INSERTS / rec["seconds"])
    emit(rec)
    if not np.array_equal(res.ids, np.arange(n, n + REORDER_INSERTS)):
        raise AssertionError("insert_batch after reorder returned "
                             "unexpected ids")
    vecs2 = eager.state.vectors[:n + REORDER_INSERTS].cpu().numpy()
    live2 = (eager.state.levels[:n + REORDER_INSERTS] >= 0).cpu().numpy()
    truth2 = brute_force_knn(vecs2, queries, K, live=live2)
    routes("after_insert_reordered", eager, truth2, vecs2, live2)
    torch.cuda.synchronize()
    return eager


def _same_state(a, b) -> bool:
    """Every state tensor of two indexes bitwise equal."""
    import torch

    from repro_torch.core import lsm
    sa, sb = lsm.dehydrate(a.state), lsm.dehydrate(b.state)
    return sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k])
                                          for k in sa)


def phase_backend(dev, final, queries):
    """The rest of the `VectorBackend` surface on the final full-size
    index (a lazy-delete view on the fused route):

    1. an overlapped consolidation of 1 % lazy deletes: the milliseconds
       `begin_maintain` takes to return, the fused searches served until
       `poll_maintain` hands back the report and their QPS, against the
       same searches with no repair in flight, and the cut-over state
       bitwise equal to `maintain("consolidate")` on a `clone()` taken
       just before (the repair's own launches: `trace_counts()`);
    2. the write barrier: a `delete_batch` issued right after a second
       `begin_maintain` lands after the cutover (state bitwise equal to
       the clone's consolidate-then-delete), and the stashed report is
       claimed once, then None;
    3. `save` -> `restore` at full size into a temporary directory under
       build/ (removed after): every state leaf bitwise, seconds and
       bytes of each, and the next `insert_batch` bitwise on both;
    4. `stats()` and `memory_bytes()` beside `torch.cuda.memory_allocated`.
    """
    import torch

    from repro_torch.core.backend import SearchParams
    from repro_torch.core.index import LSMVecIndex
    from repro_torch.data.synth import make_clustered_vectors

    b = view(final, lazy_delete=True, fused_beam=True)
    p = SearchParams(use_snapshot=True)
    rng = np.random.default_rng(21)
    live_ids = np.flatnonzero((b.state.levels[:b._count] >= 0).cpu().numpy())
    picked = rng.permutation(live_ids)[:int(0.015 * len(live_ids))]
    dels, dels2 = picked[:len(picked) * 2 // 3], picked[len(picked) * 2 // 3:]
    _, rec = counted("backend_delete", lambda: b.delete_batch(dels))
    emit(rec)

    def serve_until_report():
        served, t0 = 0, time.perf_counter()
        started = b.begin_maintain("consolidate")
        begin_s = time.perf_counter() - t0
        if not started:
            raise AssertionError("begin_maintain started no repair")
        while True:
            rep = b.poll_maintain()
            if rep is not None:
                break
            b.search(queries, K, params=p)
            served += 1
        return dict(report=rep, served=served, begin_s=begin_s,
                    serve_s=time.perf_counter() - t0 - begin_s)

    b.snapshot()
    sync_ref = b.clone()
    out, rec = counted("overlapped_consolidate", serve_until_report)
    rep, served = out["report"], out["served"]
    if rep.reclaimed != len(dels) or not rep.detail.get("overlapped"):
        raise AssertionError(f"overlapped consolidate reported {rep}")
    sync_s, sync_rep = wall_s(lambda: sync_ref.maintain("consolidate"),
                              reps=1)
    same = _same_state(b, sync_ref)
    n_idle = max(served, 5)
    b.snapshot()
    idle_s, _ = wall_s(lambda: [b.search(queries, K, params=p)
                                for _ in range(n_idle)], reps=1)
    variants = b.trace_counts()
    rec.update(begin_maintain_ms=1e3 * out["begin_s"],
               searches_during_repair=served,
               seconds_until_report=out["serve_s"],
               qps_during_repair=(served * N_QUERIES / out["serve_s"]
                                  if served else None),
               qps_no_repair=n_idle * N_QUERIES / idle_s,
               reclaimed=rep.reclaimed, sync_consolidate_seconds=sync_s,
               state_equals_sync_consolidate=same,
               trace_counts=variants)
    emit(rec)
    if not same or sync_rep.reclaimed != rep.reclaimed:
        raise AssertionError("the overlapped consolidation's state differs "
                             "from maintain('consolidate') on a clone")
    if not variants["consolidate_bg"] or not rec["launches"]["gather_l2"]:
        raise AssertionError("the overlapped repair launched no kernel")

    # the write barrier
    b.delete_batch(dels)          # the same ids again: device no-ops
    b.delete_batch(dels2[:len(dels2) // 2])
    later = dels2[len(dels2) // 2:]
    barrier_ref = b.clone()
    t0 = time.perf_counter()
    if not b.begin_maintain("consolidate"):
        raise AssertionError("begin_maintain started no second repair")
    in_flight = not b._pending_repair.ready()
    b.delete_batch(later)
    barrier_s = time.perf_counter() - t0
    claimed = b.maintenance_pending and b._pending_repair is None
    barrier_ref.maintain("consolidate")
    barrier_ref.delete_batch(later)
    same = _same_state(b, barrier_ref)
    tombs = b.n_tombstones
    first, second = b.poll_maintain(), b.poll_maintain()
    ok = (same and claimed and tombs == len(later) and first is not None
          and first.detail.get("overlapped") and second is None)
    emit({"step": "write_barrier", "repair_in_flight_at_mutation": in_flight,
          "seconds_begin_to_mutation_applied": barrier_s,
          "state_equals_consolidate_then_delete": same,
          "tombstones_after": tombs, "report_claimed_once": ok})
    if not ok:
        raise AssertionError("write barrier: the mutation did not land "
                             "after the cutover")

    # save -> restore at full size
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="smoke_ckpt_", dir=build_dir)
    try:
        save_s, path = wall_s(lambda: b.save(tmp, lsn=1), reps=1)
        n_bytes = sum(f.stat().st_size for f in Path(path).iterdir())
        restore_s, (r, meta, _) = wall_s(lambda: LSMVecIndex.restore(
            b.cfg, tmp), reps=1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same = _same_state(b, r) and r._count == b._count
    rows = make_clustered_vectors(256, DIM, seed=6)
    got, rec = counted("insert_batch_after_restore",
                       lambda: r.insert_batch(rows))
    want = b.insert_batch(rows)
    same_insert = bool(np.array_equal(got.ids, want.ids)) and \
        _same_state(b, r)
    rec.update(save_seconds=save_s, restore_seconds=restore_s,
               checkpoint_bytes=n_bytes, leaves_bitwise=same,
               insert_bitwise=same_insert, inserted=len(rows))
    emit(rec)
    if not (same and same_insert):
        raise AssertionError("save/restore: the restored index differs")
    for kname in ("gather_l2", "simhash_encode", FUSED_FETCH):
        if not rec["launches"][kname]:
            raise AssertionError(f"insert after restore never launched "
                                 f"{kname}")
    del r
    torch.cuda.synchronize()

    st = b.stats()
    mem = st.memory.as_dict()
    emit({"phase": "stats", "size": st.size, "n_tombstones": st.n_tombstones,
          "delete_noops": st.delete_noops,
          "max_tombstone_ratio": st.max_tombstone_ratio, "memory": mem,
          "memory_bytes": b.memory_bytes(),
          "cuda_memory_allocated": torch.cuda.memory_allocated(dev),
          "cuda_max_memory_allocated": torch.cuda.max_memory_allocated(dev),
          "heat_total": b.heat_total(), "trace_counts": b.trace_counts()})
    if st.memory.total != b.memory_bytes() or st.size != b.size \
            or st.delete_noops < len(dels):
        raise AssertionError(f"stats disagree: {st}")
    return b


def _serve_cfg(tmp, name, policy, **kw):
    """The serve phase's engine settings, its WAL and checkpoints under
    `tmp/name`."""
    from repro_torch.serve import ServeConfig, WalConfig
    return ServeConfig(query_batch=SERVE_BATCH, insert_batch=SERVE_BATCH,
                       delete_batch=SERVE_BATCH,
                       wal=WalConfig(dir=str(tmp / name / "wal"),
                                     group_commit_n=1),
                       ckpt_dir=str(tmp / name / "ckpt"), ckpt_keep=1,
                       maintenance=policy, **kw)


def _no_fresh_backend():
    raise AssertionError("recovery found no checkpoint to restore")


def _timed(fn, acc):
    """`fn`, adding the seconds of each call to `acc[0]`."""
    def call(*args, **kw):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kw)
        finally:
            acc[0] += time.perf_counter() - t0
    return call


def _check_served(eng, served, ack, vectors_h):
    """Every served query: `check_result` on its ids mapped to internal
    ids (distinct, allocated, distances those of the rows), and no
    external id whose delete was acked before the query went in.
    `served` holds (mark, query, QueryResult); `ack` maps a deleted
    external id to the mark of its acknowledgement."""
    from repro_torch.core.backend import SearchResult
    ext = np.stack([r.ids for _, _, r in served])
    for (mark, _, _), row in zip(served, ext):
        late = [e for e in row[row >= 0].tolist()
                if ack.get(e, np.inf) < mark]
        if late:
            raise AssertionError(f"served acked-deleted ids {late}")
    ids = np.where(ext >= 0, eng._ext2int[np.maximum(ext, 0)], -1)
    if ((ext >= 0) & (ids < 0)).any():
        raise AssertionError("served an unallocated external id")
    check_result(SearchResult(ids=ids, dists=np.stack(
        [r.dists for _, _, r in served])), np.stack(
            [q for _, q, _ in served]), vectors_h,
        np.ones(len(vectors_h), bool))


def _drive_chunks(eng, ops, served, ack, mark0):
    """Submit `ops` one request at a time, in chunks of SERVE_CHUNK, each
    drained; returns the inserted external ids."""
    inserted = []
    for c in range(0, len(ops), SERVE_CHUNK):
        tickets = []
        for kind, payload in ops[c:c + SERVE_CHUNK]:
            tickets.append((kind, payload, getattr(
                eng, "submit_" + kind)(payload)))
        eng.drain()
        for kind, payload, t in tickets:
            v = t.result(timeout=600)
            if kind == "query":
                served.append((mark0 + c, payload, v))
            elif kind == "insert":
                inserted.append(v)
            elif v is not True:
                raise AssertionError(f"delete of live id {payload}: {v}")
            else:
                ack[payload] = mark0 + c + 0.5
    return inserted


def _mix(rng, n_q, n_i, n_d, qpool, fresh, dels):
    """A shuffled stream of n_q queries (drawn from `qpool`), n_i inserts
    (`fresh`, in order) and n_d deletes (`dels`, in order)."""
    kinds = np.array(["query"] * n_q + ["insert"] * n_i + ["delete"] * n_d)
    rng.shuffle(kinds)
    fi, di, ops = iter(fresh), iter(dels), []
    for k in kinds:
        if k == "query":
            ops.append(("query", qpool[int(rng.integers(len(qpool)))]))
        elif k == "insert":
            ops.append(("insert", next(fi)))
        else:
            ops.append(("delete", int(next(di))))
    return ops


def _live_mode(eng, rng, qpool, fresh, dels, served, ack, mark0):
    """`start()`/`stop()`: one client thread submits mixed requests as
    fast as it can for LIVE_SECONDS, holding at most LIVE_OPEN tickets
    open (it waits on the oldest, with a timeout, when it holds that
    many).  A delete counts as acked when the client sees its ticket
    resolved; marks are `mark0` plus the seconds since the start, a
    query's taken when it goes in."""
    import collections
    opened = collections.deque()
    n = Counter()

    def harvest(item):
        kind, payload, t_in, ticket = item
        v = ticket.result(timeout=600)
        n[kind] += 1
        if kind == "query":
            served.append((t_in, payload, v))
        elif kind == "delete":
            if v is not True:
                raise AssertionError(f"delete of live id {payload}: {v}")
            ack[payload] = mark0 + time.perf_counter() - t_start

    fi, di = 0, 0
    t_start = time.perf_counter()
    eng.start()
    try:
        t_end = t_start + LIVE_SECONDS
        while time.perf_counter() < t_end:
            r = rng.random()
            if r < 0.06 and fi < len(fresh):
                kind, payload = "insert", fresh[fi]
                fi += 1
            elif r < 0.1 and di < len(dels):
                kind, payload = "delete", int(dels[di])
                di += 1
            else:
                kind, payload = "query", qpool[int(rng.integers(len(qpool)))]
            t_in = mark0 + time.perf_counter() - t_start
            opened.append((kind, payload, t_in,
                           getattr(eng, "submit_" + kind)(payload)))
            while len(opened) >= LIVE_OPEN:
                harvest(opened.popleft())
    finally:
        eng.stop()
    while opened:
        harvest(opened.popleft())
    return dict(n)


def _matrix_ops(rng, rows):
    """The crash matrix's stream, as the reference's durability test
    draws it: mostly inserts of `rows`, deletes of external ids that
    earlier chunks inserted, a few queries."""
    ops, n_ins, before = [], 0, 0
    for i in range(MATRIX_OPS):
        if i % MATRIX_CHUNK == 0:
            before = n_ins
        r = rng.random()
        if r < 0.7 or before == 0:
            ops.append(("insert", rows[n_ins]))
            n_ins += 1
        elif r < 0.85:
            ops.append(("delete", int(rng.integers(0, before))))
        else:
            ops.append(("query", rows[int(rng.integers(len(rows)))]))
    return ops


def _crash_matrix(b, tmp, rng, rows):
    """`run_with_recovery` at each of the four injection points on a short
    stream at full width (the backend phase's configuration, cap
    1,048,576, d = 128), from an empty index as the reference's
    durability test starts; `verify_acked_writes` must find every acked
    write by id and by a search for its own vector.  Not from the
    full-size index: there a search for an inserted row's own vector
    can miss it, the row linked but out of the search's reach (recall@10
    is 0.20-0.54 on this data), which says nothing of durability."""
    import torch

    from repro_torch.core.index import LSMVecIndex
    from repro_torch.ft import (
        FailureInjector,
        RestartPolicy,
        run_with_recovery,
        verify_acked_writes,
    )
    from repro_torch.serve import MaintenancePolicy, ServeEngine
    out_rows = []
    for point, hit in (("pre_commit", 3), ("post_commit_pre_apply", 3),
                       ("mid_checkpoint", 1), ("mid_consolidation", 1)):
        pol = MaintenancePolicy(
            tombstone_ratio=None, heat_budget=None, check_every=2,
            checkpoint_every=MATRIX_CKPT_EVERY,
            consolidate_ratio=0.05 if point == "mid_consolidation" else None)
        cfg = _serve_cfg(tmp, point, pol)
        ops = _matrix_ops(rng, rows)

        def make(inj, cfg=cfg):
            return ServeEngine.recover(
                cfg, fresh_backend=lambda: LSMVecIndex(b.cfg, seed=1,
                                                       device=b.device),
                restore_backend=lambda d: LSMVecIndex.restore(
                    b.cfg, d, device=b.device),
                injector=inj)

        t0 = time.perf_counter()
        out = run_with_recovery(
            policy=RestartPolicy(ckpt_dir=cfg.ckpt_dir, wal_dir=cfg.wal.dir,
                                 max_restarts=3),
            make_engine=make, ops=ops,
            injector=FailureInjector(fail_points={point: hit}),
            chunk=MATRIX_CHUNK)
        summary = verify_acked_writes(out["engine"], ops, out["acked"])
        out_rows.append(dict(
            point=point, hit=hit, restarts=out["restarts"],
            retried=out["retried"], acked=len(out["acked"]),
            checkpoints=out["engine"].metrics.maintenance_runs["checkpoint"],
            seconds=time.perf_counter() - t0, **summary))
        out["engine"].close()
        del out
        shutil.rmtree(tmp / point, ignore_errors=True)
        torch.cuda.empty_cache()
        if out_rows[-1]["restarts"] < 1:
            raise AssertionError(f"crash matrix: {point} never fired")
        if out_rows[-1]["live"] != out_rows[-1]["searched"] \
                or not out_rows[-1]["live"]:
            raise AssertionError(f"crash matrix: {out_rows[-1]}")
    return out_rows


def phase_serve(dev, b, queries):
    """The serving engine over the backend phase's index (cap 1,048,576,
    d = 128, lazy delete, the fused route), with its WAL and covering
    checkpoints under build/ (removed after).  Returns the launches of
    each kernel while the engine served (`serve_launches`).

    1. Deterministic mode: about 4,096 queries (the smoke's queries and
       base rows), 256 inserts and 128 deletes of live ids, submitted
       one at a time in chunks of 64, each drained; an overlapped
       consolidation and a covering checkpoint must fire.
    2. Live mode: `start()`/`stop()` with a client thread as fast as it
       can go for a few seconds (`_live_mode`).
    3. A guarded steady state: GUARD_REQUESTS requests under
       `forbid_undeclared_sync()` (Python and CUDA layers on): nothing
       raises, `trace_counts()` does not move; the declared host syncs
       by reason, per served request.
    4. A final batch of 1,000 queries through the engine, mapped back
       through `resolve_ext`: equal to a direct fused search of the same
       state, recall@10 against `brute_force_knn` on the live set.
    5. Every served query checked (`_check_served`).
    6. Recovery without a crash, the live engine's WAL abandoned: state,
       id maps and deleted set bitwise equal to the live engine's.
    7. The four-point crash matrix (`_crash_matrix`: from an empty index
       of the same configuration).
    """
    import torch

    from repro_torch._device import host_any
    from repro_torch.core import sentinel
    from repro_torch.core.backend import SearchParams
    from repro_torch.core.index import (
        LSMVecIndex,
        brute_force_knn,
        recall_at_k,
    )
    from repro_torch.data.synth import make_clustered_vectors
    from repro_torch.serve import MaintenancePolicy, ServeEngine, ServeMetrics

    t_phase = time.perf_counter()
    rng = np.random.default_rng(31)
    count = b._count
    live = ((b.state.levels[:count] >= 0)
            & ~b.state.tombstone[:count]).cpu().numpy()
    live_ids = rng.permutation(np.flatnonzero(live))
    base_rows = b.state.vectors[:count][torch.from_numpy(
        live_ids[:4096]).to(dev)].cpu().numpy()
    qpool = np.concatenate([queries, base_rows])
    fresh = make_clustered_vectors(4096, DIM, seed=41)
    # delete pools, disjoint: deterministic, live, guarded
    d_det, d_live = live_ids[:SERVE_DELETES], live_ids[SERVE_DELETES:1024]
    d_guard = live_ids[1024:1100]

    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="smoke_serve_", dir=build_dir))
    try:
        # a tombstone share that the first deletes pass
        policy = MaintenancePolicy(tombstone_ratio=None, heat_budget=None,
                                   consolidate_ratio=5e-4,
                                   check_every=SERVE_CHECK_EVERY,
                                   checkpoint_every=SERVE_CKPT_EVERY)
        cfg = _serve_cfg(tmp, "engine", policy)
        eng = ServeEngine(b, cfg)
        fsync_s, ckpt_s = [0.0], [0.0]
        eng.wal.sync = _timed(eng.wal.sync, fsync_s)
        eng.maintenance.checkpoint_fn = _timed(eng.checkpoint, ckpt_s)
        wrappers = launch_counters()
        for w in wrappers.values():
            w.launches = 0
        host_any.syncs = 0
        served, ack = [], {}

        # 1. deterministic mode
        ops = _mix(rng, SERVE_QUERIES, SERVE_INSERTS, SERVE_DELETES, qpool,
                   fresh[:SERVE_INSERTS], d_det)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _drive_chunks(eng, ops, served, ack, 0)
        torch.cuda.synchronize()
        det = dict(mode="deterministic", seconds=time.perf_counter() - t0,
                   requests=len(ops), metrics=eng.metrics.snapshot(),
                   consolidations=eng.maintenance.consolidations,
                   checkpoints=eng.maintenance.checkpoints,
                   checkpoint_seconds=ckpt_s[0],
                   wal_records=eng.wal.n_records, wal_commits=eng.wal.n_syncs,
                   fsync_seconds=fsync_s[0])
        emit({"step": "serve_deterministic", **det})
        if not (eng.maintenance.consolidations and
                eng.maintenance.checkpoints):
            raise AssertionError("serve: the policy fired no overlapped "
                                 f"consolidation or no checkpoint: {det}")

        # 2. live mode
        eng.metrics = ServeMetrics()
        t0 = time.perf_counter()
        n_live = _live_mode(eng, rng, qpool, fresh[SERVE_INSERTS:], d_live,
                            served, ack, 1e6)
        emit({"step": "serve_live", "seconds": time.perf_counter() - t0,
              "requests": n_live, "metrics": eng.metrics.snapshot()})

        # 3. the guarded steady state, after the warm-up above
        eng.metrics = ServeMetrics()
        warm = b.trace_counts()
        guard_ops = _mix(rng, GUARD_REQUESTS - 64, 40, 24, qpool,
                         fresh[-40:], d_guard)
        sentinel.reset_sync_counts()
        syncs0 = host_any.syncs
        with sentinel.forbid_undeclared_sync():
            cuda_layer = torch.cuda.get_sync_debug_mode()
            _drive_chunks(eng, guard_ops, served, ack, 1e12)
        counts = sentinel.sync_counts()
        emit({"step": "serve_guarded", "requests": len(guard_ops),
              "cuda_sync_debug_mode": cuda_layer,
              "trace_counts_unchanged": b.trace_counts() == warm,
              "host_any_syncs": host_any.syncs - syncs0,
              "syncs_per_request": {k: v / len(guard_ops)
                                    for k, v in sorted(counts.items())},
              "metrics": eng.metrics.snapshot()})
        if cuda_layer != 2 or b.trace_counts() != warm:
            raise AssertionError("guarded steady state: CUDA layer "
                                 f"{cuda_layer}, variants {warm} -> "
                                 f"{b.trace_counts()}")

        # 4. a final batch through the engine
        eng.metrics = ServeMetrics()
        tickets = [eng.submit_query(q) for q in queries]
        eng.drain()
        torch.cuda.synchronize()
        serve_launches = {n: w.launches for n, w in wrappers.items()}
        results = [t.result(timeout=600) for t in tickets]
        served += [(2e12, q, r) for q, r in zip(queries, results)]
        got = np.stack([r.ids for r in results])
        got = np.array([[eng.resolve_ext(e) if e >= 0 else -1 for e in row]
                        for row in got.tolist()])
        direct = b.search(queries, K, params=SearchParams(
            use_snapshot=True, record_heat=False))
        count = b._count
        live = ((b.state.levels[:count] >= 0)
                & ~b.state.tombstone[:count]).cpu().numpy()
        truth = brute_force_knn(b.state.vectors[:count], queries, K,
                                live=live, device=b.device)
        final = dict(equals_direct_fused=bool(np.array_equal(got,
                                                             direct.ids)),
                     recall_at_10=recall_at_k(got, truth),
                     metrics=eng.metrics.snapshot())
        emit({"step": "serve_final_batch", **final})
        if not final["equals_direct_fused"] \
                or final["recall_at_10"] < RECALL_FLOOR:
            raise AssertionError(f"serve final batch: {final}")

        # 5. every served query
        _check_served(eng, served, ack,
                      b.state.vectors[:count].cpu().numpy())
        emit({"step": "serve_checked", "queries": len(served),
              "acked_deletes": len(ack), "launches": serve_launches,
              "host_any_syncs": host_any.syncs})
        missing = [n for n in SERVE_PATH if not serve_launches[n]]
        if missing:
            raise AssertionError(f"the served stream never launched "
                                 f"{missing}: {serve_launches}")

        # 6. recovery without a crash
        eng.wal.abandon()
        restore_s = [0.0]
        t0 = time.perf_counter()
        eng2 = ServeEngine.recover(
            cfg, fresh_backend=_no_fresh_backend,
            restore_backend=_timed(
                lambda d: LSMVecIndex.restore(b.cfg, d, device=b.device), restore_s))
        torch.cuda.synchronize()
        rec_s = time.perf_counter() - t0
        same = dict(
            state=_same_state(b, eng2.backend)
            and eng2.backend._count == b._count,
            int2ext=bool(np.array_equal(eng._int2ext, eng2._int2ext)),
            ext2int=bool(np.array_equal(eng._ext2int, eng2._ext2int)),
            deleted=eng._deleted_ext == eng2._deleted_ext,
            next_ext=eng._next_ext == eng2._next_ext)
        emit({"step": "serve_recover", "seconds": rec_s,
              "restore_seconds": restore_s[0],
              "replay_seconds": rec_s - restore_s[0],
              "replayed_records": len(eng2.wal.records(
                  after=eng2._covering_lsn)),
              "covering_lsn": eng2._covering_lsn, "bitwise": same})
        eng2.close()
        del eng2
        torch.cuda.empty_cache()
        if not all(same.values()):
            raise AssertionError(f"recovery differs from the live engine: "
                                 f"{same}")

        # 7. the crash matrix
        matrix = _crash_matrix(b, tmp, rng, fresh[-1024:])
        emit({"step": "serve_crash_matrix", "points": matrix})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    emit({"phase": "serve", "seconds": time.perf_counter() - t_phase})
    return serve_launches


def _zero_launches():
    wrappers = launch_counters()
    for w in wrappers.values():
        w.launches = 0
    return wrappers


@contextmanager
def uncounted():
    """Launches made inside the block (a check: ground truth, a search
    repeated shard by shard) are taken back out of the counts."""
    wrappers = launch_counters()
    saved = {n: w.launches for n, w in wrappers.items()}
    try:
        yield
    finally:
        for n, w in wrappers.items():
            w.launches = saved[n]


def _merge_alone(be, queries, params):
    """Each shard of `be` searched alone, its ids made global, and the
    stable host merge: what `be.search` must give."""
    from repro_torch.core.backend import merge_topk
    gids, dists = [], []
    for s, sh in enumerate(be.shards):
        r = sh.search(queries, K, params=params)
        gids.append(np.where(r.ids >= 0,
                             r.ids.astype(np.int64) + s * be.cfg.cap, -1))
        dists.append(r.dists)
    return merge_topk(gids, dists, K)


def _sharded_view(be, **flags):
    """A read-only `ShardedBackend` over `be`'s shard states under
    another configuration (`view` of each shard)."""
    from repro_torch.core.distributed import ShardedBackend
    v = ShardedBackend(be.cfg._replace(**flags), be.n_shards,
                       devices=be.devices, seed=be.seed)
    v._shards = [view(sh, **flags) for sh in be.shards]
    return v


def _sharded_host(be):
    """(vectors [cap, d] by global id, live [cap]) on the host."""
    vecs = np.zeros((be.cap, be.cfg.dim), np.float32)
    live = np.zeros(be.cap, bool)
    for s, sh in enumerate(be.shards):
        n, base = sh._count, s * be.cfg.cap
        vecs[base:base + n] = sh.state.vectors[:n].cpu().numpy()
        live[base:base + n] = ((sh.state.levels[:n] >= 0)
                               & ~sh.state.tombstone[:n]).cpu().numpy()
    return vecs, live


def _sharded_small(dev):
    """Card against the CPU on a small integer-valued run: the flat index
    on 7 shards (padded) and a 2-shard backend at cap 4,096 a shard
    through build, both routes, inserts, deletes, an overlapped and a
    synchronous consolidation and a reordering: every id, distance, perm
    and state field bitwise."""
    from repro_torch.bridge import sharded_backend_to_numpy
    from repro_torch.core.backend import SearchParams
    from repro_torch.core.distributed import ShardedBackend, ShardedFlatIndex
    from repro_torch.core.hnsw import HNSWConfig
    rng = np.random.default_rng(61)
    data = rng.integers(-4, 5, (6000, 65)).astype(np.float32)
    xs = rng.integers(-4, 5, (256, 65)).astype(np.float32)
    qs = rng.integers(-4, 5, (200, 65)).astype(np.float32)
    same = {}
    flat = [ShardedFlatIndex(RAGGED_SHARDS, devices=[d]).build(data).search(
        qs) for d in (dev, "cpu")]
    same["flat"] = all(np.array_equal(a, b) for a, b in zip(*flat))
    cfg = HNSWConfig(cap=4096, dim=65)
    out = {}
    for d in (dev, "cpu"):
        be = ShardedBackend(cfg, 2, devices=[d]).build(data[:3000], seed=9)
        res = []

        def routes():
            res.extend(be.search(qs, K, params=SearchParams(
                use_snapshot=snap)) for snap in (False, True))
        routes()
        res.append(be.insert_batch(xs, pad_to=64))
        be.delete_batch(be.initial_ids()[::50])
        routes()
        be.begin_maintain("consolidate")
        routes()
        be.poll_maintain(block=True)
        be.delete_batch(be.initial_ids()[1::50])
        be.maintain("consolidate")
        routes()
        res.append(be.maintain("reorder").perm)
        routes()
        out[d if d == "cpu" else "card"] = (res, sharded_backend_to_numpy(be))

    def eq(a, b):
        if hasattr(a, "ids"):
            return np.array_equal(a.ids, b.ids) and (
                not hasattr(a, "dists") or np.array_equal(a.dists, b.dists))
        return np.array_equal(a, b)
    (ra, sa), (rb, sb) = out["card"], out["cpu"]
    same["backend_results"] = all(eq(a, b) for a, b in zip(ra, rb))
    same["backend_state"] = sa.keys() == sb.keys() and all(
        np.array_equal(sa[k], sb[k]) for k in sa)
    return same


def phase_sharded(dev, queries):
    """Sharded search on the card (`repro_torch.core.distributed`):

    1. `ShardedFlatIndex` over 1,000,000 rows x 128 (SIFT1M's count and
       width) of `make_clustered_vectors`, 8 shards on the card: recall@10
       1.0 against `brute_force_knn`, distances allclose to the same
       search with `l2_distance` swapped for its plain version; then 7
       shards, the last one padded with 6 rows of +inf: no padded id
       returned, recall 1.0;
    2. `ShardedBackend`, 4 shards of 262,144 ids, the main path's
       configuration (fused route), 32,768 base rows: searches on the
       probe, snapshot loop and fused routes, each bitwise equal to the
       shards searched alone and merged by `merge_topk`; `insert_batch`
       of 1,024; 1 % lazy deletes; `maintain("consolidate")`; an
       overlapped consolidation under fused searches; `maintain
       ("reorder")`, its composed perm mapping the ids; `save` ->
       `restore` under build/ (removed after), bitwise; a short
       deterministic served stream, every query checked as `serve`
       checks;
    3. a small integer-valued run, card against the CPU (`_sharded_small`).

    Returns the launches of each kernel in 1 and 2.
    """
    import torch

    from repro_torch.core import distributed
    from repro_torch.core.backend import SearchParams
    from repro_torch.core.distributed import ShardedBackend, ShardedFlatIndex
    from repro_torch.core.hnsw import HNSWConfig
    from repro_torch.core.index import brute_force_knn, recall_at_k
    from repro_torch.data.synth import make_clustered_vectors
    from repro_torch.kernels.l2_distance.ref import l2_distance_ref
    from repro_torch.serve import MaintenancePolicy, ServeConfig, ServeEngine

    t_phase = time.perf_counter()
    emit({"phase": "sharded", "reduced": {
        "backend_base_rows": SHARD_BASE, "of": N_BASE,
        "why": "the shards' bulk build is host numpy (PERF.md §5); the "
               "flat index holds SIFT1M's 1,000,000 rows"}})
    wrappers = _zero_launches()

    # 1. the flat index
    data = make_clustered_vectors(FLAT_ROWS, DIM, seed=71)
    t0 = time.perf_counter()
    with uncounted():
        truth = brute_force_knn(data, queries, K)
    truth_s = time.perf_counter() - t0
    flat = ShardedFlatIndex(FLAT_SHARDS).build(data)
    search_s, (ids, dists) = wall_s(lambda: flat.search(queries, K))
    kernel_fn = distributed.l2_distance
    distributed.l2_distance = l2_distance_ref
    try:
        plain_s, (p_ids, p_dists) = wall_s(lambda: flat.search(queries, K))
    finally:
        distributed.l2_distance = kernel_fn
    ragged = ShardedFlatIndex(RAGGED_SHARDS).build(data)
    r_ids, _ = ragged.search(queries, K)
    rec = dict(step="sharded_flat", rows=FLAT_ROWS, shards=FLAT_SHARDS,
               n_per=flat.n_per, seconds=search_s,
               qps=N_QUERIES / search_s, plain_seconds=plain_s,
               brute_force_seconds=truth_s,
               recall_at_10=recall_at_k(ids, truth),
               dists_allclose_plain=bool(np.allclose(dists, p_dists,
                                                     rtol=1e-5)),
               ids_equal_plain=float((ids == p_ids).mean()),
               ragged_shards=RAGGED_SHARDS,
               ragged_padded_rows=ragged.n_per * RAGGED_SHARDS - FLAT_ROWS,
               ragged_padded_ids_returned=int((r_ids >= FLAT_ROWS).sum()),
               ragged_recall_at_10=recall_at_k(r_ids, truth))
    emit(rec)
    if not (rec["recall_at_10"] == 1.0 and rec["dists_allclose_plain"]
            and rec["ragged_padded_rows"] > 0
            and rec["ragged_padded_ids_returned"] == 0
            and rec["ragged_recall_at_10"] == 1.0):
        raise AssertionError(f"sharded flat index: {rec}")
    del flat, ragged, data
    torch.cuda.empty_cache()

    # 2. the backend
    cfg = HNSWConfig(cap=SHARD_CAP, dim=DIM, fused_beam=True)
    rows = make_clustered_vectors(SHARD_BASE + SHARD_INSERTS
                                  + SHARD_SERVE[1], DIM, seed=72)
    base, extra, fresh = np.split(rows, [SHARD_BASE,
                                         SHARD_BASE + SHARD_INSERTS])
    build_s, be = wall_s(lambda: ShardedBackend(cfg, SHARDS).build(
        base, seed=5), reps=1)
    emit({"step": "sharded_build", "seconds": build_s, "rows": SHARD_BASE,
          "shards": SHARDS, "per_shard": [sh._count for sh in be.shards]})

    def truth_now():
        vecs, live = _sharded_host(be)
        with uncounted():
            return vecs, live, brute_force_knn(vecs, queries, K, live=live)

    def routes(name, vecs, live, truth):
        out = {}
        for route, index, snap in (
                ("probe", be, False),
                ("snapshot", _sharded_view(be, fused_beam=False), True),
                ("fused", be, True)):
            p = SearchParams(use_snapshot=snap)
            secs, res = wall_s(lambda: index.search(queries, K, params=p),
                               reps=1)
            with uncounted():
                alone = _merge_alone(index, queries, p)
            check_result(res, queries, vecs, live)
            out[route] = dict(
                seconds=secs, qps=N_QUERIES / secs,
                recall_at_10=recall_at_k(res.ids, truth),
                equals_shards_merged=bool(
                    np.array_equal(res.ids, alone.ids)
                    and np.array_equal(res.dists, alone.dists)))
            if not out[route]["equals_shards_merged"] \
                    or out[route]["recall_at_10"] < RECALL_FLOOR:
                raise AssertionError(f"{name} {route}: {out[route]}")
            out[route]["ids"] = res.ids
        emit({"step": name, **{r: {k: v for k, v in o.items() if k != "ids"}
                               for r, o in out.items()}})
        return out

    vecs, live, truth = truth_now()
    routes("sharded_search", vecs, live, truth)
    ins_s, got = wall_s(lambda: be.insert_batch(extra), reps=1)
    per_shard = np.bincount(got.ids // SHARD_CAP, minlength=SHARDS)
    emit({"step": "sharded_insert_batch", "seconds": ins_s,
          "inserts_per_s": len(extra) / ins_s,
          "per_shard": per_shard.tolist()})
    if got.n_applied != len(extra) or (got.ids < 0).any():
        raise AssertionError(f"sharded insert_batch: {got}")
    rng = np.random.default_rng(73)
    live_ids = be.initial_ids()
    dels = rng.choice(live_ids, int(DELETE_FRACTION * len(live_ids)),
                      replace=False)
    del_s, res = wall_s(lambda: be.delete_batch(dels), reps=1)
    cons_s, rep = wall_s(lambda: be.maintain("consolidate"), reps=1)
    emit({"step": "sharded_delete_consolidate", "deleted": len(dels),
          "delete_seconds": del_s, "consolidate_seconds": cons_s,
          "reclaimed": rep.reclaimed, "consolidations": be.consolidations})
    if res.n_applied != len(dels) or rep.reclaimed != len(dels):
        raise AssertionError(f"sharded delete/consolidate: {rep}")
    vecs, live, truth = truth_now()
    before = routes("sharded_search_after_updates", vecs, live, truth)

    # an overlapped consolidation under fused searches
    dels2 = rng.choice(np.flatnonzero(live), len(dels), replace=False)
    be.delete_batch(dels2)
    p = SearchParams(use_snapshot=True)
    served, t0 = 0, time.perf_counter()
    if not be.begin_maintain("consolidate"):
        raise AssertionError("sharded begin_maintain started no repair")
    while (rep := be.poll_maintain()) is None:
        be.search(queries, K, params=p)
        served += 1
    over_s = time.perf_counter() - t0
    emit({"step": "sharded_overlapped_consolidate", "seconds": over_s,
          "searches_during_repair": served, "reclaimed": rep.reclaimed,
          "shards": rep.detail.get("shards")})
    if rep.reclaimed != len(dels2):
        raise AssertionError(f"sharded overlapped consolidate: {rep}")

    # a short deterministic served stream
    n_q, n_i, n_d = SHARD_SERVE
    _, live = _sharded_host(be)
    live_g = be.initial_ids()
    live_g = live_g[live[live_g]]
    sched = ServeConfig(query_batch=SERVE_BATCH, insert_batch=SERVE_BATCH,
                        delete_batch=SERVE_BATCH,
                        maintenance=MaintenancePolicy(
                            tombstone_ratio=None, heat_budget=None,
                            consolidate_ratio=5e-4, check_every=2))
    eng = ServeEngine(be, sched)
    int2ext = {int(g): e for e, g in enumerate(be.initial_ids())}
    d_ext = [int2ext[int(g)] for g in rng.choice(live_g, n_d, replace=False)]
    ops = _mix(rng, n_q, n_i, n_d, queries, fresh, d_ext)
    served_q, ack = [], {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _drive_chunks(eng, ops, served_q, ack, 0)
    torch.cuda.synchronize()
    serve_s = time.perf_counter() - t0
    vecs, _ = _sharded_host(be)
    _check_served(eng, served_q, ack, vecs)
    emit({"step": "sharded_serve", "seconds": serve_s, "requests": len(ops),
          "requests_per_s": len(ops) / serve_s,
          "queries_checked": len(served_q), "acked_deletes": len(ack),
          "consolidations": eng.maintenance.consolidations,
          "metrics": eng.metrics.snapshot()})
    eng.close()
    # reorder: ids through the composed perm, dists unchanged
    pre = be.search(queries, K, params=p)
    reorder_s, rep = wall_s(lambda: be.maintain("reorder"), reps=1)
    post = be.search(queries, K, params=p)
    mapped = np.where(pre.ids >= 0, rep.perm[np.maximum(pre.ids, 0)], -1)
    ok = bool(np.array_equal(post.ids, mapped)
              and np.array_equal(post.dists, pre.dists))
    emit({"step": "sharded_reorder", "seconds": reorder_s,
          "perm_maps_ids": ok})
    if not ok:
        raise AssertionError("sharded reorder: ids do not map through perm")

    # save -> restore
    build_dir = ROOT / "build"
    build_dir.mkdir(exist_ok=True)
    tmp = tempfile.mkdtemp(prefix="smoke_shard_ckpt_", dir=build_dir)
    try:
        save_s, path = wall_s(lambda: be.save(tmp, lsn=3), reps=1)
        n_bytes = sum(f.stat().st_size for f in Path(path).rglob("*")
                      if f.is_file())
        restore_s, (back, _, _) = wall_s(lambda: ShardedBackend.restore(
            cfg, tmp, n_shards=SHARDS), reps=1)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same = all(_same_state(a, b) and a._count == b._count
               for a, b in zip(be.shards, back.shards)) \
        and back._alloc == be._alloc and back._n_routed == be._n_routed
    emit({"step": "sharded_save_restore", "save_seconds": save_s,
          "restore_seconds": restore_s, "checkpoint_bytes": n_bytes,
          "bitwise": same})
    if not same:
        raise AssertionError("sharded save/restore differs")
    del back
    torch.cuda.empty_cache()

    launches = {n: w.launches for n, w in wrappers.items()}
    missing = [n for n in SHARDED_PATH if not launches[n]]
    if missing:
        raise AssertionError(f"the sharded phase never launched {missing}: "
                             f"{launches}")

    # 3. card against the CPU, small
    same = _sharded_small(dev)
    emit({"step": "sharded_parity_small", "bitwise": same})
    if not all(same.values()):
        raise AssertionError(f"sharded card vs CPU: {same}")
    emit({"phase": "sharded", "seconds": time.perf_counter() - t_phase,
          "launches": launches})
    return launches


def _baselines_small(dev):
    """Card against the CPU on small runs: DiskANN over integer-valued
    rows bitwise (graph, searches, inserts); SPFresh over float rows, its
    postings and search ids equal except where a row's two nearest
    centroids (a query's last probed and first unprobed) lie within 1e-5
    relative of each other, counted."""
    from repro_torch.core.baselines import DiskANNIndex, SPFreshIndex
    from repro_torch.data.synth import make_clustered_vectors
    rng = np.random.default_rng(81)
    ints = rng.integers(-4, 5, (3000, 128)).astype(np.float32)
    dk = [DiskANNIndex.build(ints[:2900], seed=2, device=d, **DISKANN_KW)
          for d in (dev, "cpu")]
    for x in ints[2900:2964]:
        dk[0].insert(x)
        dk[1].insert(x)
    ra, rb = dk[0].search(ints[2964:]), dk[1].search(ints[2964:])
    diskann = (dk[0].entry == dk[1].entry
               and all(np.array_equal(a, b) for a, b in zip(dk[0].adj,
                                                            dk[1].adj))
               and all(np.array_equal(a, b) for a, b in zip(ra, rb)))
    data = make_clustered_vectors(8192, 128, seed=82)
    qs = make_clustered_vectors(200, 128, seed=83)
    sp = [SPFreshIndex.build(data, seed=3, device=d, **SPFRESH_KW)
          for d in (dev, "cpu")]

    def near_tie(d, rank):
        s = np.sort(d)
        return bool(s[rank + 1] - s[rank] <= 1e-5 * s[rank + 1])

    own = []
    for ix in sp:
        o = np.full(len(ix.vectors), -1)
        for c, p in enumerate(ix.postings):
            o[np.asarray(p, np.int64)] = c
        own.append(o)
    apart = np.flatnonzero(own[0] != own[1])
    ia, ib = sp[0].search(qs)[0], sp[1].search(qs)[0]
    rows = np.flatnonzero((ia != ib).any(1))
    ties = all(near_tie(((sp[1].centroids - data[r]) ** 2).sum(1), 0)
               for r in apart) and all(
        near_tie(((sp[1].centroids - qs[i]) ** 2).sum(1),
                 SPFRESH_KW["n_probe"] - 1) for i in rows)
    return dict(diskann_bitwise=diskann, spfresh_rows_apart=len(apart),
                spfresh_queries_apart=len(rows), spfresh_apart_on_ties=ties)


def phase_baselines(dev, queries):
    """The DiskANN-like and SPFresh-like baselines
    (`repro_torch.core.baselines`) on the card, at the settings of
    benchmarks/common.py: DiskANN over 32,768 rows, SPFresh over
    131,072; for each the build seconds, 1,000 queries (QPS, recall@10
    against `brute_force_knn`), 256 inserts (inserts/s), 1 % deletes,
    `memory_bytes` and `io_stats`; then small runs, card against the CPU
    (`_baselines_small`).  Returns the launches of each kernel in the
    full-size runs."""
    import torch

    from repro_torch.core.backend import SearchResult
    from repro_torch.core.baselines import DiskANNIndex, SPFreshIndex
    from repro_torch.core.index import brute_force_knn, recall_at_k
    from repro_torch.data.synth import make_clustered_vectors

    t_phase = time.perf_counter()
    wrappers = _zero_launches()
    for name, cls, rows, kw in (
            ("diskann", DiskANNIndex, DISKANN_ROWS, DISKANN_KW),
            ("spfresh", SPFreshIndex, SPFRESH_ROWS, SPFRESH_KW)):
        data = make_clustered_vectors(rows + BASELINE_INSERTS, DIM, seed=91)
        base, fresh = data[:rows], data[rows:]
        with uncounted():
            truth = brute_force_knn(base, queries, K)
        build_s, idx = wall_s(lambda: cls.build(base, **kw), reps=1)
        idx.reset_stats()
        search_s, (ids, dists) = wall_s(lambda: idx.search(queries, K),
                                        reps=1)
        io_search = [int(v) for v in idx.io_stats]
        recall = recall_at_k(ids, truth)
        ins_s, _ = wall_s(lambda: [idx.insert(x) for x in fresh], reps=1)
        dels = np.random.default_rng(92).choice(
            rows, int(DELETE_FRACTION * rows), replace=False)
        del_s, _ = wall_s(lambda: [idx.delete(int(v)) for v in dels], reps=1)
        after = SearchResult(*idx.search(queries, K))
        rec = dict(step=f"baseline_{name}", rows=rows, **kw,
                   build_seconds=build_s, search_seconds=search_s,
                   qps=N_QUERIES / search_s, recall_at_10=recall,
                   inserts=len(fresh), inserts_per_s=len(fresh) / ins_s,
                   deletes=len(dels), deletes_per_s=len(dels) / del_s,
                   deleted_returned=int(np.isin(after.ids, dels).sum()),
                   memory_bytes=idx.memory_bytes(), size=idx.size,
                   io_stats_search=dict(zip(
                       ("n_adj", "n_vec", "n_filtered", "n_hops"),
                       io_search)),
                   io_stats_total=dict(zip(
                       ("n_adj", "n_vec", "n_filtered", "n_hops"),
                       (int(v) for v in idx.io_stats))))
        emit(rec)
        # no recall floor: SPFresh's 3 probes of 64-row postings see a
        # small share of a cluster by design; the results must be well
        # formed, live and at the rows' distances
        check_result(after, queries, idx.vectors, idx.live)
        if rec["deleted_returned"] \
                or idx.size != rows + len(fresh) - len(dels):
            raise AssertionError(f"baseline {name}: {rec}")
        del idx, data
    launches = {n: w.launches for n, w in wrappers.items()}
    if not launches["l2_distance"]:
        raise AssertionError(f"the baselines never launched l2_distance: "
                             f"{launches}")
    torch.cuda.synchronize()
    same = _baselines_small(dev)
    emit({"step": "baselines_parity_small", **same})
    if not (same["diskann_bitwise"] and same["spfresh_apart_on_ties"]):
        raise AssertionError(f"baselines card vs CPU: {same}")
    emit({"phase": "baselines", "seconds": time.perf_counter() - t_phase,
          "launches": launches})
    return launches


def kernels_line(kernels, totals, by_class, served, sharded,
                 baselines) -> dict:
    """The `kernels` line: each row with its main-path launches, its
    serve-phase launches (`serve_launches`) and those of the sharded and
    baselines phases (`sharded_launches`, `baselines_launches`), and each
    timed shape of
    `gather_l2` and `l2_distance` with its shape class (the kernel
    variant its wrapper's `shape_class` names) and that class's
    launches."""
    from repro_torch.kernels.gather_l2.ops import shape_class as g_class
    from repro_torch.kernels.l2_distance.ops import shape_class as l_class
    for name, row in kernels.items():
        row["launches"] = totals[name]
        row["serve_launches"] = served[name]
        row["sharded_launches"] = sharded[name]
        row["baselines_launches"] = baselines[name]
    kernels["collision_count_rows"]["entries"]["collision_count"][
        "launches"] = totals["collision_count"]
    for e in kernels["gather_l2"]["shapes"]:
        e["class"] = g_class(e["b"], e["k"])
    gt, ramp = kernels["l2_distance"]["shapes"]
    gt["class"], ramp["class"] = l_class(N_QUERIES), l_class(64)
    gt["caller"], ramp["caller"] = "brute_force_knn", "bulk build"
    for name in BY_CLASS:
        for e in kernels[name]["shapes"]:
            e["class_launches"] = by_class[name].get(e["class"], 0)
    keys = ("name", "route", "source", "replaces", "launches",
            "serve_launches", "sharded_launches", "baselines_launches",
            "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
            "shapes", "entries", "fuses")
    return {"kernels": [{k: row[k] for k in keys if k in row}
                        for row in kernels.values()]}


def main() -> int:
    import torch
    shapes_only = sys.argv[1:2] == ["--kernel-shapes"]
    src = Path(sys.argv[2]).resolve() if shapes_only and len(sys.argv) > 2 \
        else SRC
    ab_parent = Path(sys.argv[2]).resolve() \
        if sys.argv[1:2] == ["--beam-ab"] and len(sys.argv) > 2 else None
    fetch_parent = Path(sys.argv[2]).resolve() \
        if sys.argv[1:2] == ["--fetch-ab"] and len(sys.argv) > 2 else None
    encode_parent = Path(sys.argv[2]).resolve() \
        if sys.argv[1:2] == ["--encode-ab"] and len(sys.argv) > 2 else None
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (src / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip_smoke: the port's sources ({src / 'repro_torch'}) are "
              "not there", file=sys.stderr)
        return 1
    sys.path.insert(0, str(src))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    # full f32 products everywhere (the bulk-build and consolidation
    # pair matrices must stay exact on integer-valued data)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "env", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    _build.library("gather_l2")
    ptxas = {}
    for name, text in _build.last_build.get("log", {}).items():
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", text)]
        spill = [int(m) for m in re.findall(r"(\d+) bytes spill stores",
                                            text)]
        ptxas[name] = dict(kernels=len(regs), max_registers=max(regs or [0]),
                           max_spill_store_bytes=max(spill or [0]))
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.last_build.get("seconds"), "ptxas": ptxas})
    if shapes_only:
        from repro_torch.kernels.gather_l2.ops import gather_l2
        from repro_torch.kernels.l2_distance.ops import l2_distance
        from repro_torch.kernels.simhash.ops import simhash_encode
        emit({"phase": "kernel_shapes", "src": str(src),
              **kernel_shapes(dev, gather_l2, l2_distance, simhash_encode)})
        return 0
    if ab_parent is not None:
        beam_ab(dev, ab_parent)
        return 0
    if fetch_parent is not None:
        fetch_ab(dev, fetch_parent)
        return 0
    if encode_parent is not None:
        encode_ab(dev, encode_parent)
        return 0

    kernels = phase_kernels(dev)
    idx, queries, truth_live, final, totals, by_class, insert_s = \
        phase_main_path(dev)
    emit({"phase": "wrapper",
          "gather_l2_host_us_per_call_1x8":
              kernels["gather_l2"]["host_us_1x8"],
          "insert_batch_seconds": insert_s})
    phase_parity(dev, idx, queries, truth_live, final)
    kernels["beam"] = phase_beam(dev, idx, queries)
    from repro_torch.data.synth import make_clustered_vectors
    phase_profile(idx, queries,
                  make_clustered_vectors(256, DIM, seed=2))
    final = phase_maintenance(dev, idx, queries)
    served = phase_serve(dev, phase_backend(dev, final, queries), queries)
    del idx, final
    torch.cuda.empty_cache()
    sharded = phase_sharded(dev, queries)
    baselines = phase_baselines(dev, queries)

    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(nvidia_smi(), flush=True)
    emit(kernels_line(kernels, totals, by_class, served, sharded, baselines))
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
