"""Drive the PyTorch/CUDA port of LSM-VEC (src/repro_torch) on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing one JSON line (a failed phase raises, so the
script exits non-zero and prints no result):

  env        nvidia-smi's card name and power limit, torch and CUDA versions
  build      compile the port's CUDA kernels from src/repro_torch/kernels/csrc
  kernels    each kernel against its plain PyTorch version on the card, at
             the main path's shapes; median times, bounds, library yardsticks
  main_path  SIFT1M's shape (d=128, f32, default HNSWConfig) with state
             allocated at cap = 1,048,576 on the card: build -> search (LSM
             probe and snapshot routes) -> insert_batch 4 x 1,024 ->
             delete_batch 1% -> maintain("consolidate") -> search, with
             recall@10 against brute_force_knn; kernel launch counts are
             zeroed before and read after every step
  parity     a small integer-valued run, card against the plain route on
             the CPU, search ids bitwise at every step; the full-size
             queries re-run with the kernels swapped for their plain
             versions, and on the CPU from a copy of the final state
  profile    torch.profiler over one search and one insert_batch: the
             device's busy share and the kernels that take its time

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}.  It needs no network and one card, and
exits non-zero when no card is present or the port's sources are not
beside it.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

CAP = 1 << 20                 # id space allocated on the card
DIM = 128                     # SIFT1M's width
N_BASE = 131_072              # rows built (SIFT1M has 1,000,000)
N_QUERIES, K = 1000, 10
INSERT_BATCHES, INSERT_WIDTH = 4, 1024
DELETE_FRACTION = 0.01
# published peaks of one H100 SXM (NVIDIA data sheet, 700 W): HBM rate
# and the f32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, args_list, warmup: int = 3) -> float:
    """Median of per-launch CUDA-event times, cycling through inputs."""
    import torch
    for a in args_list[:warmup]:
        fn(*a)
    torch.cuda.synchronize()
    times = []
    for a in args_list:
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(*a)
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop))
    return float(np.median(times))


def phase_kernels(dev):
    """Each kernel against its plain version on the card."""
    import torch

    from repro_torch.data.synth import make_clustered_vectors
    from repro_torch.kernels.gather_l2.ops import gather_l2
    from repro_torch.kernels.gather_l2.ref import gather_l2_ref
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
                if integer:
                    ok = torch.equal(out, ref)
                else:
                    ok = torch.equal(fin, torch.isfinite(out)) and bool(
                        torch.allclose(out[fin], ref[fin], rtol=1e-6, atol=0))
                checks.append(dict(kernel="gather_l2", d=d, k=k,
                                   integer=integer, max_abs_err=err, ok=ok))
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
    del table, id_sets

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
    reps = [(qv, cv)] * 10
    l_ms = median_ms(l2_distance, reps)
    l_plain = median_ms(l2_distance_ref, reps)
    l_lib = median_ms(lambda a, b: torch.cdist(
        a, b, compute_mode="use_mm_for_euclid_dist"), reps)
    l_flops = 2 * N_QUERIES * N_BASE * DIM
    l_bytes = 4 * (N_QUERIES * DIM + N_BASE * DIM + N_QUERIES * N_BASE)
    l_bound = 1e3 * max(l_bytes / HBM_BYTES_PER_S, l_flops / F32_FLOPS)
    emit({"phase": "kernels", "checks": checks})
    return {
        "gather_l2": dict(
            name="gather_l2", route="cuda",
            source="src/repro_torch/kernels/csrc/gather_l2.cu",
            replaces="src/repro/kernels/gather_l2/kernel.py:38",
            max_abs_err=g_err, ms=g_ms, plain_ms=g_plain, bound_ms=g_bound,
            bound_by=("bytes" if g_bytes / HBM_BYTES_PER_S
                      >= g_flops / F32_FLOPS else "operations"),
            library_ms=None,
            shape=f"B={N_QUERIES} K=16 d={DIM} table={CAP}x{DIM}"),
        "l2_distance": dict(
            name="l2_distance", route="cuda",
            source="src/repro_torch/kernels/csrc/l2_distance.cu",
            replaces="src/repro/kernels/l2_distance/kernel.py:35",
            max_abs_err=l_err, ms=l_ms, plain_ms=l_plain, bound_ms=l_bound,
            bound_by=("operations" if l_flops / F32_FLOPS
                      >= l_bytes / HBM_BYTES_PER_S else "bytes"),
            library_ms=l_lib, library="torch.cdist (the root of this)",
            shape=f"Q={N_QUERIES} N={N_BASE} d={DIM}"),
    }


def counted(step, fn):
    """Run one step of the main path with the kernel launch counts and
    host-sync count zeroed just before it and read just after."""
    import torch

    from repro_torch._device import host_any
    from repro_torch.kernels.gather_l2.ops import gather_l2
    from repro_torch.kernels.l2_distance.ops import l2_distance
    gather_l2.launches = l2_distance.launches = host_any.syncs = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    return out, dict(step=step, seconds=secs,
                     launches={"gather_l2": gather_l2.launches,
                               "l2_distance": l2_distance.launches},
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


def phase_main_path(dev):
    import torch

    from repro_torch.core.backend import SearchParams
    from repro_torch.core.hnsw import HNSWConfig
    from repro_torch.core.index import (
        LSMVecIndex,
        brute_force_knn,
        recall_at_k,
    )
    from repro_torch.data.synth import make_clustered_vectors

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
    totals = {"gather_l2": 0, "l2_distance": 0}

    def step(name, fn, **extra_fields):
        out, rec = counted(name, fn)
        rec.update(extra_fields)
        for kname, n in rec["launches"].items():
            totals[kname] += n
        steps.append(rec)
        return out, rec

    def search(idx, snap):
        return idx.search(queries, K, params=SearchParams(use_snapshot=snap))

    torch.cuda.reset_peak_memory_stats(dev)
    idx, rec = step("build", lambda: LSMVecIndex.build(cfg, base, seed=0))
    emit(rec)
    truth, rec = step("ground_truth",
                      lambda: brute_force_knn(base, queries, K))
    emit(rec)
    for snap in (False, True):
        res, rec = step("search_snapshot" if snap else "search_lsm_probe",
                        lambda: search(idx, snap))
        rec.update(qps=N_QUERIES / rec["seconds"],
                   recall_at_10=recall_at_k(res.ids, truth))
        emit(rec)
        check_result(res, queries, base, np.ones(N_BASE, bool))
    for b in range(INSERT_BATCHES):
        rows = extra[b * INSERT_WIDTH:(b + 1) * INSERT_WIDTH]
        res, rec = step(f"insert_batch_{b}", lambda: idx.insert_batch(rows))
        want = np.arange(N_BASE + b * INSERT_WIDTH,
                         N_BASE + (b + 1) * INSERT_WIDTH)
        if not np.array_equal(res.ids, want):
            raise AssertionError("insert_batch returned unexpected ids")
        rec.update(inserts_per_s=INSERT_WIDTH / rec["seconds"])
        emit(rec)
    allv = data
    n_all = len(allv)
    truth_all, rec = step("ground_truth_all",
                          lambda: brute_force_knn(allv, queries, K))
    emit(rec)
    res, rec = step("search_after_insert", lambda: search(idx, True))
    rec.update(qps=N_QUERIES / rec["seconds"],
               recall_at_10=recall_at_k(res.ids, truth_all))
    emit(rec)
    check_result(res, queries, allv, np.ones(n_all, bool))

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
    for snap in (False, True):
        res, rec = step("search_after_delete"
                        + ("_snapshot" if snap else "_lsm_probe"),
                        lambda: search(idx, snap))
        n_bad = int(np.isin(res.ids, dels).sum())
        rec.update(qps=N_QUERIES / rec["seconds"],
                   recall_at_10=recall_at_k(res.ids, truth_live),
                   deleted_returned=n_bad)
        emit(rec)
        if n_bad:
            raise AssertionError(f"{n_bad} deleted ids returned")
        check_result(res, queries, allv, live)
    rep, rec = step("consolidate", lambda: idx.maintain("consolidate"))
    rec.update(reclaimed=rep.reclaimed)
    emit(rec)
    if rep.reclaimed != len(dels) or idx.n_tombstones != 0:
        raise AssertionError(f"consolidate reclaimed {rep.reclaimed}")
    final = {}
    for snap in (False, True):
        res, rec = step("search_after_consolidate"
                        + ("_snapshot" if snap else "_lsm_probe"),
                        lambda: search(idx, snap))
        n_bad = int(np.isin(res.ids, dels).sum())
        rec.update(qps=N_QUERIES / rec["seconds"],
                   recall_at_10=recall_at_k(res.ids, truth_live),
                   deleted_returned=n_bad)
        final[snap] = (res, rec["recall_at_10"])
        emit(rec)
        if n_bad:
            raise AssertionError(f"{n_bad} deleted ids returned")
        check_result(res, queries, allv, live)
    # recall on this data is low at this size (0.1995 for the first
    # search, the same on the CPU route): the floor only catches breakage
    for rec in steps:
        if rec["step"].startswith("search") and rec["recall_at_10"] < 0.15:
            raise AssertionError(f"recall too low: {rec}")
    for kname, n in totals.items():
        if n == 0:
            raise AssertionError(f"main path never launched {kname}")
    emit({"phase": "main_path", "launches": totals,
          "peak_memory_gib": torch.cuda.max_memory_allocated(dev) / 2 ** 30,
          "host_syncs_per_search": {
              r["step"]: r["host_syncs"] for r in steps
              if r["step"].startswith("search")}})
    return idx, queries, truth_live, final, totals


def phase_parity(dev, idx, queries, truth_live, final):
    """Card against the plain route: a small integer-valued run on both
    devices; the full-size queries with the kernels swapped out on the
    card; and the final full-size state copied to the CPU and searched
    there."""
    from repro_torch.bridge import hnsw_state_from_numpy, hnsw_state_to_numpy
    from repro_torch.core import hnsw
    from repro_torch.core.backend import SearchParams
    from repro_torch.core.hnsw import HNSWConfig
    from repro_torch.core.index import LSMVecIndex, recall_at_k
    from repro_torch.kernels.gather_l2.ref import gather_l2_ref

    cfg = HNSWConfig(cap=4096, dim=65)
    rng = np.random.default_rng(21)
    base = rng.integers(-4, 5, (2000, 65)).astype(np.float32)
    extra = rng.integers(-4, 5, (512, 65)).astype(np.float32)
    qs = rng.integers(-4, 5, (200, 65)).astype(np.float32)
    dels = rng.choice(2512, 25, replace=False)

    def run(device):
        out = []
        t0 = time.perf_counter()
        small = LSMVecIndex.build(cfg, base, seed=7, device=device)

        def both():
            for snap in (False, True):
                r = small.search(qs, K, params=SearchParams(use_snapshot=snap))
                out.append((r.ids, r.dists))
        both()
        small.insert_batch(extra[:256])
        small.insert_batch(extra[256:])
        both()
        small.delete_batch(dels)
        both()
        small.maintain("consolidate")
        both()
        return out, hnsw_state_to_numpy(small.state), \
            time.perf_counter() - t0

    card, card_state, card_s = run(dev)
    cpu, cpu_state, cpu_s = run("cpu")
    mismatched = [i for i, (a, b) in enumerate(zip(card, cpu))
                  if not (np.array_equal(a[0], b[0])
                          and np.array_equal(a[1], b[1]))]
    state_diff = sorted(k for k in card_state
                        if not np.array_equal(card_state[k], cpu_state[k]))
    emit({"phase": "parity_small", "cap": cfg.cap, "dim": cfg.dim,
          "searches": len(card), "mismatched_searches": mismatched,
          "state_fields_differing": state_diff, "card_seconds": card_s,
          "cpu_seconds": cpu_s})
    if mismatched:
        raise AssertionError(f"card and CPU search ids differ: {mismatched}")

    # full size: the final index's queries with both kernels swapped for
    # their plain versions on the card
    saved = hnsw.gather_l2
    hnsw.gather_l2 = gather_l2_ref
    try:
        plain = {snap: idx.search(queries, K,
                                  params=SearchParams(use_snapshot=snap))
                 for snap in (False, True)}
    finally:
        hnsw.gather_l2 = saved
    rows = []
    for snap, res in plain.items():
        r_plain = recall_at_k(res.ids, truth_live)
        r_kernel = final[snap][1]
        same = float((res.ids == final[snap][0].ids).all(1).mean())
        rows.append(dict(route="snapshot" if snap else "lsm_probe",
                         recall_kernel=r_kernel, recall_plain=r_plain,
                         queries_with_same_ids=same))
        if abs(r_plain - r_kernel) > 0.01:
            raise AssertionError(f"plain-route recall differs: {rows[-1]}")
    cpu_idx = LSMVecIndex(idx.cfg, state=hnsw_state_from_numpy(
        hnsw_state_to_numpy(idx.state), "cpu"), device="cpu")
    t0 = time.perf_counter()
    res = cpu_idx.search(queries, K)
    rows.append(dict(route="lsm_probe_on_cpu", recall_kernel=final[False][1],
                     recall_plain=recall_at_k(res.ids, truth_live),
                     queries_with_same_ids=float(
                         (res.ids == final[False][0].ids).all(1).mean()),
                     cpu_seconds=time.perf_counter() - t0))
    if abs(rows[-1]["recall_plain"] - rows[-1]["recall_kernel"]) > 0.01:
        raise AssertionError(f"CPU-route recall differs: {rows[-1]}")
    emit({"phase": "parity_full", "runs": rows})


def phase_profile(idx, queries, rows):
    """Where the time goes: one snapshot search of the 1,000 queries and
    one insert_batch of 256 fresh rows under torch.profiler; the device's
    busy share is the summed kernel time over the wall time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.backend import SearchParams
    out = []
    for name, fn in (
            ("search_snapshot", lambda: idx.search(
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke: the port's sources (src/repro_torch) are not "
              "beside this script", file=sys.stderr)
        return 1
    sys.path.insert(0, str(SRC))
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
    ptxas = {name: [ln.strip() for ln in text.splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, text in _build.last_build.get("log", {}).items()}
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": _build.last_build.get("seconds"), "ptxas": ptxas})

    kernels = phase_kernels(dev)
    idx, queries, truth_live, final, totals = phase_main_path(dev)
    phase_parity(dev, idx, queries, truth_live, final)
    from repro_torch.data.synth import make_clustered_vectors
    phase_profile(idx, queries,
                  make_clustered_vectors(256, DIM, seed=2))

    for name, row in kernels.items():
        row["launches"] = totals[name]
    emit({"phase": "done", "seconds": time.perf_counter() - t_start})
    print(nvidia_smi(), flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    emit({"kernels": [{k: row[k] for k in keys} for row in kernels.values()]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
