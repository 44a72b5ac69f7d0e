#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of MaxMem on one GPU and check it end to end.

    python3 chip_smoke.py

Phases, one line of numbers each:
  1. the card's name and power limit (nvidia-smi), then the kernels' build;
  2. each CUDA kernel against its plain PyTorch version on the card, at the
     slice's shapes, bit for bit, with its time, the plain version's time,
     one library call's time and the bound (bytes over HBM bandwidth);
  3. the slice end to end: ``CentralManager`` at 1,048,576 pages with 4 KiB
     of float32 content per page on the card, six colocated tenants, a
     seeded GUPS-style access stream, 32 ``run_epoch`` calls and one
     ``run_epochs(8, ...)``; then every page's bytes read back, the frame
     table, queue conservation, the sentinel words and the hot-set fast
     share are checked, and each kernel's launches on this path counted;
  4. the same manager schedule with exact sampling at 65,536 pages on the
     card and on the CPU, compared leaf by leaf.
The line before the last is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``. Any failed check raises, and
the script then exits non-zero without printing a result. It needs a CUDA
device and the ``src/repro_torch`` package beside it.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published HBM3 bandwidth
SEED = 20231201

# The slice's deployment: the scale bench's 1M-page headline geometry
# (fast = P/4, migration budget = P/32) with one 4 KiB page of content each.
PAGES = 1_048_576
FAST = PAGES // 4
BUDGET = PAGES // 32
TENANTS = 16
QUEUE = 65_536
BANDWIDTH = 8_192
ELEMS = 1024  # float32 elements per page: 4 KiB
# examples/colocation_demo.py: p1 best-effort, p2-p6 latency-sensitive with
# a hot half taking 90% of their accesses
T_MISS = (1.0, 0.1, 0.1, 0.1, 0.1, 0.1)
HOT_SHARE = 0.9
# Accesses per tenant per 1 s epoch from the simulator's closed-loop model
# (src/repro/core/simulator.py:393, ops = threads / latency * epoch): the
# demo's 2 threads per tenant on the OPTANE machine (80 ns fast, 300 ns slow,
# plus a 64-byte value at 100 and 30 GB/s), the tenant missing in the same
# proportion as the machine's slow share (3/4). The model's range is 6.6M
# (all slow) to 24.8M (all fast).
THREADS = 2
FAST_OP_NS, SLOW_OP_NS = 80 + 64 / 100, 300 + 64 / 30
MISS = 1 - FAST / PAGES
ACCESSES_PER_TENANT = round(THREADS / ((1 - MISS) * FAST_OP_NS + MISS * SLOW_OP_NS) * 1e9)
EPOCHS, BURST = 32, 8  # run_epoch calls, then one run_epochs(BURST)
CHECK_PAGES = 65_536  # the GPU-vs-CPU run of phase 4


def check(cond, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def emit(phase: str, **nums) -> None:
    print(f"{phase}: " + " ".join(f"{k}={v}" for k, v in nums.items()), flush=True)


# ------------------------------------------------------------------ helpers
def page_pattern(torch, ids, elems: int):
    """Seeded content that names its page: column 0 is the page id, the
    rest a hash of (page, column); every value is an exact float32 integer."""
    ids = ids.to(torch.int64)
    col = torch.arange(elems, dtype=torch.int64, device=ids.device)
    v = (ids[:, None] * 2654435761 + col[None, :] * 40503 + SEED) & 0xFFFFFF
    v[:, 0] = ids
    return v.to(torch.float32)


def tenant_sizes(n_pages: int, n_tenants: int):
    base, extra = divmod(n_pages, n_tenants)
    return [base + (1 if i < extra else 0) for i in range(n_tenants)]


def access_rates(torch, pages_of, n_pages: int, per_tenant: float, device):
    """f32[P] expected accesses per epoch: LS tenants put HOT_SHARE of their
    accesses on the first half of their pages, the best-effort one spreads
    them evenly (a GUPS-style uniform stream within each set)."""
    rates = torch.zeros(n_pages, dtype=torch.float32, device=device)
    for t, ids in enumerate(pages_of):
        ids_t = torch.as_tensor(ids, device=device)
        n = len(ids)
        if T_MISS[t] >= 1.0:
            rates[ids_t] = per_tenant / n
        else:
            half = n // 2
            rates[ids_t[:half]] = HOT_SHARE * per_tenant / half
            rates[ids_t[half:]] = (1 - HOT_SHARE) * per_tenant / (n - half)
    return rates


def epoch_counts(torch, rates, gen):
    return torch.poisson(rates, generator=gen).to(torch.int64)


def time_cuda(torch, fn, reps: int = 7) -> float:
    """Median milliseconds of ``fn`` between CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def device_ms(torch, fn, reps: int = 5):
    """Milliseconds of device time per call of ``fn`` (the sum of its
    kernels, memsets and copies as the profiler traces them), or None when
    the profiler records no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    total_us = sum(e.self_device_time_total for e in prof.key_averages())
    return total_us / reps / 1e3 if total_us > 0 else None


def max_abs_err(torch, a, b, chunk: int = 65536) -> float:
    err = 0.0
    for lo in range(0, a.shape[0], chunk):
        d = (a[lo : lo + chunk].to(torch.float64) - b[lo : lo + chunk].to(torch.float64))
        err = max(err, float(d.abs().max()))
    return err


def bound_ms(nbytes: int) -> float:
    return nbytes / HBM_BYTES_PER_S * 1e3


def fill_pattern(torch, pool, chunk: int = 65536) -> None:
    for lo in range(0, pool.shape[0], chunk):
        hi = min(lo + chunk, pool.shape[0])
        ids = torch.arange(lo, hi, device=pool.device)
        pool[lo:hi] = page_pattern(torch, ids, pool.shape[1])


# ------------------------------------------------------------------ phase 2
def kernel_checks(torch, np, device):
    """Each kernel against its plain version at the slice's shapes."""
    from repro_torch.core.sampler import sample_accesses
    from repro_torch.kernels import ops, ref

    rows = FAST + PAGES + 1
    trash = rows - 1
    M = max(2 * BUDGET, 8)  # the pool's plan_slots
    row_bytes = ELEMS * 4
    rng = np.random.default_rng(SEED)
    out = {}

    pool_a = torch.empty((rows, ELEMS), dtype=torch.float32, device=device)
    fill_pattern(torch, pool_a)
    pool_b = pool_a.clone()

    # page_move: a drained batch as the data plane plans it — demotes move
    # fast frames to free slow frames, promotes move slow frames into the
    # fast frames those demotes vacate (write-after-read), trash padding
    n_pairs = BANDWIDTH // 2
    fast_src = rng.choice(FAST, n_pairs, replace=False)
    slow = FAST + rng.choice(PAGES, 2 * n_pairs, replace=False)
    src = np.full(M, trash, np.int32)
    dst = np.full(M, trash, np.int32)
    src[:n_pairs], dst[:n_pairs] = fast_src, slow[:n_pairs]
    src[n_pairs : 2 * n_pairs], dst[n_pairs : 2 * n_pairs] = slow[n_pairs:], fast_src
    s = s_mv = torch.as_tensor(src, device=device)
    d = d_mv = torch.as_tensor(dst, device=device)
    ops.page_move(pool_a, s, d)
    ref.page_move_ref(pool_b, s, d)
    torch.cuda.synchronize()
    check(torch.equal(pool_a.view(torch.int32), pool_b.view(torch.int32)),
          "page_move kernel bit-equal to its plain version")
    err = max_abs_err(torch, pool_a, pool_b)
    s64, d64 = s.to(torch.int64), d.to(torch.int64)
    n_real = 2 * n_pairs
    out["page_move"] = dict(
        max_abs_err=err,
        ms=time_cuda(torch, lambda: ops.page_move(pool_a, s, d)),
        plain_ms=time_cuda(torch, lambda: ref.page_move_ref(pool_b, s, d)),
        library_ms=time_cuda(
            torch, lambda: pool_b.index_copy_(0, d64, pool_b.index_select(0, s64))),
        bytes=2 * n_real * row_bytes + 2 * 4 * M,
        shape=f"pool[{rows},{ELEMS}]f32 plan={M} real={n_real}",
    )

    # page_copy: a full staging pool of plan_slots rows into the pool, the
    # tail of the plan padded onto the trash row
    pool_b.copy_(pool_a)
    staging = page_pattern(torch, torch.arange(M, device=device) + 7 * PAGES, ELEMS)
    n_pad = 1000
    dst = (rng.choice(rows - 1, M, replace=False)).astype(np.int32)
    dst[-n_pad:] = trash
    s = s_cp = torch.arange(M, dtype=torch.int32, device=device)
    d = d_cp = torch.as_tensor(dst, device=device)
    ops.page_copy(staging, pool_a, s, d)
    ref.page_copy_ref(staging, pool_b, s, d)
    torch.cuda.synchronize()
    check(torch.equal(pool_a[:-1].view(torch.int32), pool_b[:-1].view(torch.int32)),
          "page_copy kernel bit-equal to its plain version off the trash row")
    err = max_abs_err(torch, pool_a[:-1], pool_b[:-1])
    s64, d64 = s.to(torch.int64), d.to(torch.int64)
    out["page_copy"] = dict(
        max_abs_err=err,
        ms=time_cuda(torch, lambda: ops.page_copy(staging, pool_a, s, d)),
        plain_ms=time_cuda(torch, lambda: ref.page_copy_ref(staging, pool_b, s, d)),
        library_ms=time_cuda(
            torch, lambda: pool_b.index_copy_(0, d64, staging.index_select(0, s64))),
        # the padded entries leave one row in the trash: M - n_pad + 1 rows
        # must be read and written
        bytes=2 * (M - n_pad + 1) * row_bytes + 2 * 4 * M,
        shape=f"staging[{M},{ELEMS}] -> pool[{rows},{ELEMS}]f32",
    )

    # hot_bins: the sampled page ids of one epoch of the slice's stream
    pages_of, lo = [], 0
    for n in tenant_sizes(PAGES, len(T_MISS)):
        pages_of.append(np.arange(lo, lo + n))
        lo += n
    rates = access_rates(torch, pages_of, PAGES, ACCESSES_PER_TENANT, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    sampled = sample_accesses(gen, epoch_counts(torch, rates, gen), 100)
    ids = torch.repeat_interleave(
        torch.arange(PAGES, dtype=torch.int32, device=device), sampled
    ).contiguous()
    cin = torch.as_tensor(rng.integers(0, 40, PAGES).astype(np.int32), device=device)
    kc, kb = ops.hot_bins(ids, cin, num_bins=6)
    pc, pb = ref.hot_bins_ref(ids, cin, 6)
    torch.cuda.synchronize()
    check(torch.equal(kc, pc) and torch.equal(kb, pb),
          "hot_bins kernel bit-equal to its plain version")
    N = int(ids.shape[0])
    err = float(max((kc - pc).abs().max().item(), (kb - pb).abs().max().item()))
    out["hot_bins"] = dict(
        max_abs_err=err,
        ms=time_cuda(torch, lambda: ops.hot_bins(ids, cin, num_bins=6)),
        plain_ms=time_cuda(torch, lambda: ref.hot_bins_ref(ids, cin, 6)),
        library_ms=time_cuda(torch, lambda: torch.bincount(ids, minlength=PAGES)),
        bytes=4 * N + 12 * PAGES,
        shape=f"ids[{N}] counts[{PAGES}]",
    )
    out["page_move"]["device_ms"] = device_ms(torch, lambda: ops.page_move(pool_a, s_mv, d_mv))
    out["page_copy"]["device_ms"] = device_ms(
        torch, lambda: ops.page_copy(staging, pool_a, s_cp, d_cp))
    out["hot_bins"]["device_ms"] = device_ms(torch, lambda: ops.hot_bins(ids, cin, num_bins=6))
    del pool_a, pool_b, staging
    torch.cuda.empty_cache()
    for name, r in out.items():
        r["bound_ms"] = bound_ms(r["bytes"])
        emit(f"phase2 {name}", **r)
    return out


# ------------------------------------------------------------------ phase 3
def build_manager(torch, np, device, n_pages, *, exact, elems, queue, bandwidth, budget):
    from repro_torch.core.manager import CentralManager

    m = CentralManager(
        num_pages=n_pages, fast_capacity=n_pages // 4, migration_budget=budget,
        max_tenants=TENANTS, sample_period=100, queue_size=queue,
        migration_bandwidth=bandwidth, data_plane_elems=elems, sentinel=True,
        exact_sampling=exact, seed=SEED, device=device,
    )
    pages_of = []
    for n, t in zip(tenant_sizes(n_pages, len(T_MISS)), T_MISS):
        h = m.register(t)
        pages_of.append(m.allocate(h, n))
    for ids in pages_of:
        for lo in range(0, len(ids), 1 << 17):
            chunk = ids[lo : lo + (1 << 17)]
            rows = page_pattern(torch, torch.as_tensor(chunk, device=device), elems)
            m.pool.write_pages(chunk, rows)
    return m, pages_of


def hot_fast_share(np, m, pages_of) -> float:
    tiers = m.tiers()
    hot = np.concatenate(
        [ids[: len(ids) // 2] for t, ids in enumerate(pages_of) if T_MISS[t] < 1.0])
    return float((tiers[hot] == 1).mean())


def readback_ok(torch, m, pages_of, chunk: int = 1 << 16) -> bool:
    for ids in pages_of:
        for lo in range(0, len(ids), chunk):
            c = ids[lo : lo + chunk]
            got = m.pool.read_pages(c)
            want = page_pattern(torch, torch.as_tensor(c, device=got.device), got.shape[1])
            if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
                return False
    return True


def run_slice(torch, np, device):
    """The slice end to end; returns its numbers (raises on a failed check).
    The epochs' access counts are drawn before the timed window, and the
    hot-set share after the first epoch is read outside it."""
    from repro_torch.kernels import ops

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    m, pages_of = build_manager(torch, np, device, PAGES, exact=False, elems=ELEMS,
                                queue=QUEUE, bandwidth=BANDWIDTH, budget=BUDGET)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rates = access_rates(torch, pages_of, PAGES, ACCESSES_PER_TENANT, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    counts = [epoch_counts(torch, rates, gen) for _ in range(EPOCHS)]
    burst_counts = torch.stack([epoch_counts(torch, rates, gen) for _ in range(BURST)])
    sentinels = []
    share_first = None
    epochs_s = 0.0
    for e, c in enumerate(counts):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.record_access(c)
        res = m.run_epoch()
        sentinels.append(int(res.stats.sentinel))
        torch.cuda.synchronize()
        epochs_s += time.perf_counter() - t0
        if e == 0:
            share_first = hot_fast_share(np, m, pages_of)
    t0 = time.perf_counter()
    multi = m.run_epochs(BURST, burst_counts)
    sentinels += [int(x) for x in multi.stats.sentinel.tolist()]
    torch.cuda.synchronize()
    epochs_s += time.perf_counter() - t0
    launches = ops.launch_counts()

    share_last = hot_fast_share(np, m, pages_of)
    intact = readback_ok(torch, m, pages_of)
    check(intact, "every page reads back the bytes written to it")
    m.pool.check(m.tiers())
    qc = m.queue_counters()
    check(qc["enqueued"] == qc["drained"] + qc["cancelled"] + qc["dropped"] + qc["depth"],
          f"queue conservation {qc}")
    check(all(s == 0 for s in sentinels), f"sentinel words all 0: {sentinels}")
    check(share_last > share_first, f"LS hot fast share rose ({share_first} -> {share_last})")
    fmmr = m.tenants.a_miss.cpu().numpy()
    check(np.isfinite(fmmr).all() and fmmr.shape == (TENANTS,), "FMMR finite, [T]")
    check(launches["page_move"] > 0 and launches["page_copy"] > 0, f"launches {launches}")
    n_ep = EPOCHS + BURST
    ph = m.phase_seconds
    busy = profile_epochs(torch, m, rates, gen)
    return dict(
        setup_s=setup_s, epochs=n_ep, epochs_s=epochs_s, ms_per_epoch=epochs_s / n_ep * 1e3,
        tick_ms=ph["tick"] / n_ep * 1e3, sync_ms=ph["sync"] / n_ep * 1e3,
        execute_ms=ph["execute"] / n_ep * 1e3,
        page_move_host_ms=m.pool.move_seconds / n_ep * 1e3,
        moved_pages=m.pool.moved_pages, hot_fast_share_first=share_first,
        hot_fast_share_last=share_last, fmmr_ls_mean=float(fmmr[1:6].mean()),
        fmmr_be=float(fmmr[0]), queue=qc, launches=launches, **busy,
    )


def profile_epochs(torch, m, rates, gen, n: int = 2):
    """Device busy time per epoch over ``n`` more epochs under the profiler
    (after the slice's checks and launch counts), against their wall time."""
    from torch.profiler import ProfilerActivity, profile

    counts = [epoch_counts(torch, rates, gen) for _ in range(n)]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for c in counts:
            m.record_access(c)
            m.run_epoch()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / n * 1e3
    rows = sorted(prof.key_averages(), key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in rows) / n / 1e3
    top = ";".join(f"{e.key[:40].replace(' ', '_')}:{e.self_device_time_total / n / 1e3:.3f}"
                   for e in rows[:6])
    return dict(profiled_wall_ms=wall_ms, device_busy_ms=busy_ms,
                device_idle_share=(1 - busy_ms / wall_ms) if busy_ms else None,
                device_kernels=len(rows), top_device_ms=top)


# ------------------------------------------------------------------ phase 4
def gpu_vs_cpu(torch, np):
    """The same exact-sampling schedule on the card and on the CPU; returns
    (integer leaves equal, max float ulp difference, queue counters)."""
    n_pages = CHECK_PAGES
    budget, queue, bandwidth = n_pages // 32, n_pages // 16, n_pages // 128
    rng = np.random.default_rng(SEED + 1)
    runs = {}
    sizes = tenant_sizes(n_pages, len(T_MISS))
    counts = []
    lo = 0
    base = np.zeros(n_pages, np.float64)
    for t, n in enumerate(sizes):
        half = n // 2
        if T_MISS[t] >= 1.0:
            base[lo : lo + n] = 40.0
        else:
            base[lo : lo + half] = 150.0
            base[lo + half : lo + n] = 12.0
        lo += n
    for _ in range(12):
        counts.append(rng.poisson(base).astype(np.int64))
    for dev in ("cuda", "cpu"):
        m, _ = build_manager(torch, np, dev, n_pages, exact=True, elems=64, queue=queue,
                             bandwidth=bandwidth, budget=budget)
        for e in range(8):
            m.record_access(counts[e])
            m.run_epoch()
        m.run_epochs(4, np.stack(counts[8:12]))
        st = m._state
        runs[dev] = dict(
            tier=m.tiers(), owner=m.owners(), count=st.pages.count.cpu().numpy(),
            last_cool=st.pages.last_cool.cpu().numpy(),
            cool_epoch=st.tenants.cool_epoch.cpu().numpy(),
            queue_page=st.queue.page.cpu().numpy(), frame=m.pool.frame.copy(),
            pool=m.pool.pool.cpu().numpy(), counters=m.queue_counters(),
            a_miss=st.tenants.a_miss.cpu().numpy(),
        )
    g, c = runs["cuda"], runs["cpu"]
    ints_equal = all(
        np.array_equal(g[k], c[k])
        for k in ("tier", "owner", "count", "last_cool", "cool_epoch", "queue_page", "frame")
    ) and g["counters"] == c["counters"]
    ints_equal = ints_equal and np.array_equal(g["pool"].view(np.int32), c["pool"].view(np.int32))
    ulp = int(np.abs(g["a_miss"].view(np.int32).astype(np.int64)
                     - c["a_miss"].view(np.int32).astype(np.int64)).max())
    return ints_equal, ulp, g["counters"]


# --------------------------------------------------------------------- main
def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available; this script runs on the GPU",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card, flush=True)
    t0 = time.perf_counter()
    _build.build()
    emit("phase1", build_s=round(time.perf_counter() - t0, 3),
         torch=torch.__version__, cuda=torch.version.cuda,
         device=torch.cuda.get_device_name(0).replace(" ", "_"))
    device = torch.device("cuda")

    kern = kernel_checks(torch, np, device)

    torch.cuda.reset_peak_memory_stats()
    res = run_slice(torch, np, device)
    emit("phase3", **{k: v for k, v in res.items() if k not in ("queue", "launches")},
         peak_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3))
    emit("phase3 queue", **res["queue"])
    emit("phase3 launches", **res["launches"])

    ints_equal, ulp, counters = gpu_vs_cpu(torch, np)
    emit("phase4", pages=CHECK_PAGES, integer_leaves_equal=ints_equal, a_miss_max_ulp=ulp,
         **counters)
    check(ints_equal, "GPU and CPU runs bit-equal on integer state and page bytes")
    check(ulp <= 2, "FMMR within 2 ulp between GPU and CPU")

    sources = {
        "page_move": ("src/repro_torch/kernels/csrc/page_copy.cu",
                      "src/repro/kernels/page_copy.py:34"),
        "page_copy": ("src/repro_torch/kernels/csrc/page_copy.cu",
                      "src/repro/kernels/page_copy.py:68"),
        "hot_bins": ("src/repro_torch/kernels/csrc/hot_bins.cu",
                     "src/repro/kernels/hot_bins.py:59"),
    }
    rows = []
    for name, (src, replaces) in sources.items():
        k = kern[name]
        rows.append({
            "name": name, "route": "cuda", "source": src, "replaces": replaces,
            "launches": res["launches"][name], "max_abs_err": k["max_abs_err"],
            "ms": k["ms"], "plain_ms": k["plain_ms"], "bound_ms": k["bound_ms"],
            "bound_by": "bytes", "library_ms": k["library_ms"],
        })
    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.exit(main())
