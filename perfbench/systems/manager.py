"""A deployment of the MaxMem manager on one card: ``CentralManager`` in
queue mode over a ``PagePool`` that holds every page's bytes, tenants
registered and allocated in the configuration's order, and epochs back to
back over a cycle of per-epoch access counts drawn during set-up.

The window drives ``record_access`` + ``run_epoch``, the path a deployment
runs once an epoch. ``correct`` compares, once the window has closed:

  * every page's bytes, read where the program's frame table puts it, with
    the content the benchmark wrote (``reference/pages.py``);
  * the frame table against the tiers (fast pages on fast frames, one page
    a frame);
  * the final tier of every page, each tenant's FMMR, the queue's
    counters and the pages moved in every epoch, with ``reference/maxmem.py``
    replaying every epoch the program ran from the same inputs (the
    configuration, the access counts and the sampler's seed);
  * the program's own sentinel words (invariants after every epoch).
"""
from __future__ import annotations

import contextlib
import gc
import time

import numpy as np
import torch

from perfbench import costs, trace
from perfbench import traffic as tr
from perfbench.reference import maxmem as ref
from perfbench.reference import pages as ref_pages

CHUNK = 1 << 16


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class System:
    def __init__(self, cfg: dict, wl: dict, seed: int, device):
        self.cfg, self.wl, self.seed = cfg, wl, seed
        self.device = torch.device(device)
        self.manager_seed = tr.subseed(seed, "sampler")
        self.content_seed = tr.subseed(seed, "content")
        self.n = 0
        self.moved, self.sentinel = [], []
        self.layer = {}

    # ------------------------------------------------------------ set-up
    def setup(self) -> None:
        from repro_torch.core.manager import CentralManager

        c = self.cfg
        self.m = CentralManager(
            num_pages=c["pages"], fast_capacity=c["fast_capacity"],
            migration_budget=c["migration_budget"], max_tenants=c["max_tenants"],
            num_bins=c["num_bins"], sample_period=c["sample_period"],
            ewma_lambda=c["ewma_lambda"], hysteresis=c["hysteresis"],
            seed=self.manager_seed, queue_size=c["queue_size"],
            migration_bandwidth=c["migration_bandwidth"], data_plane_elems=c["page_elems"],
            # the program's invariant words after every epoch, part of the check
            sentinel=True, device=self.device,
        )
        pages_of = []
        for t in c["tenants"]:
            h = self.m.register(t["t_miss"])
            pages_of.append(torch.as_tensor(self.m.allocate(h, t["pages"])))
        # one page_copy call a plan's worth of rows (the pool's staging size)
        step = self.m.pool.plan_slots
        rows = torch.empty((step, c["page_elems"]), dtype=torch.float32, device=self.device)
        for lo in range(0, c["pages"], step):
            ids = np.arange(lo, min(lo + step, c["pages"]))
            for a in range(0, len(ids), CHUNK):
                part = ids[a: a + CHUNK]
                rows[a: a + len(part)] = ref_pages.content(
                    torch.as_tensor(part, device=self.device), c["page_elems"],
                    self.content_seed)
            self.m.pool.write_pages(ids, rows[: len(ids)])
        rates = tr.page_rates(c, pages_of, self.seed, self.device)
        self.cycle = tr.epoch_cycle(rates, self.wl["cycle_epochs"], self.seed)
        for _ in range(self.wl["warmup_epochs"]):
            self._epoch()

    def _epoch(self) -> None:
        self.m.record_access(self.cycle[self.n % self.cycle.shape[0]])
        res = self.m.run_epoch()
        q = res.stats.queue
        self.moved.append((q.drained_promote, q.drained_demote))
        self.sentinel.append(res.stats.sentinel)
        self.n += 1

    # ------------------------------------------------------------ window
    def window(self, seconds: float) -> dict:
        """Epochs back to back until ``seconds`` have passed; the window
        ends when the last epoch's work has finished on the card."""
        _sync(self.device)
        n0 = self.n
        t0 = time.perf_counter()
        while True:
            self._epoch()
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(self.device)
        wall = time.perf_counter() - t0
        epochs = self.n - n0
        self.window_epochs = (n0, self.n)
        return {"attempted": epochs, "wall_s": wall, "e2e": {"epoch_ms": wall / epochs * 1e3}}

    def failed(self) -> int:
        lo, hi = self.window_epochs
        return int((torch.stack(self.sentinel[lo:hi]) != 0).sum())

    @contextlib.contextmanager
    def instrument(self):
        """Ranges around the manager's entry points and the counters the
        per-layer readers take, over the traced window."""
        from repro_torch.core import dataplane, manager, policy
        from repro_torch.kernels import ops

        moved = []

        def page_move(orig):
            def inner(pool, src_ids, dst_ids):
                moved.append(costs.page_move_bytes(pool, src_ids, dst_ids))
                with torch.profiler.record_function(trace.PREFIX + "page_move"):
                    return orig(pool, src_ids, dst_ids)

            return inner

        with contextlib.ExitStack() as st:
            st.enter_context(trace.patched(ops, "page_move", page_move))
            st.enter_context(trace.patched(policy, "epoch_step", trace.ranged("tick")))
            st.enter_context(trace.patched(dataplane.PagePool, "execute", trace.ranged("execute")))
            st.enter_context(trace.patched(manager.CentralManager, "run_epoch",
                                           trace.ranged("run_epoch")))
            st.enter_context(trace.patched(manager.CentralManager, "record_access",
                                           trace.ranged("record_access")))
            ph0, n0 = dict(self.m.phase_seconds), self.n
            yield
            ph = self.m.phase_seconds
            self.layer.update(
                epochs=self.n - n0, tick_s=ph["tick"] - ph0["tick"],
                execute_s=ph["execute"] - ph0["execute"],
                page_move_bytes=float(torch.stack(moved).sum()) if moved else 0.0,
            )

    # ------------------------------------------------------------ checks
    def verify(self) -> dict:
        """{name: (value, limit)}; frees the program's state before the
        reference runs."""
        c, m = self.cfg, self.m
        P = c["pages"]
        tiers = torch.as_tensor(m.tiers().astype(np.int64))
        fmmr = m.tenants.a_miss.detach().float().cpu()
        counters = m.queue_counters()
        moved = [int(p) + int(d) for p, d in
                 zip(torch.stack([a for a, _ in self.moved]).cpu().tolist(),
                     torch.stack([b for _, b in self.moved]).cpu().tolist())]
        sentinel_bad = int((torch.stack(self.sentinel) != 0).sum())
        frame = np.asarray(m.pool.frame)
        fast = tiers.numpy() == ref.FAST
        frames_bad = int(((frame < m.pool.fast_capacity) != fast).sum() + (frame < 0).sum()
                         + (P - np.unique(frame).size))

        def rows(ids):
            return m.pool.read_pages(ids.numpy())

        bytes_bad = ref_pages.wrong_pages(rows, P, c["page_elems"], self.content_seed)
        del m, self.m
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

        r = self.replay()
        ref_moved = r.moved_per_epoch
        queue_bad = sum(int(counters[k] != v) for k, v in r.counters().items())
        queue_bad += sum(int(a != b) for a, b in zip(moved, ref_moved))
        queue_bad += abs(len(moved) - len(ref_moved))
        return {
            "bytes_bad": (bytes_bad, 0),
            "frames_bad": (frames_bad, 0),
            "tiers_bad": (int((r.tier.cpu() != tiers).sum()), 0),
            "fmmr_gap": (float((r.a_miss.cpu() - fmmr).abs().max()), 0.0),
            "queue_bad": (queue_bad, 0),
            "sentinel_bad": (sentinel_bad, 0),
        }

    def replay(self) -> ref.Machine:
        """The reference's run of the same epochs from the same inputs."""
        c = self.cfg
        r = ref.Machine(
            pages=c["pages"], fast_capacity=c["fast_capacity"],
            migration_budget=c["migration_budget"], queue_size=c["queue_size"],
            migration_bandwidth=c["migration_bandwidth"], max_tenants=c["max_tenants"],
            sample_period=c["sample_period"], num_bins=c["num_bins"],
            ewma_lambda=c["ewma_lambda"], hysteresis=c["hysteresis"], device=self.device,
        )
        for t in c["tenants"]:
            r.allocate(r.register(t["t_miss"]), t["pages"])
        z = torch.Generator(device=self.device)
        z.manual_seed(self.manager_seed)
        r.moved_per_epoch = []
        for e in range(self.n):
            r.record(self.cycle[e % self.cycle.shape[0]])
            out = r.step(torch.randn(c["pages"], generator=z, device=self.device))
            r.moved_per_epoch.append(int(out["promoted"].numel() + out["demoted"].numel()))
        return r
