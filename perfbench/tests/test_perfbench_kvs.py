"""The kvs-gups-8m cell's run path at a small size on the CPU: a sound run
is correct, and each fault the cell can have, planted under the timed path,
turns ``correct`` false; the control (a data plane that flips tiers but
moves no bytes) too. On the card, the control at the cell's own size."""
from __future__ import annotations

import contextlib
import io
import time

import pytest
import torch

from perfbench import harness, trace

CELL = "kvs-gups-8m.colocate"


def small_cell(pages: int = 16384) -> dict:
    """The cell cut to ``pages``, every size in proportion (the traffic
    follows: accesses scale with the pages), with 64 bytes of content a
    page."""
    cell = harness.load_cell(CELL)
    c = cell["config"]
    cut = pages / c["pages"]
    for k in ("fast_capacity", "migration_budget", "migration_bandwidth", "queue_size"):
        c[k] = max(int(c[k] * cut), 2)
    kv = round(pages * 320 / 576)
    c.update(pages=pages, page_elems=16)
    c["tenants"][0]["pages"], c["tenants"][1]["pages"] = kv, pages - kv
    return cell


def run(cell, seed=2**31 + 99, seconds=0.4, device="cpu"):
    return harness.run_cell(cell, seed, seconds, False, torch.device(device),
                            time.perf_counter(), log=io.StringIO())


def bad_checks(res) -> set:
    return {k for k, c in res["checks"].items() if not c["value"] <= c["limit"]}


def test_sound_run_is_correct_and_reports_its_metrics():
    res = run(small_cell())
    assert res["correct"] and not bad_checks(res)
    assert res["attempted"] > 0 and res["failed"] == 0
    assert set(res["metrics"]) == {"epoch_ms", "setup_s"}
    assert res["device"]["platform"] == "cpu"
    assert list(res)[-1] == "checks"


@contextlib.contextmanager
def planted(fault: str):
    from repro_torch.core import manager, policy
    from repro_torch.kernels import ops

    if fault == "state_unchanged":
        def wrap(orig):
            def step(state, *a, **kw):
                _, plan, stats = orig(state, *a, **kw)
                q = stats.queue
                none = torch.full_like(q.drained_promote_ids, -1)
                stats = stats._replace(queue=q._replace(drained_promote_ids=none,
                                                        drained_demote_ids=none))
                return state._replace(pending=torch.zeros_like(state.pending)), plan, stats
            return step
        with trace.patched(policy, "epoch_step", wrap):
            yield
    elif fault == "half_batch":
        def wrap(orig):
            def record(self, counts):
                counts = counts.clone()
                counts[counts.shape[0] // 2:] = 0
                return orig(self, counts)
            return record
        with trace.patched(manager.CentralManager, "record_access", wrap):
            yield
    elif fault in ("altered_row", "no_bytes_moved"):
        def wrap(orig):
            def move(pool, src, dst):
                if fault == "no_bytes_moved":
                    return pool
                out = orig(pool, src, dst)
                real = (src != dst).nonzero()
                if real.numel():
                    pool[dst[real[0, 0]].long(), 1] += 1.0
                return out
            return move
        with trace.patched(ops, "page_move", wrap):
            yield
    else:
        raise ValueError(fault)


@pytest.mark.parametrize("fault, caught_by", [
    ("state_unchanged", "tiers_bad"),
    ("half_batch", "fmmr_gap"),
    ("altered_row", "bytes_bad"),
    ("no_bytes_moved", "bytes_bad"),  # the control
])
def test_planted_fault_is_not_correct(fault, caught_by):
    with planted(fault):
        res = run(small_cell())
    assert not res["correct"]
    assert caught_by in bad_checks(res)


def test_a_stall_shows_in_epoch_ms():
    """50 ms added to every epoch reads as at least 50 ms an epoch."""
    from repro_torch.core import manager

    def wrap(orig):
        def slow(self, *a, **kw):
            time.sleep(0.05)
            return orig(self, *a, **kw)
        return slow

    with trace.patched(manager.CentralManager, "run_epoch", wrap):
        res = run(small_cell(), seconds=0.5)
    assert res["correct"]
    assert res["metrics"]["epoch_ms"]["value"] >= 50


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [3_100_000_001, 3_100_000_002, 3_100_000_003])
def test_control_on_the_card_at_the_cells_size(seed):
    """The control at full size: a data plane that flips tiers and moves
    no bytes reads bytes_bad far above its limit of 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cell = harness.load_cell(CELL)
    with planted("no_bytes_moved"):
        res = run(cell, seed=seed, seconds=2.0, device="cuda")
    print("control", seed, {k: c["value"] for k, c in res["checks"].items()})
    assert not res["correct"] and res["checks"]["bytes_bad"]["value"] > 0
