"""The reference names the main path's ported modules lacked, on the port:
``bins.accumulate_samples``, ``count_histogram`` and ``heat_histogram``;
``OwnerSegments.build`` and ``MigrationQueue.depth``;
``TieredPagedKV.slots_for`` and ``tier_of_pages``.

The reference's own tests of them (``tests/test_core_bins.py:42-110``,
``tests/test_policy_engine.py:122``, ``tests/test_migration_queue.py:544``)
run on the port, and each name is run on both packages on the same numpy
inputs. Tolerance: none; every result is an integer or boolean array,
compared bit for bit.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:  # clean checkout: deterministic fallback sweep
    from _hypothesis_fallback import given, settings, st

from repro.configs import get_config as jax_get_config
from repro.core import bins as jbins
from repro.core import policy as jpolicy
from repro.core import types as jtypes
from repro.kvcache.paged import TieredPagedKV as JaxKV
from repro_torch.configs import get_config
from repro_torch.core import bins, policy
from repro_torch.core.types import (
    TIER_FAST,
    TIER_SLOW,
    MigrationQueue,
    OwnerSegments,
    PageState,
    TenantState,
)
from repro_torch.kvcache.paged import TieredPagedKV

CPU = torch.device("cpu")


def _t(x, dtype=torch.int64):
    return torch.as_tensor(np.asarray(x)).to(dtype)


def _mk_state(P=8, T=2):
    pages = PageState.create(P, CPU)._replace(
        owner=torch.zeros(P, dtype=torch.int16),
        tier=torch.full((P,), TIER_SLOW, dtype=torch.int8),
    )
    tenants = TenantState.create(T, CPU)
    tenants.active[0] = True
    return pages, tenants


def _mk_ref_state(P=8, T=2):
    pages = jtypes.PageState.create(P)._replace(
        owner=jnp.zeros((P,), jnp.int32), tier=jnp.full((P,), TIER_SLOW, jnp.int8))
    tenants = jtypes.TenantState.create(T)
    return pages, tenants._replace(active=tenants.active.at[0].set(True))


# -------------------------------------- tests/test_core_bins.py:42-110
def test_cooling_fires_once_and_halves():
    pages, tenants = _mk_state()
    sampled = _t([40, 2, 0, 0, 0, 0, 0, 0])  # page 0 over 2^5
    pages2, tenants2, cooled = bins.accumulate_samples(pages, tenants, sampled, 6)
    assert bool(cooled[0])
    assert int(tenants2.cool_epoch[0]) == 1
    assert int(pages2.count[0]) == 20  # touched pages: the halving is materialised
    assert int(pages2.count[1]) == 1
    rp, rt = _mk_ref_state()
    rp2, rt2, rc = jbins.accumulate_samples(rp, rt, jnp.array([40, 2, 0, 0, 0, 0, 0, 0],
                                                             jnp.uint32), 6)
    np.testing.assert_array_equal(pages2.count.numpy(), np.asarray(rp2.count, np.int64))
    np.testing.assert_array_equal(pages2.last_cool.numpy(), np.asarray(rp2.last_cool))
    np.testing.assert_array_equal(tenants2.cool_epoch.numpy(), np.asarray(rt2.cool_epoch))
    np.testing.assert_array_equal(cooled.numpy(), np.asarray(rc))


def test_lazy_cooling_applies_on_next_read():
    pages, tenants = _mk_state()
    pages.count[1] = 12  # a stale count from before 2 cooling events
    tenants.cool_epoch[0] = 2
    assert int(bins.effective_count(pages, tenants)[1]) == 3  # 12 >> 2


def test_heat_histogram_groups_by_tenant_and_bin():
    pages, tenants = _mk_state(P=6, T=2)
    owner, count = [0, 0, 0, 1, 1, 1], [0, 1, 16, 2, 2, 31]
    pages = pages._replace(owner=_t(owner, torch.int16), count=_t(count))
    tenants = tenants._replace(active=torch.tensor([True, True]))
    hist = bins.heat_histogram(pages, tenants, 6, 2)
    assert hist.shape == (2, 6) and hist.dtype == torch.int32
    assert hist[0].tolist() == [1, 1, 0, 0, 0, 1]
    assert hist[1].tolist() == [0, 0, 2, 0, 0, 1]
    assert int(hist.sum()) == 6
    rp, rt = _mk_ref_state(P=6, T=2)
    rp = rp._replace(owner=jnp.array(owner, jnp.int32), count=jnp.array(count, jnp.uint32))
    rt = rt._replace(active=jnp.array([True, True]))
    np.testing.assert_array_equal(hist.numpy(), np.asarray(jbins.heat_histogram(rp, rt, 6, 2)))


@settings(max_examples=50, deadline=None)
@given(counts=st.lists(st.integers(0, 2**20), min_size=4, max_size=64),
       cools=st.integers(0, 10))
def test_property_effective_count_monotone_in_cooling(counts, cools):
    """More pending cooling events never increase effective counts."""
    P = len(counts)
    pages = PageState.create(P, CPU)._replace(
        owner=torch.zeros(P, dtype=torch.int16),
        tier=torch.full((P,), TIER_SLOW, dtype=torch.int8), count=_t(counts))
    tenants = TenantState.create(1, CPU)._replace(active=torch.tensor([True]))
    eff0 = bins.effective_count(pages, tenants)
    eff1 = bins.effective_count(pages, tenants._replace(cool_epoch=tenants.cool_epoch + cools))
    assert bool((eff1 <= eff0).all())
    assert np.all(eff1.numpy() == (np.asarray(counts, np.uint32) >> min(cools, 31)))


@settings(max_examples=50, deadline=None)
@given(sampled=st.lists(st.integers(0, 100), min_size=8, max_size=32))
def test_property_bins_ordering_preserved(sampled):
    """Accumulation preserves heat ordering: a hotter page's bin >= a colder's."""
    P = len(sampled)
    pages = PageState.create(P, CPU)._replace(
        owner=torch.zeros(P, dtype=torch.int16),
        tier=torch.full((P,), TIER_SLOW, dtype=torch.int8))
    tenants = TenantState.create(1, CPU)._replace(active=torch.tensor([True]))
    pages2, tenants2, _ = bins.accumulate_samples(pages, tenants, _t(sampled), 6)
    eff = bins.effective_count(pages2, tenants2).numpy()
    b = bins.bin_of(torch.as_tensor(eff), 6).numpy()
    order = np.argsort(np.asarray(sampled))
    assert np.all(np.diff(b[order]) >= 0) or np.all(np.diff(eff[order]) >= 0)


# -------------------------------------------- tests/test_policy_engine.py:122
def test_selection_matches_lexsort_reference():
    """Promote/demote sets from ``count_histogram``'s histograms equal a numpy
    lexsort reference (exact ranks, stable tie-break) across random states,
    and the reference's histograms and masks."""
    rng = np.random.default_rng(3)
    for trial in range(10):
        P, T = int(rng.integers(50, 400)), int(rng.integers(1, 5))
        tier = np.where(rng.random(P) < 0.3, TIER_FAST, TIER_SLOW)
        owner = rng.integers(0, T, P)
        counts = rng.integers(0, 25, P)
        quota_p = rng.integers(0, 30, T)
        quota_d = rng.integers(0, 30, T)
        C = 64
        key, ownr = _t(counts), _t(owner)
        slow_cand, fast_cand = torch.as_tensor(tier == TIER_SLOW), torch.as_tensor(tier == TIER_FAST)
        hist_slow = bins.count_histogram(key, ownr, slow_cand, C, T)
        hist_fast = bins.count_histogram(key, ownr, fast_cand, C, T)
        oh = ownr[None, :] == torch.arange(T)[:, None]
        pm, dm = policy._select_victims(
            key, ownr, slow_cand, fast_cand, hist_slow, hist_fast,
            torch.cumsum(hist_slow, dim=1), torch.cumsum(hist_fast, dim=1),
            _t(quota_p), _t(quota_d), oh)
        pm, dm = pm.numpy(), dm.numpy()
        for t in range(T):
            s_ids = np.flatnonzero((owner == t) & (tier == TIER_SLOW))
            order = s_ids[np.lexsort((s_ids, -counts[s_ids]))]
            assert set(np.flatnonzero(pm & (owner == t)).tolist()) == set(order[: quota_p[t]].tolist())
            f_ids = np.flatnonzero((owner == t) & (tier == TIER_FAST))
            order = f_ids[np.lexsort((f_ids, counts[f_ids]))]
            assert set(np.flatnonzero(dm & (owner == t)).tolist()) == set(order[: quota_d[t]].tolist())
        if trial >= 3:  # the reference, eager at a new shape each trial, on the first three
            continue
        jk, jo = jnp.asarray(counts, jnp.int32), jnp.asarray(owner, jnp.int32)
        js, jf = jnp.asarray(tier == TIER_SLOW), jnp.asarray(tier == TIER_FAST)
        jhs = jbins.count_histogram(jk, jo, js, C, T)
        jhf = jbins.count_histogram(jk, jo, jf, C, T)
        np.testing.assert_array_equal(hist_slow.numpy(), np.asarray(jhs))
        np.testing.assert_array_equal(hist_fast.numpy(), np.asarray(jhf))
        jpm, jdm = jpolicy._select_victims(
            jk, jo, js, jf, jhs, jhf, jnp.cumsum(jhs, axis=1), jnp.cumsum(jhf, axis=1),
            jnp.asarray(quota_p, jnp.int32), jnp.asarray(quota_d, jnp.int32),
            jo[None, :] == jnp.arange(T, dtype=jnp.int32)[:, None])
        np.testing.assert_array_equal(pm, np.asarray(jpm))
        np.testing.assert_array_equal(dm, np.asarray(jdm))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_count_histogram_matches_reference(seed):
    """Keys past the last bucket clamp into it; masked-out pages and the
    packed int16 owner leaf count as the reference's do."""
    rng = np.random.default_rng(seed)
    P, T, C = 500, 7, 16
    values = rng.integers(0, 40, P)
    owner = rng.integers(0, T, P)
    mask = rng.random(P) < 0.6
    got = bins.count_histogram(_t(values), _t(owner, torch.int16), torch.as_tensor(mask), C, T)
    want = jbins.count_histogram(jnp.asarray(values, jnp.uint32), jnp.asarray(owner, jnp.int16),
                                 jnp.asarray(mask), C, T)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got.sum()) == int(mask.sum())


# -------------------------------------------------------------- types
def test_owner_segments_build_matches_reference():
    rng = np.random.default_rng(4)
    owner = np.where(rng.random(300) < 0.2, -1, rng.integers(0, 6, 300)).astype(np.int32)
    want = jtypes.OwnerSegments.build(owner, 6)
    for got in (OwnerSegments.build(owner, 6, device=CPU),
                OwnerSegments.build(torch.as_tensor(owner, dtype=torch.int16), 6)):
        for f in ("order", "inv", "start"):
            assert getattr(got, f).device == CPU and getattr(got, f).dtype == torch.int64
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))


def test_owner_segments_build_of_a_numpy_owner_follows_resolve_device(monkeypatch):
    """The reference's build lands on the default device; the port's, for a
    numpy owner and no device, on ``resolve_device``'s: the card, and
    without one a clear error (it used to stay on the CPU unasked)."""
    from repro_torch.core import manager

    owner = np.array([1, -1, 0, 1], np.int32)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        OwnerSegments.build(owner, 2)
    asked = []
    monkeypatch.setattr(manager, "resolve_device",
                        lambda d=None, what="": asked.append((d, what)) or torch.device("cpu"))
    got = OwnerSegments.build(owner, 2)
    assert asked == [(None, "OwnerSegments.build")] and got.order.device == CPU
    assert got.order.tolist() == [2, 0, 3, 1] and got.start.tolist() == [0, 1, 3]


# ------------------------------------------ tests/test_migration_queue.py:544
def test_queue_create_and_depth():
    q = MigrationQueue.create(8, CPU)
    assert q.size == 8
    assert int(q.depth) == 0 and isinstance(q.depth, torch.Tensor)
    q.page[0] = 5
    assert int(q.depth) == 1
    rq = jtypes.MigrationQueue.create(8)
    rq = rq._replace(page=rq.page.at[0].set(5).at[3].set(2))
    q.page[3] = 2
    assert int(q.depth) == int(rq.depth) == 2


# ------------------------------------------------------------- kvcache
def test_slots_for_and_tier_of_pages_match_reference():
    """After the slot map is permuted as migrations permute it, both
    packages map logical pages to the same slots and tiers, for ids of any
    shape."""
    cfg = get_config("yi-6b").smoke()
    port = TieredPagedKV(cfg, 4, 12, page_tokens=4, device="cpu")
    ref = JaxKV(jax_get_config("yi-6b").smoke(), 4, 12, page_tokens=4)
    perm = np.random.default_rng(5).permutation(16).astype(np.int32)
    port.slot_of[:] = perm
    ref.slot_of[:] = perm
    for ids in (np.arange(16), np.array([[3, 0, 15], [7, 7, 1]]), [2, 9]):
        np.testing.assert_array_equal(port.slots_for(ids), ref.slots_for(ids))
        np.testing.assert_array_equal(port.tier_of_pages(ids), ref.tier_of_pages(ids))
    assert set(np.unique(port.tier_of_pages(np.arange(16)))) == {TIER_FAST, TIER_SLOW}
    assert int((port.tier_of_pages(np.arange(16)) == TIER_FAST).sum()) == 4
