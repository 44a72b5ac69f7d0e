"""Parity of the PyTorch policy tick with the JAX reference, on the CPU.

Inputs are made with numpy from a seed and fed to both packages. The port
runs on ``device="cpu"``; the reference on JAX's CPU backend.

Tolerance: integer leaves (tiers, owners, counts, stamps, queues, plans,
holdings, counters) are bit-equal. Float leaves (FMMR now/EWMA, a_miss) are
bit-equal as well, i.e. within 0 ulp: the port keeps the reference's
float32 order of operations, sums tenant vectors left to right as XLA:CPU
does, and evaluates the one multiply-add XLA:CPU contracts (the EWMA, the
sampler's ``lam + sqrt(lam) * z``) as a single-rounding fused multiply-add.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import golden_regen
from repro.core import bins as jbins
from repro.core import fmmr as jfmmr
from repro.core import policy as jpolicy
from repro.core import sampler as jsampler
from repro.core import types as jtypes
from repro_torch.core import bins as tbins
from repro_torch.core import fmmr as tfmmr
from repro_torch.core import policy as tpolicy
from repro_torch.core import sampler as tsampler
from repro_torch.core import types as ttypes
from repro_torch.core.manager import CentralManager as TorchManager
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

CPU = torch.device("cpu")


def _t(a, dtype=None):
    return torch.as_tensor(np.asarray(a) if dtype is None else np.asarray(a).astype(dtype))


def _assert_tree_equal(got, want, path="state"):
    """Leafwise bit-equality of two trees of numpy-convertible leaves
    (floats compared by their bits, so 0 ulp)."""
    if want is None:
        assert got is None, path
        return
    if hasattr(want, "_fields"):
        for f in want._fields:
            if f == "rng":
                continue
            _assert_tree_equal(getattr(got, f), getattr(want, f), f"{path}.{f}")
        return
    g = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, (path, g.shape, w.shape)
    if w.dtype.kind == "f":
        assert np.array_equal(g.astype(w.dtype).view(np.int32), w.view(np.int32)), path
    else:
        assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), path


# ------------------------------------------------------------- random states
def random_state(seed, P, T, queue_size, *, segs=True, huge_counts=False):
    """A reference PolicyState (numpy leaves) with consistent ownership and
    placement, random counters, cooling stamps, backlog and queue."""
    rng = np.random.default_rng(seed)
    n_active = max(T - 2, 1)
    owner = np.where(rng.random(P) < 0.85, rng.integers(0, n_active, P), -1).astype(np.int16)
    fast_cap = P // 4
    tier = np.full(P, -1, np.int8)
    owned = np.flatnonzero(owner >= 0)
    fast = rng.choice(owned, size=min(fast_cap - 3, len(owned)), replace=False)
    tier[owned] = 0
    tier[fast] = 1
    count = rng.integers(0, 200, P).astype(np.uint32)
    count[rng.random(P) < 0.1] = rng.integers(0, 5000, 1)[0]
    if huge_counts:
        big = rng.choice(owned, 5, replace=False)
        count[big] = np.array([2**31 + 7, 2**32 - 1, 2**31, 3 * 2**30, 2**32 - 2], np.uint32)
    cool_epoch = rng.integers(0, 4, T).astype(np.int32)
    last_cool = np.minimum(rng.integers(0, 4, P), cool_epoch[np.maximum(owner, 0)]).astype(np.int32)
    pending = rng.integers(0, 300, P).astype(np.uint32)
    pending[owner < 0] = 0
    active = np.zeros(T, bool)
    active[:n_active] = True
    tenants = jtypes.TenantState(
        active=active,
        t_miss=np.where(rng.random(T) < 0.5, 0.1, rng.uniform(0.05, 1.0, T)).astype(np.float32),
        a_miss=rng.uniform(0, 0.6, T).astype(np.float32),
        arrival=np.where(active, rng.permutation(T), np.iinfo(np.int32).max).astype(np.int32),
        cool_epoch=cool_epoch,
        flagged=np.zeros(T, bool),
    )
    pages = jtypes.PageState(owner=owner, tier=tier, count=count, last_cool=last_cool)
    queue = None
    epoch = np.int32(5)
    if queue_size:
        n_q = queue_size // 2
        qpages = rng.choice(owned, n_q, replace=False)
        page = np.full(queue_size, -1, np.int32)
        page[:n_q] = qpages
        direction = np.zeros(queue_size, np.int8)
        direction[:n_q] = np.where(tier[qpages] == 1, -1, 1)
        direction[: n_q // 8] = 0  # a few cooldown tombstones
        enq = np.zeros(queue_size, np.int32)
        enq[:n_q] = rng.integers(0, 5, n_q)
        cmp_ = np.zeros(queue_size, np.int32)
        cmp_[:n_q] = enq[:n_q] + rng.integers(0, 3, n_q)
        heat = np.zeros(queue_size, np.int8)
        heat[:n_q] = rng.integers(0, 6, n_q)
        queue = jtypes.MigrationQueue(page=page, direction=direction, enqueue_epoch=enq,
                                      complete_epoch=cmp_, heat=heat)
    else:
        queue = jtypes.MigrationQueue(
            page=np.zeros(0, np.int32), direction=np.zeros(0, np.int8),
            enqueue_epoch=np.zeros(0, np.int32), complete_epoch=np.zeros(0, np.int32),
            heat=np.zeros(0, np.int8),
        )
    sg = None
    if segs:
        order, inv, start = jtypes.segments_build_host(owner, T)
        sg = jtypes.OwnerSegments(order=order, inv=inv, start=start)
    return jtypes.PolicyState(
        pages=pages, tenants=tenants, pending=pending,
        rng=np.asarray(jax.random.PRNGKey(seed)), queue=queue, epoch=epoch, segs=sg,
    ), fast_cap


def params_pair(fast_cap, budget, *, queue, guards, lam=0.5, fair=False):
    kw = dict(
        fast_capacity=fast_cap, migration_budget=budget, num_bins=6, ewma_lambda=lam,
        sample_period=100, fair_mode=fair, hysteresis=0.08,
        migration_bandwidth=(budget // 2 if queue else -1),
        migration_latency=(1 if queue else 0), sentinel=1, alloc_headroom=0,
        promote_band=-1.0, demote_band=-1.0, promote_admission=-1, demote_cooldown=0,
    )
    if guards:
        kw.update(promote_band=0.15, demote_band=0.05, alloc_headroom=3)
        if queue:
            kw.update(promote_admission=budget // 4, demote_cooldown=2)
    jp = jtypes.PolicyParams(**{
        k: (v if k == "fair_mode" else
            (jnp.float32(v) if isinstance(v, float) else jnp.int32(v)))
        for k, v in kw.items()
    })
    tp = ttypes.PolicyParams(**{
        k: (v if k == "fair_mode" else (ttypes.f32(v) if isinstance(v, float) else int(v)))
        for k, v in kw.items()
    })
    return jp, tp


def _jax_state(ref):
    return jax.tree.map(jnp.asarray, ref)


# ------------------------------------------------------------------- bin_of
def test_bin_of_every_power_of_two_and_neighbours():
    vals = {0, 1, 2**32 - 1}
    for k in range(33):
        for d in (-1, 0, 1):
            v = 2**k + d
            if 0 <= v < 2**32:
                vals.add(v)
    c = np.array(sorted(vals), np.uint32)
    for nb in (1, 6, 16, 32):
        want = np.asarray(jbins.bin_of(jnp.asarray(c), nb))
        got = tbins.bin_of(_t(c, np.int64), nb).numpy()
        assert np.array_equal(got, want), nb


def test_bit_length_matches_python():
    c = np.array([0, 1, 2, 3, 255, 256, 2**24 + 1, 2**31, 2**32 - 1], np.int64)
    got = tref.bit_length(torch.as_tensor(c)).numpy()
    assert got.tolist() == [int(v).bit_length() for v in c]


# ------------------------------------------------------------------ sampler
@pytest.mark.parametrize("period", [1, 7, 100])
def test_sample_exact_and_shared_z(period):
    rng = np.random.default_rng(period)
    counts = rng.integers(0, 100_000, 50_000).astype(np.uint32)
    counts[:4] = [0, 2**32 - 1, 2**24 + 1, 1]
    z = rng.standard_normal(counts.shape).astype(np.float32)
    want = np.asarray(jsampler.sample_accesses(None, jnp.asarray(counts), period, exact=True))
    got = tsampler.sample_accesses(None, _t(counts, np.int64), period, exact=True)
    assert np.array_equal(got.numpy(), want.astype(np.int64))
    want_z = np.asarray(jax.jit(
        lambda c, z: jsampler.sample_accesses(None, c, period, z=z)
    )(jnp.asarray(counts), jnp.asarray(z)))
    got_z = tsampler.sample_accesses(None, _t(counts, np.int64), period, z=torch.as_tensor(z))
    assert np.array_equal(got_z.numpy(), want_z.astype(np.int64))


def test_fma_f32_single_rounding():
    rng = np.random.default_rng(0)
    a = rng.random(20_000).astype(np.float32)
    b = rng.random(20_000).astype(np.float32)
    c = (rng.random(20_000) * rng.choice([-1, 1], 20_000)).astype(np.float32)
    got = tsampler.fma_f32(torch.as_tensor(a), torch.as_tensor(b), torch.as_tensor(c)).numpy()
    from fractions import Fraction

    for i in range(0, 20_000, 997):
        exact = Fraction(float(a[i])) * Fraction(float(b[i])) + Fraction(float(c[i]))
        lo = np.float32(float(exact))
        cands = [np.nextafter(lo, np.float32(-np.inf)), lo, np.nextafter(lo, np.float32(np.inf))]
        best = min(cands, key=lambda v: (abs(Fraction(float(v)) - exact),
                                         int(np.asarray(v).view(np.int32)) & 1))
        assert got[i] == best, i


def test_ewma_matches_reference_fused_multiply_add():
    rng = np.random.default_rng(1)
    now = rng.random(4096).astype(np.float32)
    prev = rng.random(4096).astype(np.float32)
    for lam in (0.5, 0.37, 0.9):
        want = np.asarray(jax.jit(jfmmr.update_ewma)(prev, now, jnp.float32(lam)))
        got = tfmmr.update_ewma(torch.as_tensor(prev), torch.as_tensor(now), ttypes.f32(lam))
        assert np.array_equal(got.numpy().view(np.int32), want.view(np.int32)), lam


# ----------------------------------------------------- accumulate_and_count
@pytest.mark.parametrize("use_segs", [True, False])
def test_accumulate_and_count(use_segs):
    ref, _ = random_state(3, 2048, 8, 0, segs=use_segs)
    rng = np.random.default_rng(4)
    sampled = rng.integers(0, 40, 2048).astype(np.uint32)
    jst = _jax_state(ref)
    want = jax.jit(jbins.accumulate_and_count, static_argnums=(3,))(
        jst.pages, jst.tenants, jnp.asarray(sampled), 6, None, jst.segs
    )
    st = ttypes.state_from_numpy(ref, CPU)
    got = tbins.accumulate_and_count(st.pages, st.tenants, _t(sampled, np.int64), 6, segs=st.segs)
    _assert_tree_equal(got[0], want[0], "pages")
    _assert_tree_equal(got[1], want[1], "tenants")
    assert np.array_equal(got[2].numpy(), np.asarray(want[2]))
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]).astype(np.int64))


# --------------------------------------------------------------- reallocate
@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("fair", [False, True])
def test_reallocate(seed, fair):
    rng = np.random.default_rng(seed)
    T = 16
    active = rng.random(T) < 0.8
    a_miss = rng.uniform(0, 0.5, T).astype(np.float32)
    a_miss[rng.random(T) < 0.2] = 0.0
    ten = jtypes.TenantState(
        active=active,
        t_miss=rng.choice([0.1, 0.25, 1.0], T).astype(np.float32),
        a_miss=a_miss,
        arrival=rng.permutation(T).astype(np.int32),
        cool_epoch=np.zeros(T, np.int32), flagged=np.zeros(T, bool),
    )
    fast = rng.integers(0, 500, T).astype(np.int32)
    free = int(rng.integers(0, 100))
    budget = int(rng.integers(8, 400))
    bands = (None, None) if seed % 2 else (0.2, 0.03)
    want = jfmmr.reallocate(
        jax.tree.map(jnp.asarray, ten), jnp.asarray(fast), jnp.int32(free), jnp.int32(budget),
        fair_mode=fair, hysteresis=jnp.float32(0.08),
        need_band=None if bands[0] is None else jnp.float32(bands[0]),
        donor_band=None if bands[1] is None else jnp.float32(bands[1]),
    )
    tten = ttypes.TenantState(*(torch.as_tensor(np.asarray(x)) for x in ten))
    got = tfmmr.reallocate(
        tten, _t(fast, np.int64), torch.tensor(free), budget, fair_mode=fair,
        hysteresis=ttypes.f32(0.08), need_band=bands[0], donor_band=bands[1],
    )
    for f in ("give", "take", "flagged"):
        assert np.array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f))), f


# ------------------------------------------------------------ epoch_step
EPOCH_CASES = [
    # (P, queue_size, guards, segs, huge_counts)
    (4096, 0, False, True, False),
    (4096, 0, True, False, True),
    (4096, 256, False, True, True),
    (4096, 256, True, True, False),
    (4096, 256, True, False, False),
    (131072, 0, False, True, True),
    (131072, 1024, True, True, False),
    (131072, 0, False, False, False),
]


@pytest.mark.parametrize("P,Q,guards,segs,huge", EPOCH_CASES)
def test_epoch_step_matches_reference(P, Q, guards, segs, huge):
    T = 8
    ref, fast_cap = random_state(P + Q, P, T, Q, segs=segs, huge_counts=huge)
    budget = max(P // 32, 16)
    jp, tp = params_pair(fast_cap, budget, queue=Q > 0, guards=guards, lam=0.37)
    want_state, want_plan, want_stats = jpolicy.epoch_step(
        _jax_state(ref), jp, max_tenants=T, plan_size=budget, exact_sampling=True
    )
    st = ttypes.state_from_numpy(ref, CPU)
    got_state, got_plan, got_stats = tpolicy.epoch_step(
        st, tp, max_tenants=T, plan_size=budget, exact_sampling=True
    )
    _assert_tree_equal(ttypes.state_to_numpy(got_state), jax.device_get(want_state))
    _assert_tree_equal(got_plan, jax.device_get(want_plan), "plan")
    _assert_tree_equal(got_stats, jax.device_get(want_stats), "stats")


def test_multi_epoch_matches_reference():
    P, T, Q = 4096, 8, 256
    ref, fast_cap = random_state(11, P, T, Q)
    jp, tp = params_pair(fast_cap, 128, queue=True, guards=False)
    counts = np.random.default_rng(12).integers(0, 60, (3, P)).astype(np.uint32)
    want = jpolicy.multi_epoch(
        _jax_state(ref), jp, jnp.asarray(counts), k=3, max_tenants=T, plan_size=128,
        exact_sampling=True,
    )
    got = tpolicy.multi_epoch(
        ttypes.state_from_numpy(ref, CPU), tp, _t(counts, np.int64), k=3, max_tenants=T,
        plan_size=128, exact_sampling=True,
    )
    _assert_tree_equal(ttypes.state_to_numpy(got[0]), jax.device_get(want[0]))
    _assert_tree_equal(got[1], jax.device_get(want[1]), "plans")
    _assert_tree_equal(got[2], jax.device_get(want[2]), "stats")
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))


def test_occupancy_branches_agree_on_wrap_heal():
    """One tenant owning all 2^16 pages in one count bucket: the packed
    occupancy field wraps at exactly 2^16 members and is healed; the
    two-pass form needs no heal. Both reference branches, both port paths."""
    P = 65536
    member_p = np.ones(P, bool)
    member_d = np.zeros(P, bool)
    owner = np.zeros(P, np.int64)
    order, inv, start = jtypes.segments_build_host(np.zeros(P, np.int16), 2)
    jsegs = jtypes.OwnerSegments(order=jnp.asarray(order), inv=jnp.asarray(inv),
                                 start=jnp.asarray(start))
    want = jpolicy._occ_segments(jnp.asarray(member_p), jnp.asarray(member_d),
                                 jnp.asarray(owner, jnp.int32), jsegs)
    tsegs = ttypes.OwnerSegments.from_host(order, inv, start, CPU)
    got = tpolicy._occ_segments(torch.as_tensor(member_p), torch.as_tensor(member_d),
                                torch.as_tensor(owner), tsegs)
    assert int(got[0][-1]) == 1 << 16
    assert np.array_equal(got[0].numpy(), np.asarray(want[0]))
    oh = torch.zeros((2, P), dtype=torch.bool)
    oh[0] = True
    pk = tpolicy._occ_packed(torch.as_tensor(member_p), torch.as_tensor(member_d),
                             torch.as_tensor(owner), oh)
    tp = tpolicy._occ_twopass(torch.as_tensor(member_p), torch.as_tensor(member_d),
                              torch.as_tensor(owner), oh)
    # the wrap carries +1 into the demote field past the last member, where
    # no demote member can sit: only member positions are meaningful
    assert torch.equal(pk[0], tp[0])
    assert np.array_equal(pk[0].numpy(), np.asarray(want[0]))
    jpk = jpolicy._occ_packed(jnp.asarray(member_p), jnp.asarray(member_d),
                              jnp.asarray(owner, jnp.int32), jnp.asarray(oh.numpy()))
    assert np.array_equal(pk[0].numpy(), np.asarray(jpk[0]))
    assert np.array_equal(pk[1].numpy(), np.asarray(jpk[1]))


def test_state_nbytes_reports_reference_layout():
    ref = jtypes.PolicyState.create(4096, 8, seed=0, queue_size=64)
    st = ttypes.PolicyState.create(4096, 8, seed=0, queue_size=64, device=CPU)
    assert ttypes.state_nbytes(st) == jtypes.state_nbytes(ref)


def test_numpy_round_trip_keeps_reference_dtypes():
    ref, _ = random_state(2, 512, 4, 32)
    back = ttypes.state_to_numpy(ttypes.state_from_numpy(ref, CPU))
    for a, b in ((back.pages.count, ref.pages.count), (back.pending, ref.pending),
                 (back.pages.owner, ref.pages.owner), (back.segs.order, ref.segs.order)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


# ------------------------------------------------------------ golden trace
def _golden():
    with open(golden_regen.POLICY_TRACE_PATH) as f:
        return json.load(f)["epochs"]


def _torch_policy_manager():
    m = TorchManager(
        num_pages=golden_regen.POLICY_P, fast_capacity=golden_regen.POLICY_FAST,
        migration_budget=golden_regen.POLICY_BUDGET, max_tenants=golden_regen.POLICY_MAX_T,
        sample_period=100, exact_sampling=True, seed=golden_regen.POLICY_SEED, device="cpu",
    )
    for n_pages, t_miss in golden_regen.POLICY_TENANTS:
        h = m.register(t_miss)
        m.allocate(h, n_pages)
    return m


def _record(stats, plan, e=None):
    def pick(x):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        return x if e is None else x[e]

    return {
        "fmmr_now": pick(stats.fmmr_now).astype(np.float32).astype(float).tolist(),
        "fmmr_ewma": pick(stats.fmmr_ewma).astype(np.float32).astype(float).tolist(),
        "fast_pages": pick(stats.fast_pages).astype(np.int32).tolist(),
        "slow_pages": pick(stats.slow_pages).astype(np.int32).tolist(),
        "promoted": pick(stats.promoted).astype(np.int32).tolist(),
        "demoted": pick(stats.demoted).astype(np.int32).tolist(),
        "cooled": pick(stats.cooled).astype(bool).tolist(),
        "promote_ids": pick(plan.promote).astype(np.int32).tolist(),
        "demote_ids": pick(plan.demote).astype(np.int32).tolist(),
    }


def test_epoch_step_replays_golden_trace():
    golden = _golden()
    m = _torch_policy_manager()
    counts = golden_regen.policy_counts()
    for e, g in enumerate(golden):
        m.record_access(counts[e])
        res = m.run_epoch()
        rec = _record(res.stats, res.plan)
        rec["tier"] = m.tiers().astype(np.int8).tolist()
        for key in g:
            assert rec[key] == g[key], f"epoch {e}: {key} diverged"


def test_multi_epoch_replays_golden_trace():
    golden = _golden()
    m = _torch_policy_manager()
    res = m.run_epochs(golden_regen.POLICY_EPOCHS, counts=golden_regen.policy_counts(),
                       collect_plans=True)
    for e, g in enumerate(golden):
        rec = _record(res.stats, res.plans, e)
        for key in rec:
            assert rec[key] == g[key], f"epoch {e}: {key} diverged"
    assert m.tiers().tolist() == golden[-1]["tier"]


@pytest.mark.parametrize("seed", range(4))
def test_segments_update_matches_rebuild(seed):
    """The incremental owner-segment splice equals a from-scratch build and
    the reference's splice, across random register/free churn."""
    rng = np.random.default_rng(seed)
    P, T = 3000, 12
    owner = np.where(rng.random(P) < 0.7, rng.integers(0, T, P), -1).astype(np.int16)
    host = ttypes.segments_build_host(owner, T)
    for _ in range(5):
        new = owner.copy()
        ids = rng.choice(P, 200, replace=False)
        new[ids] = np.where(rng.random(200) < 0.5, rng.integers(0, T, 200), -1)
        changed = ids[new[ids] != owner[ids]]
        host = ttypes.segments_update_host(*host, owner, new, changed, T)
        want = ttypes.segments_build_host(new, T)
        ref = jtypes.segments_update_host(
            *jtypes.segments_build_host(owner, T), owner, new, changed, T
        )
        for got, w, r in zip(host, want, ref):
            assert np.array_equal(got, w) and np.array_equal(got, r)
        owner = new


@pytest.mark.parametrize("Q", [0, 256])
def test_sampled_epoch_step_matches_reference_with_shared_deviates(Q):
    """Non-exact sampling: the reference's own normal deviates (drawn as its
    epoch_step draws them) passed to the port give the same epoch."""
    P, T = 4096, 8
    ref, fast_cap = random_state(21 + Q, P, T, Q)
    ref = ref._replace(pending=(ref.pending * 40).astype(np.uint32))
    jp, tp = params_pair(fast_cap, 128, queue=Q > 0, guards=False)
    jst = _jax_state(ref)
    _, sub = jax.random.split(jst.rng)
    z = np.array(jax.random.normal(sub, (P,), jnp.float32))
    want = jpolicy.epoch_step(jst, jp, max_tenants=T, plan_size=128)
    got = tpolicy.epoch_step(ttypes.state_from_numpy(ref, CPU), tp, max_tenants=T,
                             plan_size=128, z=torch.as_tensor(z))
    _assert_tree_equal(ttypes.state_to_numpy(got[0]), jax.device_get(want[0]))
    _assert_tree_equal(got[2], jax.device_get(want[2]), "stats")


def test_sampled_multi_epoch_matches_reference_with_shared_deviates():
    """The reference's popcount CLT deviates, rebuilt from its key and
    passed in, make the port's multi-epoch loop replay its scan."""
    P, T, Q, k = 4096, 8, 256, 3
    ref, fast_cap = random_state(31, P, T, Q)
    jp, tp = params_pair(fast_cap, 128, queue=True, guards=True)
    counts = np.random.default_rng(32).integers(0, 4000, (k, P)).astype(np.uint32)
    jst = _jax_state(ref)
    bits = jax.random.bits(jax.random.fold_in(jst.rng, 0x5A), (k, P // 2), jnp.uint32)
    pc = jax.lax.population_count
    z2 = jnp.stack([pc(bits & 0xFFFF), pc(bits >> 16)], axis=-1)
    z = np.array((z2.reshape(k, P).astype(jnp.float32) - 8.0) * 0.5)
    want = jpolicy.multi_epoch(jst, jp, jnp.asarray(counts), k=k, max_tenants=T, plan_size=128)
    got = tpolicy.multi_epoch(
        ttypes.state_from_numpy(ref, CPU), tp, _t(counts, np.int64), k=k, max_tenants=T,
        plan_size=128, z=torch.as_tensor(z),
    )
    _assert_tree_equal(ttypes.state_to_numpy(got[0]), jax.device_get(want[0]))
    _assert_tree_equal(got[2], jax.device_get(want[2]), "stats")


def test_clt_deviates_are_exactly_standardised():
    """(popcount of 16 bits - 8) / 2 over all 2^16 patterns: mean 0, var 1."""
    x = torch.arange(1 << 16, dtype=torch.int64)
    z = (tpolicy.popcount32(x).to(torch.float64) - 8.0) * 0.5
    assert float(z.mean()) == 0.0 and float((z * z).mean()) == 1.0
    gen = torch.Generator().manual_seed(0)
    d = tpolicy.clt_deviates(gen, 2, 1000, CPU)
    assert d.shape == (2, 1000) and d.dtype == torch.float32
    assert set(torch.unique(d).tolist()) <= {v / 2 - 4.0 for v in range(17)}


# -------------------------------------------------------------------- tally
def _tally_contract(idx, size, values):
    """The ``.at[idx].add(values, mode="drop")`` contract entry by entry: a
    negative index wraps once from the end, one still out of range drops."""
    out = np.zeros(size, np.int64)
    vals = np.ones(len(idx), np.int64) if values is None else values
    for k, v in zip(idx.tolist(), vals.tolist()):
        k = k + size if k < 0 else k
        if 0 <= k < size:
            out[k] = np.int64((int(out[k]) + v + 2**63) % 2**64 - 2**63)
    return out


def _tally_case(name):
    rng = np.random.default_rng(len(name))
    size = 33
    idx = rng.integers(0, size, 500)
    values = None
    if name == "negative_wraps_once":
        idx = rng.integers(-size, 0, 500)
    elif name == "out_of_range_dropped":
        idx = np.concatenate([rng.integers(size, 3 * size, 200),
                              rng.integers(-3 * size, -size, 200), idx[:100]])
    elif name == "values":
        values = rng.integers(-(2**40), 2**40, 500)
        values[::3] = 0
        values[1::7] = 2**32 - 1
    elif name == "values_wrap_int64":
        idx = np.zeros(4, np.int64)
        values = np.array([2**62, 2**62, 2**62, 7], np.int64)
    elif name == "one_slot":
        idx = np.full(500, 5)
    elif name == "empty":
        idx = idx[:0]
    elif name == "size_zero":
        size = 0
    return idx.astype(np.int64), size, None if values is None else values.astype(np.int64)


@pytest.mark.parametrize("name", ["ones", "negative_wraps_once", "out_of_range_dropped", "values",
                                  "values_wrap_int64", "one_slot", "empty", "size_zero"])
def test_tally_ref_follows_the_scatter_add_contract(name):
    """``ref.tally_ref`` (the kernel's plain version, which CPU and fake
    tensors take through ``ops.tally``) against the contract."""
    idx, size, values = _tally_case(name)
    want = _tally_contract(idx, size, values)
    v = None if values is None else _t(values)
    got = tref.tally_ref(_t(idx), size, v)
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    assert np.array_equal(tops.tally(_t(idx), size, v, width=max(size // 4, 1)).numpy(), want)


def _spare_slot_scatter(size, idx, values):
    """The tick's scatter before ``tally``: every dropped entry added into
    one spare slot past the end, sliced off."""
    idx = torch.where(idx < 0, idx + size, idx)
    idx = torch.where((idx < 0) | (idx >= size), size, idx)
    out = torch.zeros(size + 1, dtype=values.dtype)
    return out.scatter_add(0, idx, values)[:size]


@pytest.mark.parametrize("seed,Q,huge", [(0, 0, True), (1, 256, True), (2, 256, False)])
def test_tick_tallies_equal_the_spare_slot_scatters(seed, Q, huge, monkeypatch):
    """The tick's three sites on random states (counts >= C and >= 2^31,
    whose int32 keys wrap negative; unowned pages; in-flight pages barred):
    the per-(tenant, tier) sums and cooling hits, which now drop their
    "neither" entries past the table's end, and the candidate histogram,
    read as rows of C counts, equal the scatters with a spare slot."""
    P, T = 4096, 8
    C = tpolicy.COUNT_CLAMP
    ref, fast_cap = random_state(40 + seed, P, T, Q, huge_counts=huge)
    pages, pending = ref.pages, (ref.pending * 40).astype(np.uint32)
    count, last = pages.count.copy(), pages.last_cool.copy()
    count[1::97] = 70_000  # keys clamped to C - 1
    if huge:
        # tenants 0 and 1 sampled nothing, so they do not cool: their pages'
        # int32 keys of counts >= 2^31 stay negative, and their flat indices
        # wrap from the table's end (tenant 0) or shift a row back (tenant 1)
        quiet = pages.owner <= 1
        pending[quiet] = 0
        big = np.flatnonzero(quiet & (pages.owner >= 0))[::23]
        count[big] = 2**32 - 1 - np.arange(len(big), dtype=np.uint32) * 97
        last[big] = ref.tenants.cool_epoch[pages.owner[big]]
    ref = ref._replace(pending=pending, pages=pages._replace(count=count, last_cool=last))
    _, tp = params_pair(fast_cap, 128, queue=Q > 0, guards=False)
    calls = []
    plain = tbins.tally

    def spy(idx, size, values=None, *, width=None):
        out = plain(idx, size, values, width=width)
        calls.append((idx, size, values, width, out))
        return out

    monkeypatch.setattr(tbins, "tally", spy)
    tpolicy.epoch_step(ttypes.state_from_numpy(ref, CPU), tp, max_tenants=T, plan_size=128)
    assert sorted((c[1], c[3]) for c in calls) == [(T, None), (2 * T, None),
                                                    (2 * T * C + 1, C)]
    for idx, size, values, width, out in calls:
        v = torch.ones_like(idx) if values is None else values
        spare = 1 if width is None else 0  # the sites that drop past the end
        assert torch.equal(out, _spare_slot_scatter(size + spare, idx, v)[:size]), size
    flat = next(c[0] for c in calls if c[3] is not None)
    assert bool((flat == 2 * T * C).any())  # unowned and barred pages
    assert bool(((flat >= 0) & (flat < 2 * T * C) & (flat % C == C - 1)).any())
    assert bool((flat < 0).any()) == huge  # int32 keys of counts >= 2^31 wrap negative


def test_vmapped_tick_takes_the_plain_path(monkeypatch):
    """The fleet's tick runs under ``torch.func.vmap``, where the call sites'
    inputs are functorch batched tensors: they keep ``ref.tally_ref`` and
    launch no ``tally`` even where the kernel path is taken (here a counting
    stand-in on the CPU), the fleet's records and states equal each machine
    run alone through that path, and a machine alone launches three a
    epoch."""
    import warnings

    from repro_torch.core.fleet import FleetManager
    from repro_torch.kernels import tally as ktally

    def stand_in(idx, size, values=None, *, width=None):
        ktally.LAUNCHES["tally"] += 1
        return tref.tally_ref(idx, size, values)

    monkeypatch.setattr(tops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(ktally, "tally", stand_in)
    P, E = 2048, 4

    def machine(s):
        m = TorchManager(num_pages=P, fast_capacity=512, migration_budget=64 + 16 * s,
                         max_tenants=8, sample_period=(1, 100, 400)[s], seed=s,
                         queue_size=64, migration_bandwidth=8 + 8 * s, device="cpu")
        for t_miss, n in ((0.1, 700), (0.5, 700), (1.0, 500)):
            m.allocate(m.register(t_miss), n)
        return m

    counts = (np.random.default_rng(9).poisson(4, (3, E, P)) * 9).astype(np.int64)
    fleet = FleetManager([machine(s) for s in range(3)])
    before = ktally.LAUNCHES["tally"]
    with warnings.catch_warnings():
        warnings.filterwarnings("error", message=".*batching rule.*")
        res = fleet.run_epochs(E, counts=counts, collect_plans=True)
    assert ktally.LAUNCHES["tally"] == before
    for s in range(3):
        alone = machine(s)
        want = alone.run_epochs(E, counts=counts[s], collect_plans=True)
        got = res.machine(s)
        for f in ("fmmr_now", "fmmr_ewma", "fast_pages", "promoted", "demoted", "cooled"):
            a, b = getattr(got.stats, f), getattr(want.stats, f)
            assert torch.equal(a, b.to(a.dtype)), (s, f)
        _assert_tree_equal(ttypes.state_to_numpy(fleet.machines[s]._state),
                           ttypes.state_to_numpy(alone._state), f"state[{s}]")
    assert ktally.LAUNCHES["tally"] - before == 3 * 3 * E


def test_tally_takes_the_plain_version_off_the_card():
    """CPU and fake tensors take ``ref.tally_ref`` through ``ops.tally`` and
    launch nothing; a cost counter reads the kernel's bytes (indices and
    values read, the table written, once) either way; the CUDA wrapper
    refuses anything but contiguous 1-D int64 CUDA tensors."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis import hlo_cost
    from repro_torch.kernels import tally as ktally

    before = tops.launch_counts()
    idx = torch.tensor([0, 3, -1, 7, 2, -9])
    assert tops.tally(idx, 4).tolist() == [1, 0, 1, 2]
    assert tops.tally(idx, 4, idx * 10, width=2).tolist() == [0, 0, 20, 20]
    with FakeTensorMode() as mode:
        out = tops.tally(mode.from_tensor(idx), 4, width=2)
    assert out.shape == (4,) and out.dtype == torch.int64
    assert tops.launch_counts() == before
    c = hlo_cost.module_cost(lambda i, v: tops.tally(i, 4, v), idx, idx)
    assert dict(c.kernel_calls) == {"tally": 1} and c.kernel_bytes == 2 * 6 * 8 + 4 * 8
    for bad in (idx, idx.to(torch.int32), idx.reshape(2, 3)):
        with pytest.raises(ValueError, match="CUDA"):
            ktally.tally(bad, 4)
