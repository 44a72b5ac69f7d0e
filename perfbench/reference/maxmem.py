"""A plain PyTorch model of the MaxMem manager in queue mode (paper §3.1-3.2),
written from the policy's rules and not from the program's code.

One ``Machine`` holds the page metadata, the tenants and the migration queue
as tensors on any device and steps them epoch by epoch:

  * sampling: each page's accesses n are subsampled at p = 1/period as
    round(n p + sqrt(n p) z), clamped to [0, n], z a standard normal deviate
    drawn per page per epoch from the caller's generator (one draw of P);
  * hotness: counts halve for a whole tenant when one of its pages reaches
    2^(bins-1), lazily through a per-tenant cooling epoch;
  * FMMR: slow samples over all samples per tenant, an EWMA with lambda;
  * reallocation of fast memory between needers and donors with half the
    migration budget, and intra-tenant swaps of the hottest slow against the
    coldest fast pages with the other half;
  * victims: the hottest slow (coldest fast) candidates of each tenant, ties
    to the lowest page id, found here by one sort;
  * the bounded FIFO queue: guards, demotes drained before promotes, the
    drain bounded by bandwidth and fast room, tier flips on completion.

Float32 quantities are computed with the same roundings the policy defines
(sums over tenants left to right, the sampler's and the EWMA's fused
multiply-add), so the model agrees with a correct program bit for bit.
Imports torch only.
"""
from __future__ import annotations

import torch

MASK = 0xFFFFFFFF
INT32_MAX = 2**31 - 1
NONE, SLOW, FAST = -1, 0, 1
PROMOTE, DEMOTE = 1, -1
CLAMP = 4096  # effective counts at or above this share one bucket
EPS = 9.99999971718069e-10  # float32(1e-9)


def f32(x) -> float:
    return float(torch.tensor(x, dtype=torch.float32))


def fma32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """float32 a * b + c with a single rounding: the exact float64 product,
    the float64 sum and its error (TwoSum); where the float64 sum is a tie
    between two float32 neighbours, the error breaks it."""
    a64 = a.double()
    b64 = b.double() if isinstance(b, torch.Tensor) else f32(b)
    c64 = c.double()
    p = a64 * b64
    s = p + c64
    v = s - p
    err = (p - (s - v)) + (c64 - v)
    r = s.float()
    r64 = r.double()
    inf = torch.full_like(r, float("inf"))
    nb = torch.nextafter(r, torch.where(s > r64, inf, -inf))
    tie = (s == (r64 + nb.double()) * 0.5) & (err != 0)
    return torch.where(tie, torch.where(err > 0, torch.maximum(r, nb), torch.minimum(r, nb)), r)


def lsum(x: torch.Tensor, n: int) -> torch.Tensor:
    """float32 sum over tenants, left to right; the slots from ``n`` on are
    never registered and hold zeros, which change no sum."""
    acc = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n):
        acc = acc + x[i]
    return acc


def heat_bin(c: torch.Tensor, num_bins: int) -> torch.Tensor:
    """Bin 0 for a count of 0, bin k for counts in [2^(k-1), 2^k), the last
    bin for every count above."""
    n = torch.zeros_like(c)
    for k in range(num_bins - 1):
        n = n + (c >= (1 << k)).to(c.dtype)
    return n


def grant_in_order(want: torch.Tensor, key: torch.Tensor, available) -> torch.Tensor:
    """Serve ``want`` in ascending ``key`` (ties by index) from ``available``."""
    order = torch.sort(key, stable=True).indices
    w = want[order]
    before = torch.cumsum(w, 0) - w
    out = torch.zeros_like(want)
    out[order] = torch.minimum(torch.clamp(available - before, min=0), w)
    return out


def compact(mask: torch.Tensor, n: int, values, pad: int) -> torch.Tensor:
    """The entries of ``values`` where ``mask`` holds, in order, in a fresh
    array of length ``n`` padded with ``pad`` (the rest cut off)."""
    out = torch.full((n,), pad, dtype=values.dtype, device=values.device)
    kept = values[mask][:n]
    out[: kept.shape[0]] = kept
    return out


class Machine:
    """The manager's state as the policy defines it, for one machine."""

    def __init__(self, *, pages: int, fast_capacity: int, migration_budget: int,
                 queue_size: int, migration_bandwidth: int, max_tenants: int,
                 sample_period: int, num_bins: int, ewma_lambda: float,
                 hysteresis: float, device):
        P, T, Q = pages, max_tenants, queue_size
        self.P, self.T, self.Q = P, T, Q
        self.F = fast_capacity
        self.budget = migration_budget
        self.bw = migration_bandwidth
        self.period = sample_period
        self.nb = num_bins
        self.lam = ewma_lambda
        self.band = hysteresis
        self.dev = torch.device(device)
        i64 = dict(dtype=torch.int64, device=self.dev)
        self.owner = torch.full((P,), -1, **i64)
        self.tier = torch.full((P,), NONE, **i64)
        self.count = torch.zeros(P, **i64)
        self.last_cool = torch.zeros(P, **i64)
        self.pending = torch.zeros(P, **i64)
        self.active = torch.zeros(T, dtype=torch.bool, device=self.dev)
        self.t_miss = torch.ones(T, dtype=torch.float32, device=self.dev)
        self.a_miss = torch.zeros(T, dtype=torch.float32, device=self.dev)
        self.arrival = torch.full((T,), INT32_MAX, **i64)
        self.cool_epoch = torch.zeros(T, **i64)
        self.flagged = torch.zeros(T, dtype=torch.bool, device=self.dev)
        self.q_page = torch.full((Q,), -1, **i64)
        self.q_dir = torch.zeros(Q, **i64)
        self.q_cmp = torch.zeros(Q, **i64)
        self.q_heat = torch.zeros(Q, **i64)
        self.epoch = 0
        self.enqueued = self.drained = self.cancelled = self.dropped = 0
        self.n_tenants = 0

    # ---------------------------------------------------------- control
    def register(self, t_miss: float) -> int:
        t = self.n_tenants
        self.active[t] = True
        self.t_miss[t] = f32(t_miss)
        self.arrival[t] = t
        self.n_tenants += 1
        return t

    def allocate(self, t: int, n: int) -> torch.Tensor:
        """First touch: the lowest free ids, fast while fast room is left."""
        free = torch.nonzero(self.tier == NONE).flatten()[:n]
        if free.shape[0] < n:
            raise MemoryError("out of pages")
        room = max(self.F - int((self.tier == FAST).sum()), 0)
        self.tier[free] = SLOW
        self.tier[free[:room]] = FAST
        self.owner[free] = t
        return free

    def record(self, counts: torch.Tensor) -> None:
        self.pending = (self.pending + (counts.to(self.dev, torch.int64) & MASK)) & MASK

    # ------------------------------------------------------------ epoch
    def _sample(self, z: torch.Tensor) -> torch.Tensor:
        n = self.pending
        if self.period <= 1:
            return n.clone()
        p = float(torch.tensor(1.0) / torch.tensor(float(self.period)))
        lam = n.float() * p
        draw = torch.round(fma32(torch.sqrt(lam), z.to(self.dev, torch.float32), lam))
        draw = torch.minimum(torch.clamp(draw, min=0.0), n.float())
        return torch.clamp(draw.to(torch.int64), max=MASK)

    def _effective(self, count, last_cool, cool_epoch) -> torch.Tensor:
        own = torch.clamp(self.owner, min=0)
        shift = torch.clamp(cool_epoch[own] - last_cool, 0, 31)
        return torch.where(self.owner >= 0, count >> shift, 0)

    def _per_tenant(self, mask: torch.Tensor, values=None) -> torch.Tensor:
        """i64[T]: per tenant, the pages where ``mask`` holds, or the sum of
        ``values`` over them."""
        v = mask.to(torch.int64) if values is None else torch.where(mask, values, 0)
        out = torch.zeros(self.T, dtype=torch.int64, device=self.dev)
        for t in range(self.n_tenants):
            out[t] = torch.where(self.owner == t, v, 0).sum()
        return out

    def _reallocate(self, fast, free_fast, R: int):
        act, a, t = self.active, self.a_miss, self.t_miss
        Rf = f32(R)
        big = torch.full_like(self.arrival, INT32_MAX)
        need = act & (a > t * f32(1 + f32(self.band)))
        donor = act & (a < t * f32(1 - f32(self.band))) & (fast > 0)
        zero_donor = donor & (a <= EPS)
        ratio_d = torch.where(donor & ~zero_donor, t / torch.clamp(a, min=EPS), 0.0)
        if bool(zero_donor.any()):
            first = int(torch.argmin(torch.where(zero_donor, self.arrival, big)))
            frac = torch.zeros_like(a)
            frac[first] = 1.0
        else:
            surplus = lsum(ratio_d, self.n_tenants)
            frac = (ratio_d / torch.clamp(surplus, min=EPS) if float(surplus) > 0
                    else torch.zeros_like(a))
        take = torch.minimum(torch.floor(frac * Rf).to(torch.int64), fast)
        take = torch.where(act, take, 0)
        ratio_n = torch.where(need, a / torch.clamp(t, min=EPS), 0.0)
        f_need = lsum(ratio_n, self.n_tenants)
        want = (torch.floor(ratio_n / torch.clamp(f_need, min=EPS) * Rf).to(torch.int64)
                if float(f_need) > 0 else torch.zeros_like(take))
        give = grant_in_order(want, torch.where(need, self.arrival, big), free_fast + take.sum())
        give = torch.where(act, give, 0)
        # takes beyond what the gives use are handed back, largest take first
        excess = max(int(take.sum()) - max(int(give.sum()) - free_fast, 0), 0)
        order = torch.sort(-take, stable=True).indices
        ts = take[order]
        cut = torch.minimum(torch.clamp(excess - (torch.cumsum(ts, 0) - ts), min=0), ts)
        take = torch.zeros_like(take)
        take[order] = ts - cut
        if not bool(need.any()):
            # no needer: drift toward equal shares, a trickle a epoch
            share = (int(fast.sum()) + free_fast) // max(int(act.sum()), 1)
            trickle = max(R // 8, 1)
            w_take = torch.where(act & (a < t * f32(0.7)), torch.clamp(fast - share, min=0), 0)
            w_give = torch.where(act, torch.clamp(share - fast, min=0), 0)

            def scaled(w, cap):
                tot = torch.clamp(lsum(w.float(), self.n_tenants), min=1.0)
                return torch.floor(w.float() * (torch.minimum(cap, tot) / tot)).to(torch.int64)

            matched = torch.tensor(float(min(int(w_take.sum()), int(w_give.sum()) + free_fast,
                                             trickle)), dtype=torch.float32, device=self.dev)
            take = scaled(w_take, matched)
            cap = torch.minimum(torch.tensor(float(int(take.sum()) + free_fast),
                                             dtype=torch.float32, device=self.dev),
                                torch.tensor(f32(trickle), device=self.dev))
            give = scaled(w_give, cap)
        flagged = need & (give == 0) & (want > 0)
        return give, take, flagged

    def step(self, z: torch.Tensor) -> dict:
        """One epoch on the recorded accesses; returns what it drained."""
        P, T, dev = self.P, self.T, self.dev
        sampled = self._sample(z)
        owned = self.owner >= 0
        s_fast = self._per_tenant(owned & (self.tier == FAST), sampled) & MASK
        s_slow = self._per_tenant(owned & (self.tier == SLOW), sampled) & MASK

        # hotness counters with lazy cooling
        own = torch.clamp(self.owner, min=0)
        eff = self._effective(self.count, self.last_cool, self.cool_epoch)
        touched = sampled > 0
        new = (eff + sampled) & MASK
        count = torch.where(touched, new, self.count)
        hot = touched & owned & (new >= (1 << (self.nb - 1)))
        cooled = self._per_tenant(hot) > 0
        cool_epoch = self.cool_epoch + cooled.to(torch.int64)
        halve = cooled[own] & touched
        count = torch.where(halve, count >> 1, count)
        last_cool = torch.where(touched, cool_epoch[own], self.last_cool)
        eff = self._effective(count, last_cool, cool_epoch)
        self.count, self.last_cool, self.cool_epoch = count, last_cool, cool_epoch

        # FMMR
        fa, sl = s_fast.float(), s_slow.float()
        tot = fa + sl
        now = torch.where(tot > 0, sl / torch.clamp(tot, min=1.0), 0.0)
        ewma = fma32(now, f32(self.lam), self.a_miss * f32(1 - f32(self.lam)))
        self.a_miss = torch.where(self.active, ewma, 0.0)

        # candidates: owned pages with no queued migration
        busy = torch.zeros(P + 1, dtype=torch.bool, device=dev)
        busy[torch.where(self.q_page >= 0, self.q_page, P)] = True
        busy = busy[:P]
        slow_c = owned & (self.tier == SLOW) & ~busy
        fast_c = owned & (self.tier == FAST) & ~busy
        key = torch.clamp(((eff + 2**31) & MASK) - 2**31, max=CLAMP - 1)
        hist_s = torch.bincount(torch.where(slow_c, own * CLAMP + key, T * CLAMP),
                                minlength=T * CLAMP + 1)[:-1].reshape(T, CLAMP)
        hist_f = torch.bincount(torch.where(fast_c, own * CLAMP + key, T * CLAMP),
                                minlength=T * CLAMP + 1)[:-1].reshape(T, CLAMP)
        le_s = torch.cumsum(hist_s, 1)  # slow candidates with key <= c
        le_f = torch.cumsum(hist_f, 1)
        n_slow_c, n_fast_c = le_s[:, -1], le_f[:, -1]
        fast_hold = self._per_tenant(owned & (self.tier == FAST))

        # reallocation with half the budget
        free_fast = max(self.F - int(fast_hold.sum()), 0)
        R = self.budget // 2
        give, take, self.flagged = self._reallocate(fast_hold, free_fast, R)
        moves = int(give.sum() + take.sum())
        scale = (torch.tensor(f32(R), device=dev) / torch.tensor(float(max(moves, 1)),
                                                                  device=dev)
                 if moves > R else torch.ones((), device=dev))
        take = torch.floor(take.float() * scale).to(torch.int64)
        give = torch.floor(give.float() * scale).to(torch.int64)
        give = grant_in_order(give, torch.where(give > 0, self.arrival, INT32_MAX),
                              free_fast + int(take.sum()))

        # swaps with the other half: the most (slow hotter than c, fast at
        # most c) pairs over every c, after the reallocation's own moves
        share = (self.budget - R) // (2 * max(int(self.active.sum()), 1))
        give = torch.minimum(give, n_slow_c)
        take = torch.minimum(take, n_fast_c)
        hotter = n_slow_c[:, None] - le_s - give[:, None]
        colder = le_f - take[:, None]
        pairs = torch.minimum(hotter, colder).max(1).values
        pairs = torch.where(self.active, torch.clamp(pairs, 0, share), 0)

        # victims by one sort: tenant, then heat (hot first / cold first), then id
        ids = torch.arange(P, device=dev)
        pq, dq = give + pairs, take + pairs
        promote = self._first(slow_c, own, CLAMP - 1 - key, ids, pq)
        demote = self._first(fast_c, own, key, ids, dq)
        S = self.budget
        plan_p = compact(promote, S, ids, -1)
        plan_d = compact(demote, S, ids, -1)
        return self._queue(plan_p, plan_d, eff)

    def _first(self, cand, own, rank_key, ids, quota) -> torch.Tensor:
        """bool[P]: the first ``quota[t]`` candidates of each tenant t in
        (rank_key, id) order."""
        P = self.P
        k = torch.where(cand, own * (CLAMP * P) + rank_key * P + ids, self.T * CLAMP * P + ids)
        order = torch.sort(k).indices
        start = torch.zeros(self.T + 1, dtype=torch.int64, device=self.dev)
        start[1:] = torch.cumsum(self._per_tenant(cand), 0)
        pos = torch.arange(P, device=self.dev)
        o = own[order]
        chosen = cand[order] & (pos - start[o] < quota[o])
        out = torch.zeros(P, dtype=torch.bool, device=self.dev)
        out[order] = chosen
        return out

    def _queue(self, plan_p, plan_d, eff) -> dict:
        P, Q, dev = self.P, self.Q, self.dev
        heat = heat_bin(eff, self.nb)
        occ = self.q_page >= 0
        qp = torch.clamp(self.q_page, min=0)
        owned = self.owner[qp] >= 0
        real = occ & (self.q_dir != 0)
        reheat = real & (self.q_dir == DEMOTE) & (heat[qp] > self.q_heat)
        cancel = real & (~owned | reheat)
        keep = (real & ~cancel) | (occ & (self.q_dir == 0) & owned & (self.epoch < self.q_cmp))
        inq = torch.zeros(P + 1, dtype=torch.bool, device=dev)
        inq[torch.where(keep, self.q_page, P)] = True
        plan_d = torch.where((plan_d >= 0) & inq[torch.clamp(plan_d, min=0)], -1, plan_d)
        plan_p = torch.where((plan_p >= 0) & inq[torch.clamp(plan_p, min=0)], -1, plan_p)
        n_new = int((plan_d >= 0).sum() + (plan_p >= 0).sum())

        def new_rows(ids, direction):
            v = ids >= 0
            return (ids, torch.where(v, direction, 0), torch.full_like(ids, self.epoch),
                    torch.where(v, heat[torch.clamp(ids, min=0)], 0))

        nd, npr = new_rows(plan_d, DEMOTE), new_rows(plan_p, PROMOTE)
        page = torch.cat([torch.where(keep, self.q_page, -1), nd[0], npr[0]])
        dirs = torch.cat([self.q_dir, nd[1], npr[1]])
        cmp = torch.cat([self.q_cmp, nd[2], npr[2]])
        hts = torch.cat([self.q_heat, nd[3], npr[3]])

        live = page >= 0
        ready = live & (self.epoch >= cmp)
        is_d = ready & (dirs == DEMOTE)
        is_p = ready & (dirs == PROMOTE)
        go_d = is_d & (torch.cumsum(is_d.to(torch.int64), 0) <= self.bw)
        n_d = int(go_d.sum())
        room = self.F - (int((self.tier == FAST).sum()) - n_d)
        go_p = is_p & (torch.cumsum(is_p.to(torch.int64), 0) <= min(self.bw - n_d, room))
        n_p = int(go_p.sum())
        self.tier[page[go_d]] = SLOW
        self.tier[page[go_p]] = FAST
        left = live & ~go_d & ~go_p
        self.q_page = compact(left, Q, page, -1)
        self.q_dir = compact(left, Q, dirs, 0)
        self.q_cmp = compact(left, Q, cmp, 0)
        self.q_heat = compact(left, Q, hts, 0)
        self.enqueued += n_new
        self.drained += n_d + n_p
        self.cancelled += int(cancel.sum())
        self.dropped += max(int(left.sum()) - Q, 0)
        self.pending = torch.zeros_like(self.pending)
        self.epoch += 1
        return {"demoted": page[go_d], "promoted": page[go_p]}

    def depth(self) -> int:
        return int(((self.q_page >= 0) & (self.q_dir != 0)).sum())

    def counters(self) -> dict:
        return {"enqueued": self.enqueued, "drained": self.drained,
                "cancelled": self.cancelled, "dropped": self.dropped, "depth": self.depth()}
