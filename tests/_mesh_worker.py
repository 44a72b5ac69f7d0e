"""One rank of a multi-process mesh check, run as its own process by the
mesh tests (``tests/test_torch_mesh*.py``, ``test_torch_dryrun.py``,
``test_torch_training.py``): a process group is process-global, so every
check that makes one runs here, never in the pytest worker.

    python tests/_mesh_worker.py CASE RANK WORLD STORE OUT ARG

``STORE`` is a file for ``torch.distributed.FileStore`` (gloo ranks) or
"-" (no group, or a fake group made by the case). Rank r writes its result
as JSON (or, for ``ref_*`` cases, which run the JAX package on
``XLA_FLAGS``' host devices and make no group, as numpy arrays) to
``OUT.r.json`` / ``OUT.npz``. ``ARG`` is the case's argument (an
architecture, a file of inputs).
"""
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def below_the_workers():
    """``preexec_fn`` of a rank's process: a lower priority (nice 10), so the
    ranks take the CPU the test workers leave idle (the workers' torch
    threads wait on each other when a busy process holds their core)."""
    os.nice(10)


class Ranks:
    """``case`` running as ``world`` processes (or, with ``ref``, one
    process of the JAX package on ``world`` host devices), started at once;
    ``results()`` waits (each process with its own timeout) and returns each
    rank's JSON."""

    def __init__(self, case, world, tmp_path, arg="", *, ref=False, timeout=240, tag=""):
        env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), JAX_PLATFORMS="cpu",
                   OMP_NUM_THREADS="1")
        if ref:
            env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={world}"
        self.out = str(tmp_path / f"{case}{tag}")
        store = f"{self.out}.store"
        self.ranks = [0] if ref else list(range(world))
        self.timeout = timeout
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), case, str(r), str(world), store,
             self.out, arg], env=env, cwd=ROOT, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, preexec_fn=below_the_workers)
            for r in self.ranks]

    def results(self):
        logs = []
        try:
            for p in self.procs:
                logs.append(p.communicate(timeout=self.timeout)[0])
        finally:
            for p in self.procs:
                p.kill()
        for p, log in zip(self.procs, logs):
            assert p.returncode == 0, log[-3000:]
        return [json.load(open(f"{self.out}.{r}.json")) for r in self.ranks]


def run_ranks(case, world, tmp_path, arg="", **kw):
    return Ranks(case, world, tmp_path, arg, **kw).results()


def _gloo(rank, world, store):
    import torch.distributed as dist

    dist.init_process_group("gloo", store=dist.FileStore(store, world), rank=rank,
                            world_size=world)


def _fake(world):
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)


# ----------------------------------------------------------------- meshes
def case_mesh(rank, world, store, arg):
    """The test and production meshes' errors without a process group, then
    the test meshes over a fake group of 16 and the production mesh's error
    on it."""
    from repro_torch.launch import mesh as M

    out = {}
    for kind, mp in (("test", False), ("prod", True)):
        try:
            (M.make_test_mesh if kind == "test" else M.make_production_mesh)(
                multi_pod=mp, device_type="cpu")
        except RuntimeError as e:
            out[f"no_group {kind}_{mp}"] = str(e)
    _fake(16)
    for mp in (False, True):
        m = M.make_test_mesh(multi_pod=mp, device_type="cpu")
        out[str(mp)] = {"names": list(m.mesh_dim_names),
                        "sizes": [m.size(i) for i in range(m.ndim)],
                        "axis_sizes": {n: M.axis_size(m, n) for n in m.mesh_dim_names},
                        "coordinate": list(m.get_coordinate())}
    try:
        M.make_production_mesh(device_type="cpu")
    except RuntimeError as e:
        out["prod_error"] = str(e)
    return out


# ------------------------------------------------------------ placements
SPECS = [(("data", "model"),), ("data", "model"), ("model", "data"), (None, ("data", "model")),
         ("model",), ()]


def case_shards(rank, world, store, arg):
    """On a (2, 2) gloo mesh: each rank's blocks under ``to_placements`` of
    SPECS, and the attention entry points on ``DTensor``s."""
    from repro_torch.launch.mesh import build_mesh

    _gloo(rank, world, store)
    mesh = build_mesh((2, 2), ("data", "model"), device_type="cpu")
    return {**_placements(mesh), "attention": _attention(mesh)}


def _placements(mesh):
    import torch
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.partitioning import to_placements

    x = torch.arange(64, dtype=torch.float32).reshape(8, 8)
    blocks = [distribute_tensor(x, mesh, to_placements(s, mesh)).to_local().tolist()
              for s in SPECS]
    return {"coordinate": list(mesh.get_coordinate()), "blocks": blocks}


def _ref_placements():
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    mesh = jax.make_mesh((2, 2), ("data", "model"))
    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    coord = {d.id: tuple(int(c) for c in np.argwhere(mesh.devices == d)[0])
             for d in mesh.devices.flat}
    out = {}
    for i, s in enumerate(SPECS):
        idx = NamedSharding(mesh, P(*s)).devices_indices_map(x.shape)
        for d, ix in idx.items():
            out[f"{i}:{coord[d.id][0]},{coord[d.id][1]}"] = x[ix].tolist()
    return out


# ------------------------------------------------------------------ int8
def case_int8(rank, world, store, arg):
    """``shardmap_int8_psum`` over "data" of every array in the file ``arg``."""
    _gloo(rank, world, store)
    return _int8(world, arg)


def _int8(world, path):
    import torch
    from torch.distributed.tensor import DTensor

    from repro_torch.launch.mesh import build_mesh
    from repro_torch.training.grad_compression import shardmap_int8_psum

    mesh = build_mesh((world,), ("data",), device_type="cpu")
    reduce = shardmap_int8_psum(mesh, ("data",))
    z = np.load(path)
    out = []
    for k in sorted(z.files):
        y = reduce(torch.tensor(z[k]))
        assert isinstance(y, DTensor)
        out.append(y.full_tensor().tolist())
    return {"full": out}


def _ref_int8(world, path):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.training.grad_compression import shardmap_int8_psum

    mesh = jax.make_mesh((world,), ("data",), axis_types=(AxisType.Auto,),
                         devices=jax.devices()[:world])
    reduce = shardmap_int8_psum(mesh, ("data",))
    z = np.load(path)
    return {"full": [np.asarray(reduce(jnp.asarray(z[k]))).tolist() for k in sorted(z.files)]}


# ------------------------------------------------------------------- MoE
MOE_ARCHS = ("qwen2-moe-a2.7b", "moonshot-v1-16b-a3b")


def case_ref(rank, world, store, arg):
    """The JAX package on ``world`` host devices (no process group): the
    blocks of SPECS on a (2, 2) mesh, the int8 all-reduce of ``arg``/x1.npz
    on one device and of x2.npz on two, and ``_ref_moe`` at 1 and 2."""
    out = {"placements": _ref_placements()}
    out["int8"] = {w: _ref_int8(w, os.path.join(arg, f"x{w}.npz"))["full"] for w in (1, 2)}
    for w in (1, 2):
        _ref_moe(w, os.path.join(arg, f"moe{w}"))
    return out


def _ref_moe(world, path):
    """The reference's moe_mlp_shardmap on a (1, world) Auto-axis mesh under
    jit, for each MoE smoke config: weights, input, output, aux and gate ids
    to ``path``/<arch>.npz."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType

    from repro.configs import get_config
    from repro.launch.shardings import rules_for
    from repro.models.moe import init_moe, moe_mlp_shardmap

    os.makedirs(path, exist_ok=True)
    mesh = jax.make_mesh((1, world), ("data", "model"), axis_types=(AxisType.Auto,) * 2,
                         devices=jax.devices()[:world])
    for arch in MOE_ARCHS:
        cfg = get_config(arch).smoke()
        p = init_moe(jax.random.PRNGKey(3), cfg)
        x = jnp.asarray(np.random.default_rng(4).normal(size=(2, 24, cfg.d_model)), jnp.float32)
        rules = rules_for(cfg, mesh)
        out, aux = jax.jit(lambda p, x: moe_mlp_shardmap(p, x, cfg, mesh, rules))(p, x)
        flat = {"/".join(str(k.key) for k in kp): np.asarray(v)
                for kp, v in jax.tree_util.tree_leaves_with_path(p)}
        probs = jax.nn.softmax(x.reshape(-1, cfg.d_model) @ p["router"], axis=-1)
        gate_ids = jax.lax.top_k(probs, cfg.moe_top_k)[1]
        np.savez(os.path.join(path, f"{arch}.npz"), x=np.asarray(x), out=np.asarray(out),
                 aux=np.asarray(aux), gate_ids=np.asarray(gate_ids),
                 **{f"p:{k}": v for k, v in flat.items()})


def case_small(rank, world, store, arg):
    """On a gloo group of ``world`` (1 or 2): the int8 all-reduce of
    ``arg``/x<world>.npz and ``_moe`` from ``arg``/moe<world>."""
    _gloo(rank, world, store)
    return {"int8": _int8(world, os.path.join(arg, f"x{world}.npz"))["full"],
            "moe": _moe(world, os.path.join(arg, f"moe{world}"))}


def _moe(world, path):
    """The port's moe_mlp (dispatching to moe_mlp_shardmap under a context)
    on ``DTensor``s and moe_mlp_shardmap on plain tensors, on a (1, world)
    gloo mesh, from the reference's weights and input in ``path``/<arch>.npz."""
    import torch

    from repro_torch.launch import partitioning as part
    from repro_torch.launch.mesh import build_mesh
    from repro_torch.launch.shardings import rules_for
    from repro_torch.models import moe
    from repro_torch.models.convert import tensor_from_numpy

    mesh = build_mesh((1, world), ("data", "model"), device_type="cpu")
    res = {}
    for arch in MOE_ARCHS:
        cfg = get_config_smoke(arch)
        rules = rules_for(cfg, mesh)
        z = np.load(os.path.join(path, f"{arch}.npz"))
        params = {}
        for k in z.files:
            if k.startswith("p:"):
                *head, leaf = k[2:].split("/")
                d = params
                for h in head:
                    d = d.setdefault(h, {})
                d[leaf] = tensor_from_numpy(z[k], torch.float32, "cpu")
        x = tensor_from_numpy(z["x"], torch.float32, "cpu")
        tree = part.distribute(params, _named(params, mesh, rules))
        xd = part.distribute(x, part.NamedSharding(mesh, part.P("data", None, None)))
        with part.use_partitioning(mesh, rules):
            out, aux = moe.moe_mlp(tree, xd, cfg)  # dispatches to moe_mlp_shardmap
            plain_out, plain_aux = moe.moe_mlp_shardmap(params, x, cfg, mesh, rules)
        r = moe.route(params["router"], x.reshape(-1, cfg.d_model), cfg, 8)
        res[arch] = {"out": out.full_tensor().tolist(), "aux": float(aux.full_tensor()),
                     "plain_out": plain_out.tolist(), "plain_aux": float(plain_aux),
                     "gate_ids": r.gate_ids.tolist()}
    return res


def _named(params, mesh, rules, prefix="moe/"):
    """The MoE subtree's shardings by the parameter rules (its paths under
    a layer's ``moe``)."""
    from repro_torch.launch import partitioning as part

    return {k: (_named(v, mesh, rules, f"{prefix}{k}/") if isinstance(v, dict) else
                part.NamedSharding(mesh, part.spec_for(prefix + k, v.shape, rules)))
            for k, v in params.items()}


# ------------------------------------------------------ sharded step, prefill
def case_steps(rank, world, store, arg):
    """``_step`` of each variant in ``arg`` (comma-separated) on one (2, 2)
    gloo mesh."""
    from repro_torch.launch.mesh import build_mesh

    _gloo(rank, world, store)
    mesh = build_mesh((2, 2), ("data", "model"), device_type="cpu")
    return {v: _step_variant(v, mesh) for v in arg.split(",")}


def _step_variant(arg, mesh):
    """The sharded train step and prefill on ``mesh`` against the mesh-less
    port, same seed, same batch (float32 smoke config). ``arg`` is the
    architecture; for an MoE one, "arch:pjit" runs ``moe_mlp`` on
    ``DTensor``s at the config's capacity, and "arch" runs
    ``moe_mlp_shardmap``, which differs from the mesh-less block by design
    in two ways, both taken out here: its capacity is per rank (so it is
    set where no token drops) and its aux loss is the mean of each data
    shard's (so its weight is 0; ``test_moe_shardmap_matches_reference``
    holds it against the reference's)."""
    import dataclasses

    from repro_torch.models import tuning

    arch, _, variant = arg.partition(":")
    cfg = get_config_smoke(arch)
    flags = {}
    if cfg.is_moe and variant == "pjit":
        flags = {"moe_shardmap": False}
    elif cfg.is_moe:
        flags = {"capacity_factor": cfg.num_experts / cfg.moe_top_k}
        cfg = dataclasses.replace(cfg, router_aux_weight=0.0)
    with tuning.tuned(**flags):
        return _step(cfg, mesh)


def get_config_smoke(arch):
    from repro_torch.configs import get_config

    return get_config(arch).smoke()


def _step(cfg, mesh):
    import torch

    from repro_torch.kernels import ref
    from repro_torch.launch import partitioning as part
    from repro_torch.launch.shardings import rules_for, train_state_sharding
    from repro_torch.models.model import get_model
    from repro_torch.training.optimizer import AdamWConfig, named_leaves
    from repro_torch.training.train_state import init_train_state, make_train_step

    rules = rules_for(cfg, mesh)
    opt = AdamWConfig(lr=1e-3, warmup_steps=2)
    g = np.random.default_rng(5)
    toks = torch.tensor(g.integers(0, cfg.vocab_size, (4, 32)), dtype=torch.int32)
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}

    plain = init_train_state(cfg, 0, device="cpu")
    step = make_train_step(cfg, opt)
    sharded = part.distribute(init_train_state(cfg, 0, device="cpu"),
                              train_state_sharding(plain, mesh, rules))
    losses = []
    for _ in range(2):
        plain, m_plain = step(plain, batch)
        with part.use_partitioning(mesh, rules):
            sharded, m_mesh = step(sharded, batch)
        losses.append((float(m_plain["loss"]), float(m_mesh["loss"].full_tensor())))
    pdiff = max(float((a.full_tensor() - b).abs().max()) for (_, a), (_, b) in
                zip(named_leaves(sharded.params), named_leaves(plain.params)))

    api = get_model(cfg)
    lg_plain, cache_plain = api.prefill(plain.params, toks, 40)
    calls, plain_flash = [], ref.flash_attention_ref

    def spy(q, k, v, **kw):  # the kernel's plain version, on local shards
        calls.append([type(q).__name__, *q.shape])
        return plain_flash(q, k, v, **kw)

    ref.flash_attention_ref = spy
    with part.use_partitioning(mesh, rules):
        lg_mesh, cache_mesh = api.prefill(sharded.params, toks, 40)
        lg_dec, _ = api.decode(sharded.params, toks[:, 0], cache_mesh)
    ref.flash_attention_ref = plain_flash
    lg_dec_plain, _ = api.decode(plain.params, toks[:, 0], cache_plain)
    full = lg_mesh.full_tensor()
    return {"losses": losses, "param_diff": pdiff,
            "logits_diff": float((full - lg_plain).abs().max()),
            "logits_scale": float(lg_plain.abs().max()),
            "decode_diff": float((lg_dec.full_tensor() - lg_dec_plain).abs().max()),
            "logits_placements": [str(p) for p in lg_mesh.placements],
            "flash": cfg.family != "ssm", "flash_calls": calls}


def case_units(rank, world, store, arg):
    """``_unit`` of each architecture in ``arg`` (comma-separated) on one
    (1, 1) mesh of one gloo rank (the card's phase 25 on the CPU)."""
    from repro_torch.launch.mesh import build_mesh

    _gloo(rank, world, store)
    mesh = build_mesh((1, 1), ("data", "model"), device_type="cpu")
    return {a: _unit(a, mesh) for a in arg.split(",")}


def _unit(arch, mesh):
    """The prefill (logits and cache), two train steps (losses and every
    parameter) and the MoE block through ``moe_mlp_shardmap`` on the unit
    ``mesh`` against the mesh-less port, bit for bit."""
    import torch

    from repro_torch.launch import partitioning as part
    from repro_torch.launch.shardings import params_sharding, rules_for, train_state_sharding
    from repro_torch.models.model import get_model
    from repro_torch.training.optimizer import AdamWConfig, named_leaves
    from repro_torch.training.train_state import init_train_state, make_train_step

    cfg = get_config_smoke(arch)
    rules = rules_for(cfg, mesh)
    api = get_model(cfg)
    toks = torch.tensor(np.random.default_rng(6).integers(0, cfg.vocab_size, (2, 24)),
                        dtype=torch.int32)
    params = api.init(0, device="cpu")
    lg0, c0 = api.prefill(params, toks, 32)
    pd = part.distribute(params, params_sharding(params, mesh, rules))
    with part.use_partitioning(mesh, rules):
        lg1, c1 = api.prefill(pd, toks, 32)

    def same(a, b):
        a = a.full_tensor() if hasattr(a, "full_tensor") else a
        return bool(torch.equal(a, b))

    out = {"logits": same(lg1, lg0)}
    if hasattr(c0, "k"):
        out["cache"] = same(c1.k, c0.k) and same(c1.v, c0.v)
    torch.use_deterministic_algorithms(True)  # the embedding's backward, as phase 25c
    step = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=1))
    batch = {"tokens": toks, "labels": torch.roll(toks, -1, 1)}
    plain = init_train_state(cfg, 0, device="cpu")
    meshed = part.distribute(init_train_state(cfg, 0, device="cpu"),
                             train_state_sharding(plain, mesh, rules))
    losses = []
    for _ in range(2):
        plain, m0 = step(plain, batch)
        with part.use_partitioning(mesh, rules):
            meshed, m1 = step(meshed, batch)
        losses.append(same(m1["loss"], m0["loss"]))
    out["losses"] = all(losses)
    out["params"] = all(same(a, b) for (_, a), (_, b) in zip(named_leaves(meshed.params),
                                                            named_leaves(plain.params)))
    torch.use_deterministic_algorithms(False)
    return out


# -------------------------------------------------------------- attention
ATTN_LAYOUTS = {  # name: (q placements, kv placements) on the (data, model) mesh
    "lanes_heads": (("S0", "S1"), ("S0", "S1")),  # kv heads split as q's
    "heads_in_one_group": (("R", "S1"), ("R", "R")),  # 4 q heads / 2 ranks, 1 kv head
    "groups_per_rank": (("S0", "S1"), ("S0", "R")),  # 8 q heads over 2 kv heads
    "sequence": (("R", "S2"), ("R", "S2")),  # gathered first
}


def _pl(names):
    from torch.distributed.tensor import Replicate, Shard

    return [Replicate() if n == "R" else Shard(int(n[1])) for n in names]


def _attention(mesh):
    """``flash_attention`` and ``paged_attention`` on ``DTensor``s of the (2,
    2) mesh, each layout of ATTN_LAYOUTS, against the entry points on the
    whole tensors: whether the result is a ``DTensor``, the max abs
    difference, the output's placements."""
    import torch
    from torch.distributed.tensor import DTensor, distribute_tensor

    from repro_torch.kernels import ops

    g = torch.Generator().manual_seed(7)
    out = {}
    for name, (qp, kp) in ATTN_LAYOUTS.items():
        nh, nkv = {"heads_in_one_group": (4, 1), "groups_per_rank": (8, 2)}.get(name, (4, 2))
        q = torch.randn(4, nh, 16, 8, generator=g)
        k, v = (torch.randn(4, nkv, 16, 8, generator=g) for _ in range(2))
        want = ops.flash_attention(q, k, v, causal=True)
        got = ops.flash_attention(distribute_tensor(q, mesh, _pl(qp)),
                                  *(distribute_tensor(t, mesh, _pl(kp)) for t in (k, v)),
                                  causal=True)
        out[f"flash {name}"] = [isinstance(got, DTensor),
                                float((got.full_tensor() - want).abs().max()),
                                [str(p) for p in got.placements]]
        # paged: q [B, nh, dh] and pools [P, page, nkv, dh] with tables per lane
        qd = torch.randn(4, nh, 8, generator=g)
        kpg, vpg = (torch.randn(12, 4, nkv, 8, generator=g) for _ in range(2))
        tables = torch.tensor([[0, 1, 2], [3, 4, -1], [5, 6, 7], [8, -1, -1]], dtype=torch.int32)
        lens = torch.tensor([10, 7, 12, 3], dtype=torch.int32)
        want = ops.paged_attention(qd, kpg, vpg, tables, lens)
        pool_pl = ["R" if p == "S0" else ("S2" if p == "S1" else p) for p in kp]
        q_pl = [p if p in ("R", "S0", "S1") else "R" for p in qp]
        got = ops.paged_attention(distribute_tensor(qd, mesh, _pl(q_pl)),
                                  *(distribute_tensor(t, mesh, _pl(pool_pl)) for t in (kpg, vpg)),
                                  distribute_tensor(tables, mesh, _pl(("R", "R"))),
                                  lens)
        out[f"paged {name}"] = [isinstance(got, DTensor),
                                float((got.full_tensor() - want).abs().max()),
                                [str(p) for p in got.placements]]
    return out


# --------------------------------------------------------------- dry-run
def case_counts(rank, world, store, arg):
    """``_ratio`` of ``arg`` (arch:shape), then ``_count_local``, each on a
    fake group of its own."""
    out = _ratio(arg)
    import torch.distributed as dist

    dist.destroy_process_group()
    return {"ratio": out, "local": _count_local()}


def _count_local():
    """``module_cost`` of a row-parallel product on a (2, 2) fake mesh, real
    and fake tensors, first and second call: the local program (a [32, 64]
    x [64, 128] product and one all-reduce), never the global-shape product
    of ``DTensor``'s sharding propagation."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.analysis.hlo_cost import module_cost
    from repro_torch.launch.mesh import build_mesh

    _fake(4)
    mesh = build_mesh((2, 2), ("data", "model"), device_type="cpu")

    def f(a, b):
        return (a @ b).redistribute(mesh, [Shard(0), Replicate()])

    out = []
    for fake in (False, True):
        with FakeTensorMode() if fake else torch.no_grad():
            a = distribute_tensor(torch.randn(64, 128), mesh, [Shard(0), Replicate()])
            b = distribute_tensor(torch.randn(128, 128), mesh, [Replicate(), Shard(0)])
            for _ in range(2):
                c = module_cost(f, a, b)
                out.append([c.flops, dict(c.coll_bytes)])
    return out


def _ratio(arg):
    """FLOPs of the test-mesh dry-run cell of ``arg`` (arch:shape) cut to 2
    layers, per device, and of the same step unsharded at the same global
    batch, both counted on fake tensors."""
    import dataclasses

    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.analysis.hlo_cost import module_cost
    from repro_torch.configs import get_config, get_shape
    from repro_torch.launch import dryrun, partitioning as part
    from repro_torch.launch.mesh import build_mesh, mesh_shape
    from repro_torch.launch.shardings import rules_for
    from repro_torch.training.optimizer import AdamWConfig
    from repro_torch.training.train_state import init_train_state, make_train_step

    arch, shape_name = arg.split(":")
    cfg = dataclasses.replace(get_config(arch), num_layers=2)
    shape = get_shape(shape_name)
    dims, names = mesh_shape("test")
    _fake(16)
    mesh = build_mesh(dims, names, device_type="cpu")
    rules = rules_for(cfg, mesh, shape)
    with FakeTensorMode():
        with part.use_partitioning(mesh, rules):
            fn, args = dryrun.build_cell(cfg, shape, mesh, rules, device="cpu")
            sharded = module_cost(fn, *args)
        state = init_train_state(cfg, 0, device="cpu")
        batch = dryrun._inputs(cfg, shape, "cpu")
        whole = module_cost(make_train_step(cfg, AdamWConfig(total_steps=10_000)), state, batch)
    return {"per_device": sharded.flops, "whole": whole.flops, "n": 16,
            "collectives": dict(sharded.coll_bytes)}


CASES = {n[5:]: f for n, f in globals().items() if n.startswith("case_")}


if __name__ == "__main__":
    case, rank, world, store, out = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), \
        sys.argv[4], sys.argv[5]
    arg = sys.argv[6] if len(sys.argv) > 6 else ""
    res = CASES[case](rank, world, store, arg)
    with open(f"{out}.{rank}.json", "w") as f:
        json.dump(res, f)
    try:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()
    except ImportError:
        pass
