"""Logical-axis partitioning, the reference's ``launch/partitioning.py`` on
``DeviceMesh`` / ``DTensor``.

Model code annotates activations with *logical* axis names through
``shard(x, "batch", "seq", None)``. The launch layer installs a (mesh,
rules) context with :func:`use_partitioning`; outside a context, or on a
plain tensor, ``shard`` is the identity, so the same model code runs on one
device and on a mesh. On a ``DTensor`` it is an explicit ``redistribute`` to
the spec's placements (the reference's ``with_sharding_constraint``).

Rules map logical names to mesh axis name(s) (or None = replicated). A
:class:`PartitionSpec` holds one entry per *tensor* dimension, as JAX's
does; :func:`to_placements` turns it into ``DTensor`` placements, one per
*mesh* dimension. Parameter specs come from the same rules through
:func:`param_specs`, by regular expressions over each leaf's ``/``-joined
path (the port's parameter trees share the reference's paths).

Inside a context, ``DTensor``'s implicit replication is on: a plain tensor
the model makes (positions, zeros, masks) counts as replicated on the mesh
when it meets a ``DTensor``.

The context is the process's, not the thread's (the reference's is
thread-local): on the card the autograd engine runs a backward, and remat's
recompute in it, on a thread of its own, which must see the context too.
``DTensor``'s implicit replication is a thread's flag, so entering a
context on a CUDA mesh also sets it on that thread (once, through a
backward of one element); it stays set there, where it changes nothing for
a program without ``DTensor``s.
"""
from __future__ import annotations

import re
from contextlib import contextmanager
from typing import Any, Dict, NamedTuple, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard, distribute_tensor

AxisNames = Union[None, str, Tuple[str, ...]]

_CONTEXTS: list = []  # the process's (mesh, rules) contexts, innermost last
_BACKWARD_FLAGGED: set = set()  # devices whose autograd thread replicates implicitly


class PartitionSpec(tuple):
    """One entry per tensor dimension: None, a mesh axis name, or a tuple of
    names (the dimension split over several axes, the first major). Equal,
    as a tuple, to the reference's ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


class NamedSharding(NamedTuple):
    """A spec on a mesh (the reference's ``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self):
        return to_placements(self.spec, self.mesh)


def current() -> Optional[Tuple[Any, Dict[str, AxisNames]]]:
    """The innermost (mesh, rules) context, or None."""
    return _CONTEXTS[-1] if _CONTEXTS else None


class _ReplicateInBackward(torch.autograd.Function):
    """Identity whose backward sets ``DTensor``'s implicit replication on
    the thread that runs it."""

    @staticmethod
    def forward(ctx, x):
        return x.clone()

    @staticmethod
    def backward(ctx, g):
        torch._C._set_dtensor_allow_implicit_replication(True)
        return g


def _replicate_implicitly_in_backward(device_type: str) -> None:
    """Implicit replication on the autograd engine's thread of the current
    ``device_type`` device (a CPU backward runs on the calling thread)."""
    if device_type == "cpu":
        return
    dev = torch.device(device_type, torch.cuda.current_device())
    if dev in _BACKWARD_FLAGGED:
        return
    x = torch.zeros((), device=dev, requires_grad=True)
    _ReplicateInBackward.apply(x).backward()
    _BACKWARD_FLAGGED.add(dev)


@contextmanager
def use_partitioning(mesh, rules: Dict[str, AxisNames]):
    from torch.distributed.tensor.experimental import implicit_replication

    _replicate_implicitly_in_backward(mesh.device_type)
    _CONTEXTS.append((mesh, rules))
    try:
        with implicit_replication():
            yield
    finally:
        _CONTEXTS.pop()


def logical_spec(names: Sequence[Optional[str]], rules: Dict[str, AxisNames]) -> PartitionSpec:
    """Translate logical dim names -> PartitionSpec, dropping duplicate axes."""
    used: set = set()
    out = []
    for n in names:
        ax = rules.get(n) if n else None
        if ax is None:
            out.append(None)
            continue
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        axes = tuple(a for a in axes if a not in used)
        used.update(axes)
        if not axes:
            out.append(None)
        elif len(axes) == 1:
            out.append(axes[0])
        else:
            out.append(axes)
    return PartitionSpec(*out)


def to_placements(spec: Sequence[AxisNames], mesh) -> tuple:
    """``DTensor`` placements of ``spec`` on ``mesh``: for each mesh
    dimension, ``Shard(d)`` where tensor dimension d names its axis, else
    ``Replicate()``. A tensor dimension over several axes is ``Shard(d)`` on
    each; ``DTensor`` splits it over the mesh dimensions in mesh order, the
    first major, which is JAX's order when the spec lists the axes in mesh
    order (any other order raises)."""
    names = mesh.mesh_dim_names
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry} lists mesh axes out of mesh order {names}")
        for m in dims:
            out[m] = Shard(d)
    return tuple(out)


def shard(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """Apply a logical sharding (the identity without a context or on a
    plain tensor)."""
    ctx = current()
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    return x.redistribute(mesh, to_placements(logical_spec(names, rules), mesh))


def gather_fsdp(tree):
    """A parameter (or a dict tree of them) with its sharding over the data
    axes gathered (FSDP's all-gather before use): each ``DTensor`` keeps only
    its "model" placements. The identity without a context or on plain
    tensors. Its backward is the reduce-scatter of the gradients."""
    if isinstance(tree, dict):
        return {k: gather_fsdp(v) for k, v in tree.items()}
    if current() is None or not isinstance(tree, DTensor):
        return tree
    names = tree.device_mesh.mesh_dim_names
    pl = tuple(p if names[i] == "model" else Replicate() for i, p in enumerate(tree.placements))
    return tree if pl == tuple(tree.placements) else tree.redistribute(tree.device_mesh, pl)


def attention_on_shards(call, q, kv, lanes, *, q_heads: int, kv_heads: int, kv_batch):
    """``call(q, *kv, *lanes)`` on each rank's local shards of ``DTensor``
    inputs (a plain one counts as replicated), the result wrapped back with
    q's placements and shape: attention whose math is independent across
    lanes and heads runs where the blocks lie.

    q has its lanes on dim 0 and its heads on ``q_heads``; each of ``kv``
    its heads on ``kv_heads`` and its lanes on ``kv_batch`` (None: no lane
    dimension, as a page pool); each of ``lanes`` its lanes on dim 0. On
    each mesh dimension q keeps a lane or head sharding (anything else, a
    sharded sequence or a partial sum, is replicated); the other inputs
    follow it: sharded on their lanes with q's lanes (a pool replicated), on
    their heads with q's heads when the kv heads split as evenly, else
    replicated, and then each rank keeps the kv heads its q heads read (a
    whole GQA group per rank, or a rank inside one group; a rank that
    straddles groups unevenly gathers q's heads instead). Every change of
    placement is an explicit ``redistribute``. Under autograd the kv
    gradients of a replicated kv read by head-sharded q are partial sums."""
    mesh = next(t.device_mesh for t in (q, *kv, *lanes) if isinstance(t, DTensor))

    def as_dt(t):
        if isinstance(t, DTensor):
            return t
        return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)

    q, kv, lanes = as_dt(q), [as_dt(t) for t in kv], [as_dt(t) for t in lanes]
    nh, nkv = q.shape[q_heads], kv[0].shape[kv_heads]
    qp, kvp, kvg, lp = [], [], [], []
    for i, p in enumerate(q.placements):
        n = mesh.size(i)
        if p == Shard(0):
            qp.append(p)
            kvp.append(Replicate() if kv_batch is None else Shard(kv_batch))
            kvg.append(kvp[-1])
            lp.append(Shard(0))
        elif p == Shard(q_heads):
            qp.append(p)
            even = nh % n == 0 and nkv % n == 0 and kv[0].placements[i] == Shard(kv_heads)
            kvp.append(Shard(kv_heads) if even else Replicate())
            kvg.append(kvp[-1] if even else Partial())
            lp.append(Replicate())
        else:
            qp.append(Replicate())
            kvp.append(Replicate())
            kvg.append(Replicate())
            lp.append(Replicate())
    # the kv heads this rank's q heads read
    q_lo, nh_l = _local_range(nh, q_heads, qp, mesh)
    kv_lo, nkv_l = _local_range(nkv, kv_heads, kvp, mesh)
    g = nh // nkv
    lo, hi = q_lo // g, (q_lo + nh_l - 1) // g + 1
    narrow = (lo, hi) != (kv_lo, kv_lo + nkv_l)
    if narrow and not ((q_lo % g == 0 and nh_l % g == 0) or hi - lo == 1):
        qp = [Replicate() if p == Shard(q_heads) else p for p in qp]
        return attention_on_shards(call, q.redistribute(mesh, qp), kv, lanes,
                                   q_heads=q_heads, kv_heads=kv_heads, kv_batch=kv_batch)
    ql = q.redistribute(mesh, qp).to_local()
    kvl = [t.redistribute(mesh, kvp).to_local(grad_placements=kvg) for t in kv]
    ll = [t.redistribute(mesh, lp).to_local() for t in lanes]
    if narrow:
        kvl = [t.narrow(kv_heads, lo - kv_lo, hi - lo) for t in kvl]
    out = call(ql, *kvl, *ll).contiguous()
    stride = [1] * q.dim()
    for d in range(q.dim() - 2, -1, -1):
        stride[d] = stride[d + 1] * q.shape[d + 1]
    return DTensor.from_local(out, mesh, qp, run_check=False, shape=q.shape,
                              stride=tuple(stride))


def take_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (an embedding lookup). On ``DTensor``s it runs on each
    rank: the table gathered whole, the ids' lane sharding (dim 0) kept,
    the rows taken locally; the table's gradient is a partial sum over the
    mesh dimensions that split the ids and whole on the others (their ranks
    look up the same ids)."""
    if not isinstance(table, DTensor) and not isinstance(ids, DTensor):
        return table[ids]
    mesh = (table if isinstance(table, DTensor) else ids).device_mesh
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim, run_check=False)
    if not isinstance(table, DTensor):
        table = DTensor.from_local(table, mesh, [Replicate()] * mesh.ndim, run_check=False)
    ip = [p if p == Shard(0) else Replicate() for p in ids.placements]
    grads = [Partial() if p == Shard(0) else Replicate() for p in ip]
    tl = table.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(grad_placements=grads)
    out = tl[ids.redistribute(mesh, ip).to_local()]
    shape = (*ids.shape, *table.shape[1:])
    stride = [1] * len(shape)
    for d in range(len(shape) - 2, -1, -1):
        stride[d] = stride[d + 1] * shape[d + 1]
    return DTensor.from_local(out, mesh, ip, run_check=False, shape=shape, stride=tuple(stride))


def _local_range(size: int, dim: int, placements, mesh) -> Tuple[int, int]:
    """(first index, length) of this rank's block of dimension ``dim`` (of
    ``size``) under ``placements``: ``DTensor``'s chunks, ceil(n / k) each,
    split over the mesh dimensions in order."""
    lo, n = 0, size
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if p == Shard(dim):
            cs = -(-n // mesh.size(i))
            a = min(coord[i] * cs, n)
            lo, n = lo + a, min(a + cs, n) - a
    return lo, n


def local_view(x: torch.Tensor, mesh, placements) -> torch.Tensor:
    """This rank's block of ``x`` laid out as ``placements`` (a shard_map
    input): a ``DTensor`` is redistributed first; a plain tensor counts as
    replicated and is sliced with no communication. Under autograd, as in
    shard_map, the gradient of a block replicated over a mesh dimension is
    the sum of the ranks' gradients there (a partial sum), so a term that
    every rank of that dimension computes alike must be contributed by one
    of them only."""
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    grads = [Partial() if isinstance(p, Replicate) else p for p in placements]
    return x.redistribute(mesh, tuple(placements)).to_local(grad_placements=grads)


def distribute(tree, shardings):
    """Every tensor of ``tree`` distributed by the matching ``NamedSharding``
    of ``shardings`` (a tree of the same structure; NamedTuples, dicts, and
    ints or None left as they are). Each rank must hold the same global
    tensor."""
    if isinstance(tree, torch.Tensor):
        return distribute_tensor(tree, shardings.mesh, shardings.placements)
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(distribute(v, s) for v, s in zip(tree, shardings)))
    return tree


# --------------------------------------------------------------------------
# Default logical rules
# --------------------------------------------------------------------------
def default_rules(multi_pod: bool = False) -> Dict[str, AxisNames]:
    dp: AxisNames = ("pod", "data") if multi_pod else ("data",)
    return {
        "batch": dp,
        "fsdp": dp,
        "seq": None,
        "d_model": None,
        "heads": ("model",),
        "kv_heads": ("model",),
        "kv_seq": None,
        "d_ff": ("model",),
        "vocab": ("model",),
        "experts": ("model",),
        "experts_buf": ("model",),  # MoE dispatch buffer expert dim
        "expert_cap": None,  # MoE dispatch buffer capacity dim
        "a2a_cap": ("data",),  # explicit-a2a staging: C over data
        "seq_sp": ("model",),  # sequence-parallel residual stream
        "ssm_heads": ("model",),
        "ssm_state": None,
        "enc_seq": None,
    }


# --------------------------------------------------------------------------
# Param spec derivation (path heuristics)
# --------------------------------------------------------------------------
# Each entry: (regex on '/'.joined path, logical names per trailing dims).
# Leading stacked-layer dims are detected by ndim mismatch and get None.
# First match wins.
_PARAM_RULES: Tuple[Tuple[str, Tuple[Optional[str], ...]], ...] = (
    (r"embed$", ("vocab", "fsdp_embed")),
    (r"lm_head$", ("fsdp_embed", "vocab")),
    (r"pos_embed$", (None, None)),
    (r"attn/w_q$", ("fsdp", "heads")),
    (r"attn/w_k$", ("fsdp", "kv_heads")),
    (r"attn/w_v$", ("fsdp", "kv_heads")),
    (r"attn/w_o$", ("heads", "fsdp")),
    (r"attn/b_q$", ("heads",)),
    (r"attn/b_[kv]$", ("kv_heads",)),
    (r"attn/[qk]_norm$", (None,)),
    (r"(mlp|shared)/w_(gate|up)$", ("fsdp", "d_ff")),
    (r"(mlp|shared)/w_down$", ("d_ff", "fsdp")),
    (r"moe/router$", ("fsdp", None)),
    (r"moe/w_(gate|up)$", ("experts", "fsdp", None)),
    (r"moe/w_down$", ("experts", None, "fsdp")),
    (r"ssm/in_proj$", ("fsdp", "ssm_inner")),
    (r"ssm/out_proj$", ("ssm_inner", "fsdp")),
    (r"ssm/conv_[wb]$", None),  # tiny; replicated
    (r"ssm/(A_log|D|dt_bias)$", None),
    (r"norm", None),
    (r"", None),  # default: replicated
)


def spec_for(path: str, shape, rules: Dict[str, AxisNames]) -> PartitionSpec:
    """The spec of the parameter at ``path`` (``/``-joined) of ``shape``."""
    for pat, names in _PARAM_RULES:
        if re.search(pat, path):
            if names is None:
                return PartitionSpec()
            full = (None,) * (len(shape) - len(names)) + tuple(names)
            return logical_spec(full, rules)
    return PartitionSpec()


def param_specs(params: Any, rules: Dict[str, AxisNames], prefix: str = ""):
    """A PartitionSpec tree for a parameter tree (nested dicts of tensors,
    or of anything with a ``shape``). Stacked-layer leading dims get None."""
    if isinstance(params, dict):
        return {k: param_specs(v, rules, f"{prefix}{k}/") for k, v in params.items()}
    return spec_for(prefix[:-1], params.shape, rules)
