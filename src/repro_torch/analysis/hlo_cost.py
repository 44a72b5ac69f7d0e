"""Cost of one call of a PyTorch function: FLOPs, HBM bytes, collective bytes.

The reference counts a step from its compiled HLO text (trip-count-aware,
``src/repro/analysis/hlo_cost.py``). PyTorch runs eagerly and has no HLO, so
the port counts the call itself: :class:`CostCounter` is a
``TorchDispatchMode`` that sees every aten operation the call runs (the
backward and remat's recompute included; a Python loop of L layers is L
calls, which is what the reference's trip counts recover), and
:func:`module_cost` returns the reference's :class:`ModuleCost` record.

  * FLOPs: ``torch.utils.flop_counter``'s formulas (matmuls, convolutions,
    attention), with the same decomposition of operations it has no formula
    for;
  * bytes: each operation's tensor operands read and results written once;
    views are free, so a slice reads only its slice; gathers read the region
    they return and scatters touch their update twice (the reference's
    slicing and update rules); ``empty`` allocates without traffic;
  * collective bytes: the result bytes of each functional collective
    (``torch.distributed._functional_collectives``), by kind;
  * the hand-written kernels: each entry point of ``kernels/ops.py`` finds
    the counter on the dispatch-mode stack and reports its kernel's
    analytic FLOPs and bytes (:meth:`CostCounter.kernel`), and the
    operations inside the call are not counted, so the count of a call is
    the same on the card, where the kernel launches through ctypes, and on
    the CPU, where its plain version runs, in a forward or a backward.
    ``kernel_calls`` counts the entry calls by kernel.

Bytes are eager PyTorch's, one pass per operation; XLA's fusion moves fewer,
so byte counts are not comparable across the two packages (FLOPs are).
"""
from __future__ import annotations

import os
import sys
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

# functional collectives (namespace _c10d_functional) by the reference's kind
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather", "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter", "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_DTYPE_NAMES = {
    torch.bool: "pred", torch.int8: "s8", torch.uint8: "u8", torch.int16: "s16",
    torch.int32: "s32", torch.int64: "s64", torch.float16: "f16", torch.bfloat16: "bf16",
    torch.float32: "f32", torch.float64: "f64",
}
# metadata queries that reach a dispatch mode and move nothing
_A = torch.ops.aten
_META = {
    _A.sym_is_contiguous.default, _A.is_contiguous.default, _A.is_contiguous.memory_format,
    _A.is_strides_like_format.default, _A.is_non_overlapping_and_dense.default,
    _A.size.default, _A.sym_size.default, _A.stride.default, _A.sym_stride.default,
    _A.storage_offset.default, _A.sym_storage_offset.default, _A.numel.default,
    _A.sym_numel.default, _A.dim.default, torch.ops.prim.layout.default,
}
# allocate without traffic, or alias their input without the view tag
_FREE = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
         "_unsafe_view"}
# read the region they return (and write it): the reference's slicing rule
_GATHERS = {"index_select", "gather", "index", "embedding", "take_along_dim"}
# touch their update region twice (read and write): the reference's update
# rule; the value is the update operand's position
_UPDATES = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2, "index_copy": 3,
            "index_copy_": 3, "index_add": 3, "index_add_": 3, "scatter": 3, "scatter_": 3,
            "scatter_add": 3, "scatter_add_": 3, "slice_scatter": 1, "select_scatter": 1}
# write their first operand without reading it
_WRITE_ONLY_SELF = {"copy_", "fill_", "zero_", "normal_", "uniform_", "random_"}

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_NOT_NAMED = (os.path.join(_PKG, "analysis"), os.path.join(_PKG, "kernels"))


@dataclass
class ModuleCost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    coll_counts: Dict[str, float] = field(default_factory=lambda: defaultdict(float))
    # the hand-written kernels' share of flops and bytes, and their calls
    kernel_flops: float = 0.0
    kernel_bytes: float = 0.0
    kernel_calls: Dict[str, float] = field(default_factory=lambda: defaultdict(float))

    @property
    def coll_total(self) -> float:
        return float(sum(self.coll_bytes.values()))

    def scaled(self, factor: float) -> "ModuleCost":
        out = ModuleCost()
        out.add(self, factor)
        return out

    def add(self, other: "ModuleCost", factor: float = 1.0) -> None:
        self.flops += other.flops * factor
        self.bytes += other.bytes * factor
        self.kernel_flops += other.kernel_flops * factor
        self.kernel_bytes += other.kernel_bytes * factor
        for mine, theirs in ((self.coll_bytes, other.coll_bytes),
                             (self.coll_counts, other.coll_counts),
                             (self.kernel_calls, other.kernel_calls)):
            for k, v in theirs.items():
                mine[k] += v * factor


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from _tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _tensors(x)


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def rtype(out) -> str:
    """A result's type in the reference's HLO notation, e.g. ``bf16[8,128]``."""
    t = next(_tensors(out), None)
    if t is None:
        return ""
    return f"{_DTYPE_NAMES.get(t.dtype, str(t.dtype))}[{','.join(map(str, t.shape))}]"


_FN_NAMES: Dict[object, Optional[str]] = {}


def _fn_name(code) -> Optional[str]:
    """``module.function`` for a function of the port (analysis and kernels
    excluded), else None."""
    if code not in _FN_NAMES:
        f = code.co_filename
        keep = f.startswith(_PKG) and not f.startswith(_NOT_NAMED)
        _FN_NAMES[code] = (f"{os.path.splitext(os.path.basename(f))[0]}.{code.co_name}"
                           if keep else None)
    return _FN_NAMES[code]


def op_path() -> str:
    """The port's functions on the Python stack, outermost first, as
    ``transformer.loss_fn/transformer.block_full/...``. In a backward pass
    the walk stops at the autograd engine and the path starts with the
    node being run, so the card's backward thread and the CPU's caller
    thread name an operation alike."""
    names = []
    frame = sys._getframe(1)
    while frame is not None:
        code = frame.f_code
        if code.co_name == "_engine_run_backward":
            break
        name = _fn_name(code)
        if name is not None and (not names or names[-1] != name):
            names.append(name)
        frame = frame.f_back
    node = torch._C._current_autograd_node()
    if node is not None:
        names.append(f"backward:{node.name()}")
    return "/".join(reversed(names))


class CostCounter(TorchDispatchMode):
    """Counts what runs under it into ``cost`` (a :class:`ModuleCost`).

    ``on_op(comp, instr, kind, op_name, flops, bytes, coll_bytes, rtype)``,
    if given, is called for every counted operation and kernel call
    (``comp`` is ``forward`` or ``backward``; ``kind`` is the aten
    operation, or ``kernel`` with ``instr`` the kernel's name)."""

    counts_kernels = True  # the mark ``ops`` looks for on the mode stack

    def __init__(self, on_op: Optional[Callable] = None):
        super().__init__()
        self.cost = ModuleCost()
        self.on_op = on_op
        self._quiet = 0

    def _record(self, instr: str, kind: str, flops: float, nbytes: float, coll: float, out):
        if self.on_op is not None:
            comp = "backward" if torch._C._current_autograd_node() is not None else "forward"
            self.on_op(comp, instr, kind, op_path(), flops, nbytes, coll, rtype(out))

    def kernel(self, name: str, cost: Callable, launch: Callable):
        """A hand-written kernel's entry point (``ops._run``): its analytic
        cost, and nothing of what runs inside."""
        self._quiet += 1
        try:
            flops, nbytes = cost()
            out = launch()
        finally:
            self._quiet -= 1
        c = self.cost
        c.flops += flops
        c.bytes += nbytes
        c.kernel_flops += flops
        c.kernel_bytes += nbytes
        c.kernel_calls[name] += 1
        self._record(name, "kernel", flops, nbytes, 0.0, out)
        return out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self._quiet or func in _META:
            return func(*args, **kwargs)
        packet = func._overloadpacket
        if packet not in flop_registry:
            with self:  # as FlopCounterMode: count the decomposition instead
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        name = packet.__name__
        flops = 0.0
        if packet in flop_registry:
            flops = float(flop_registry[packet](*args, **kwargs, out_val=out))
        coll = 0.0
        if func.namespace == "_c10d_functional":
            kind = _COLLECTIVES.get(name)
            nbytes = 0.0 if kind is None else float(_nbytes(args) + _nbytes(out))
            if kind is not None:
                coll = float(_nbytes(out))
                self.cost.coll_bytes[kind] += coll
                self.cost.coll_counts[kind] += 1
        elif func.is_view or name in _FREE:
            nbytes = 0.0
        elif name in _GATHERS:
            nbytes = 2.0 * _nbytes(out)
        elif name in _UPDATES:
            upd = args[_UPDATES[name]] if len(args) > _UPDATES[name] else None
            nbytes = 2.0 * _nbytes(upd)
        else:
            nbytes = float(_nbytes(args) + _nbytes(kwargs) + _nbytes(out))
            if name in _WRITE_ONLY_SELF:
                nbytes -= _nbytes(args[0])
        self.cost.flops += flops
        self.cost.bytes += nbytes
        if flops or nbytes or coll:
            self._record(str(func), name, flops, nbytes, coll, out)
        return out


def module_cost(fn: Callable, *args, **kwargs) -> ModuleCost:
    """The cost of one call ``fn(*args, **kwargs)``, run under a
    :class:`CostCounter` on whatever device its tensors are on."""
    with CostCounter() as counter:
        fn(*args, **kwargs)
    return counter.cost
