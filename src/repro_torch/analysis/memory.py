"""Memory of one call of a PyTorch function on one device: the reference's
``compiled.memory_analysis()`` (``src/repro/launch/dryrun.py:147-156``).

The reference reads argument, output, temporary and peak bytes from XLA's
buffer assignment. Eager PyTorch has no compiler to ask, so the port follows
the call itself. :class:`LiveBytes` is kept by ``hlo_cost.CostCounter``, the
dispatch mode that sees every aten operation of the call (the backward and
remat's recompute included, on the autograd engine's thread too), and so
rides in the counter's one pass:

  * each storage an operation creates on the traced device is live from
    then until it is freed (a ``weakref`` to its ``UntypedStorage``, one
    Python object per storage, fires then); views and in-place results add
    nothing, and neither does a result whose storage an operand holds;
  * each storage counts as a block of the CUDA caching allocator: its bytes
    rounded up to a multiple of 512 (:func:`block_bytes`);
  * the hand-written kernels report what they hold on the card
    analytically (``CostCounter.kernel``): their new outputs, then the
    allocations and frees of ``ops.*_workspace``, freed by the call's end
    or kept after it (``page_move``'s per-device workspace). What their
    plain versions allocate on the CPU or on fake tensors does not show, so
    a call reads the same on the card, on the CPU and on ``FakeTensorMode``
    tensors;
  * ``DTensor``: only the local blocks, as the counter counts them; the
    global-shape operations of sharding propagation are not followed.

``peak_bytes`` is the call's arguments (held by the caller throughout) plus
the highest live bytes of the storages the call created; ``temp_bytes`` is
``peak_bytes - argument_bytes``, the call's outputs included. What the
tracker cannot see: allocations that never reach the dispatcher's Python
key (an operation's internal scratch on the card, cuBLAS's workspace), the
caching allocator's unsplit blocks (a cached block up to 1 MiB larger than
asked may be handed out whole), and frees of storages the call did not
create.
"""
from __future__ import annotations

import collections
import weakref
from dataclasses import dataclass
from typing import Callable, Dict, Optional

import torch
from torch.distributed.tensor import DTensor

GRANULE = 512  # the CUDA caching allocator's block granularity


def block_bytes(nbytes: int) -> int:
    """``nbytes`` as a block of the CUDA caching allocator: 0 for nothing,
    else rounded up to a multiple of :data:`GRANULE`."""
    return -(-int(nbytes) // GRANULE) * GRANULE


def tensors(tree):
    """The plain tensors of ``tree`` (a ``DTensor`` gives its local block)."""
    if isinstance(tree, DTensor):
        yield tree.to_local()
    elif isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            yield from tensors(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from tensors(x)


def local_bytes(tree) -> int:
    """Bytes of this rank's blocks of every tensor in ``tree``."""
    return sum(t.numel() * t.element_size() for t in tensors(tree))


def device_of(tree) -> Optional[torch.device]:
    """The device of ``tree``'s first tensor, or None."""
    t = next(tensors(tree), None)
    return None if t is None else t.device


def _key(device) -> tuple:
    d = torch.device(device)
    return d.type, d.index or 0


class LiveBytes:
    """The live bytes of the storages a call creates on ``device``, and
    their peak (``peak``, from 0 at the call's start)."""

    def __init__(self, device):
        self.device = None if device is None else _key(device)
        self.live = 0
        self.peak = 0
        self._refs: Dict[int, weakref.ref] = {}
        self._freed = collections.deque()  # bytes freed, folded in before the next growth

    def _on(self, t: torch.Tensor) -> bool:
        return self.device is not None and _key(t.device) == self.device

    def _settle(self) -> None:
        while self._freed:
            self.live -= self._freed.popleft()

    def hold(self, *steps: int) -> None:
        """Allocations (bytes > 0) and frees (bytes < 0) in order, each as a
        block of the allocator."""
        self._settle()
        for n in steps:
            self.live += block_bytes(n) if n >= 0 else -block_bytes(-n)
            self.peak = max(self.peak, self.live)

    def _follow(self, storage) -> None:
        key, n = id(storage), storage.nbytes()
        refs, freed = self._refs, self._freed

        def gone(ref):
            if refs.get(key) is ref:
                del refs[key]
            freed.append(block_bytes(n))

        refs[key] = weakref.ref(storage, gone)
        self.hold(n)

    def track(self, out, operands) -> None:
        """Follow the storages of ``out``'s tensors on the device that no
        tensor of ``operands`` holds and that are not followed yet: the
        ones the operation created."""
        held = None
        for t in tensors(out):
            if not self._on(t):
                continue
            s = t.untyped_storage()
            if id(s) in self._refs:
                continue
            if held is None:
                held = {id(a.untyped_storage()) for a in tensors(operands) if self._on(a)}
            if id(s) not in held:
                self._follow(s)

    def kernel(self, out, operands, workspace) -> None:
        """A hand-written kernel's call: its new outputs, then its
        ``workspace``, the allocations and frees it makes beyond them."""
        self.track(out, operands)
        self.hold(*workspace)

    def settled(self) -> int:
        self._settle()
        return self.live


@dataclass
class MemoryAnalysis:
    """The reference's ``memory_analysis()`` fields for one call on one
    device (``generated_code_bytes`` has no counterpart: nothing compiles)."""
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    peak_bytes: int

    def as_dict(self) -> dict:
        return {"argument_bytes": self.argument_bytes, "output_bytes": self.output_bytes,
                "temp_bytes": self.temp_bytes, "peak_bytes": self.peak_bytes,
                "generated_code_bytes": None}


def analysis(args, out, live: LiveBytes) -> MemoryAnalysis:
    """The record of a call of ``args`` that returned ``out``, followed by
    ``live``."""
    arg = local_bytes(args)
    return MemoryAnalysis(argument_bytes=arg, output_bytes=local_bytes(out),
                          temp_bytes=live.peak, peak_bytes=arg + live.peak)


def memory_analysis(fn: Callable, *args, **kwargs) -> MemoryAnalysis:
    """The memory of one call ``fn(*args, **kwargs)`` on the device of the
    first tensor of ``args``, followed under a ``hlo_cost.CostCounter``."""
    from repro_torch.analysis.hlo_cost import CostCounter

    with CostCounter(device=device_of(args)) as counter:
        out = fn(*args, **kwargs)
    return analysis(args, out, counter.live)
