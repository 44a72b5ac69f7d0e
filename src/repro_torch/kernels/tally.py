"""Wrapper of the CUDA ``tally`` kernel (``csrc/tally.cu``): int64 values
added onto a small table, each block's copy of the table kept in shared
memory. It replaces no TPU kernel: the JAX package's tick adds with XLA
scatters, and the port's first form called ``scatter_add``.

CUDA tensors only; ``kernels/ops.py`` sends CPU and fake tensors to
``kernels/ref.tally_ref``. Launches are counted in ``LAUNCHES``. ``SPILLED``
holds an int64 pair on each card the kernel ran on, to which every launch
adds the entries it read and the entries that fell outside the on-chip
window and went to global atomics. Nothing on the epoch's path reads it (a
read synchronises); tests and ``chip_smoke.py`` do.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from repro_torch.kernels import _build

LAUNCHES = {"tally": 0}
SPILLED: Dict[torch.device, torch.Tensor] = {}

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _lib():
    lib = _build.load("tally")
    if not getattr(lib, "_typed", False):
        lib.tally.argtypes = [_P, _P, _LL, _LL, _LL, _P, _P, _P]
        lib.tally.restype = _I
        lib.tally_window.argtypes = [_LL, _LL]
        lib.tally_window.restype = _LL
        lib._typed = True
    return lib


def window(size: int, width: Optional[int] = None) -> int:
    """Slots a block keeps on chip for a table of ``size`` slots read as
    rows of ``width`` (one row when None): positions below this, in the
    kernel's column-major order, take shared atomics."""
    return int(_lib().tally_window(size, max(size if width is None else width, 1)))


def _check(name: str, t: torch.Tensor) -> None:
    if not t.is_cuda or t.dtype != torch.int64 or t.dim() != 1 or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D int64 CUDA tensor")


def tally(idx: torch.Tensor, size: int, values: Optional[torch.Tensor] = None, *,
          width: Optional[int] = None) -> torch.Tensor:
    """int64[size]: ``values`` (ones when None) added at ``idx``; a negative
    index wraps once from the end, one still outside [0, size) is dropped.
    ``width`` reads the table as rows of that many slots, which sets what
    the kernel keeps on chip and not the result."""
    _check("idx", idx)
    if values is not None:
        _check("values", values)
        if values.shape != idx.shape or values.device != idx.device:
            raise ValueError("values must match idx in shape and device")
    if not 0 <= size < 2**31:
        raise ValueError(f"tally takes a table of fewer than 2^31 slots, got {size}")
    width = size if width is None else width
    if size and not 1 <= width <= size:
        raise ValueError(f"width must be in [1, {size}], got {width}")
    out = torch.empty(size, dtype=torch.int64, device=idx.device)
    counts = SPILLED.get(idx.device)
    if counts is None:
        counts = SPILLED[idx.device] = torch.zeros(2, dtype=torch.int64, device=idx.device)
    stream = torch.cuda.current_stream(idx.device).cuda_stream
    err = _lib().tally(idx.data_ptr(), None if values is None else values.data_ptr(),
                       idx.shape[0], size, max(width, 1), out.data_ptr(), counts.data_ptr(),
                       stream)
    LAUNCHES["tally"] += 1
    if err != 0:
        raise RuntimeError(f"tally launch failed: CUDA error {err}")
    return out
