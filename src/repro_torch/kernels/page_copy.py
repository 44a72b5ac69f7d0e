"""Wrappers of the CUDA page-copy kernels (``csrc/page_copy.cu``).

``page_move`` and ``page_copy`` replace the reference's Pallas kernels of
the same names. They take CUDA tensors only: each checks device, dtype,
shape and contiguity, launches on the current stream, raises if the launch
failed, and counts its calls in ``LAUNCHES`` (one per call; ``page_move``'s
call is three kernel launches). ``kernels/ops.py`` sends CPU tensors to the
plain versions in ``kernels/ref.py`` instead.

``page_move`` keeps a workspace per device between calls (``_Workspace``):
the row marks, which its kernels leave zero, the compacted plan, the
classes, the counters and the scratch for staged entries, grown to the
largest call seen and never allocated per call. Calls on one device must
share one stream.
"""
from __future__ import annotations

import ctypes
from typing import Dict, List

import torch

from repro_torch.kernels import _build

LAUNCHES = {"page_move": 0, "page_copy": 0}

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _lib():
    lib = _build.load("page_copy")
    if not getattr(lib, "_typed", False):
        lib.page_move.argtypes = [_P, _LL, _P, _P, _I, _LL, _P, _P, _P, _P, _I, _P, _P]
        lib.page_move.restype = _I
        lib.page_copy.argtypes = [_P, _LL, _P, _LL, _P, _P, _I, _LL, _P]
        lib.page_copy.restype = _I
        lib._typed = True
    return lib


# page_move's counter words (csrc/page_copy.cu): the class counts A, B, S of
# the last call, 32 words apart, then the two alternating real counts
_CTR_WORDS = 5 * 32
_CTR_CLASSES = [0, 32, 64]
_GROWN = ("marks", "plan", "cls", "scratch")  # the buffers a call may replace


def _grown(have: Dict[str, int], rows: int, m: int, row_bytes: int):
    """The buffers a workspace holding ``have`` (elements by name) replaces
    for a call of ``rows`` rows of ``row_bytes`` and ``m`` entries, in the
    order ``_Workspace.fit`` allocates them: (name, dtype, elements)."""
    out = []
    if have["marks"] < 2 * rows:
        out.append(("marks", torch.uint8, 2 * rows))
    if have["cls"] < m:
        out += [("plan", torch.int32, 2 * m), ("cls", torch.int32, m)]
    # the worst case: every real entry staged
    if have["scratch"] < min(m, rows) * row_bytes:
        out.append(("scratch", torch.uint8, min(m, rows) * row_bytes))
    return out


class _Workspace:
    """page_move's buffers on one device, grown to the largest call seen."""

    def __init__(self, device: torch.device):
        self.device = device
        self.parity = 0
        self.marks = torch.zeros(0, dtype=torch.uint8, device=device)  # kept zero
        self.plan = torch.empty(0, dtype=torch.int32, device=device)
        self.cls = torch.empty(0, dtype=torch.int32, device=device)
        self.ctr = torch.zeros(_CTR_WORDS, dtype=torch.int32, device=device)
        self.scratch = torch.empty(0, dtype=torch.uint8, device=device)

    def held(self) -> Dict[str, int]:
        return {name: getattr(self, name).numel() for name in _GROWN}

    def fit(self, rows: int, m: int, row_bytes: int) -> None:
        for name, dtype, n in _grown(self.held(), rows, m, row_bytes):
            make = torch.zeros if name == "marks" else torch.empty
            setattr(self, name, make(n, dtype=dtype, device=self.device))


def workspace_growth(device: torch.device, rows: int, m: int, row_bytes: int) -> List[int]:
    """The bytes the next ``page_move`` call of that shape on ``device``
    allocates (> 0) and frees (< 0), in order, while it grows the
    workspace: a first call makes the counter words, then each new buffer
    is allocated before the one it replaces is freed."""
    ws = _WORKSPACES.get(device)
    steps = [] if ws is not None else [_CTR_WORDS * 4]
    have = ws.held() if ws is not None else dict.fromkeys(_GROWN, 0)
    for name, dtype, n in _grown(have, rows, m, row_bytes):
        steps += [n * dtype.itemsize, -have[name] * dtype.itemsize]
    return steps


_WORKSPACES: Dict[torch.device, _Workspace] = {}


def _check_pool(name: str, pool: torch.Tensor) -> None:
    if not pool.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {pool.device}")
    if pool.dim() != 2 or not pool.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 2-D [rows, elems] tensor")


def _check_ids(name: str, ids: torch.Tensor, device: torch.device, m: int) -> None:
    if ids.device != device or ids.dtype != torch.int32 or ids.dim() != 1:
        raise ValueError(f"{name} must be a 1-D int32 tensor on {device}")
    if not ids.is_contiguous() or ids.shape[0] != m:
        raise ValueError(f"{name} must be contiguous with {m} entries")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def page_move(pool: torch.Tensor, src_ids: torch.Tensor, dst_ids: torch.Tensor) -> torch.Tensor:
    """In place ``pool[dst_ids[i]] = pool[src_ids[i]]`` with gather
    semantics (every read sees the pre-plan pool). Entries with equal ids
    or an id outside the pool do nothing. Returns ``pool``."""
    _check_pool("pool", pool)
    m = src_ids.shape[0]
    _check_ids("src_ids", src_ids, pool.device, m)
    _check_ids("dst_ids", dst_ids, pool.device, m)
    rows, row_bytes = pool.shape[0], pool.shape[1] * pool.element_size()
    ws = _WORKSPACES.get(pool.device)
    if ws is None:
        ws = _WORKSPACES[pool.device] = _Workspace(pool.device)
    ws.fit(rows, m, row_bytes)
    stream = torch.cuda.current_stream(pool.device).cuda_stream
    err = _lib().page_move(
        pool.data_ptr(), rows, src_ids.data_ptr(), dst_ids.data_ptr(), m, row_bytes,
        ws.marks.data_ptr(), ws.plan.data_ptr(), ws.cls.data_ptr(), ws.ctr.data_ptr(),
        ws.parity, ws.scratch.data_ptr(), stream,
    )
    LAUNCHES["page_move"] += 1
    if err != 0:
        del _WORKSPACES[pool.device]  # its marks may no longer be zero
    _raise_on(err, "page_move launch failed")
    if m > 0 and row_bytes > 0:
        ws.parity ^= 1
    return pool


def page_move_classes(pool: torch.Tensor) -> torch.Tensor:
    """i32[3]: the numbers of A, B and S entries (``ref.page_move_classes``)
    that the last ``page_move`` call on ``pool``'s device counted, as a
    tensor on the card (reading it waits for that call)."""
    return _WORKSPACES[pool.device].ctr[_CTR_CLASSES]


def page_copy(
    src_pool: torch.Tensor, dst_pool: torch.Tensor, src_ids: torch.Tensor, dst_ids: torch.Tensor
) -> torch.Tensor:
    """In place ``dst_pool[dst_ids[i]] = src_pool[src_ids[i]]``. Returns
    ``dst_pool``; rows written by several entries (trash padding) end with
    one of them, unspecified which."""
    _check_pool("src_pool", src_pool)
    _check_pool("dst_pool", dst_pool)
    if src_pool.device != dst_pool.device or src_pool.dtype != dst_pool.dtype:
        raise ValueError("src_pool and dst_pool must share device and dtype")
    if src_pool.shape[1] != dst_pool.shape[1]:
        raise ValueError("src_pool and dst_pool must have the same row width")
    if src_pool.data_ptr() == dst_pool.data_ptr():
        raise ValueError("page_copy needs two pools; use page_move within one")
    m = src_ids.shape[0]
    _check_ids("src_ids", src_ids, dst_pool.device, m)
    _check_ids("dst_ids", dst_ids, dst_pool.device, m)
    row_bytes = dst_pool.shape[1] * dst_pool.element_size()
    stream = torch.cuda.current_stream(dst_pool.device).cuda_stream
    err = _lib().page_copy(
        src_pool.data_ptr(), src_pool.shape[0], dst_pool.data_ptr(), dst_pool.shape[0],
        src_ids.data_ptr(), dst_ids.data_ptr(), m, row_bytes, stream,
    )
    LAUNCHES["page_copy"] += 1
    _raise_on(err, "page_copy launch failed")
    return dst_pool
