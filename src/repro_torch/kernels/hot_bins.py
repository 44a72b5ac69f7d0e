"""Wrapper of the CUDA ``hot_bins`` kernel (``csrc/hot_bins.cu``), the
port of the reference's Pallas ``hot_bins``: the sampled page ids added to
the counts with atomics and the heat bins computed, in one cooperative
launch.

CUDA tensors only; ``kernels/ops.py`` sends CPU tensors to
``kernels/ref.hot_bins_ref``. Launches are counted in ``LAUNCHES``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

LAUNCHES = {"hot_bins": 0}

_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


def _lib():
    lib = _build.load("hot_bins")
    if not getattr(lib, "_typed", False):
        lib.hot_bins.argtypes = [_P, _LL, _P, _P, _P, _I, _I, _P]
        lib.hot_bins.restype = _I
        lib._typed = True
    return lib


def hot_bins(page_ids: torch.Tensor, counts_in: torch.Tensor, *, num_bins: int = 6):
    """Returns (counts_out i32[P], bins i32[P]) for int32 ``page_ids`` [N]
    (entries < 0 or >= P ignored) and int32 ``counts_in`` [P]."""
    for name, t in (("page_ids", page_ids), ("counts_in", counts_in)):
        if not t.is_cuda or t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D int32 CUDA tensor")
    if page_ids.device != counts_in.device:
        raise ValueError("page_ids and counts_in must be on the same device")
    if not 1 <= num_bins <= 32:
        raise ValueError(f"num_bins must be in [1, 32], got {num_bins}")
    P, N = counts_in.shape[0], page_ids.shape[0]
    if P >= 2**31:
        raise ValueError("hot_bins takes fewer than 2^31 pages")
    counts_out = torch.empty_like(counts_in)
    bins = torch.empty_like(counts_in)
    stream = torch.cuda.current_stream(counts_in.device).cuda_stream
    err = _lib().hot_bins(
        page_ids.data_ptr(), N, counts_in.data_ptr(), counts_out.data_ptr(), bins.data_ptr(), P,
        num_bins, stream,
    )
    LAUNCHES["hot_bins"] += 1
    if err != 0:
        raise RuntimeError(f"hot_bins launch failed: CUDA error {err}")
    return counts_out, bins
