"""Wrapper of the CUDA paged decode attention kernel
(``csrc/paged_attention.cu``).

``paged_attention`` replaces the reference's Pallas kernel of the same name.
It takes CUDA tensors only: it checks device, dtype, shape and contiguity,
allocates its output with ``torch.empty``, launches on the current stream,
raises if the launch failed, and counts its launches in ``LAUNCHES``.
``kernels/ops.py`` sends CPU tensors to the plain version in
``kernels/ref.py`` instead.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build

LAUNCHES = {"paged_attention": 0}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def typed_fn(name: str, argtypes):
    """The C function ``name`` of ``csrc/<name>.cu``, built at first use."""
    lib = _build.load(name)
    if not getattr(lib, "_typed", False):
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = _I
        lib._typed = True
    return getattr(lib, name)


def check_tensor(name: str, t: torch.Tensor, dim: int, device=None, dtype=None) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} must be on {device}, got {t.device}")
    if t.dim() != dim or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dim}-D tensor")
    if dtype is not None and t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in _DTYPE_CODE:
        raise ValueError(f"no attention kernel for {t.dtype}; float32 and bfloat16 only")
    return _DTYPE_CODE[t.dtype]


def paged_attention(q, k_pages, v_pages, block_tables, seq_lens) -> torch.Tensor:
    """[B, nh, dh] decode attention of q over the pages of ``block_tables``
    (see ``ref.paged_attention_ref``). One launch."""
    check_tensor("q", q, 3)
    dev, dt = q.device, q.dtype
    code = dtype_code(q)
    check_tensor("k_pages", k_pages, 4, dev, dt)
    check_tensor("v_pages", v_pages, 4, dev, dt)
    if k_pages.shape != v_pages.shape:
        raise ValueError("k_pages and v_pages must have the same shape")
    B, nh, dh = q.shape
    _, page, nkv, dh_k = k_pages.shape
    if dh_k != dh or nh % nkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools {tuple(k_pages.shape)}")
    check_tensor("block_tables", block_tables, 2, dev, torch.int32)
    check_tensor("seq_lens", seq_lens, 1, dev, torch.int32)
    if block_tables.shape[0] != B or seq_lens.shape[0] != B:
        raise ValueError("block_tables and seq_lens need one row per query")
    out = torch.empty_like(q)
    fn = typed_fn("paged_attention", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _I, _P])
    err = fn(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(), block_tables.data_ptr(),
        seq_lens.data_ptr(), out.data_ptr(), B, block_tables.shape[1], page, nkv, dh,
        nh // nkv, 1.0 / math.sqrt(dh), code, torch.cuda.current_stream(dev).cuda_stream,
    )
    LAUNCHES["paged_attention"] += 1
    if err != 0:
        raise RuntimeError(f"paged_attention launch failed: CUDA error {err}")
    return out
