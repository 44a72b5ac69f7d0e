"""The content of every page of a tiered-memory cell: rows that name their
page, so that a page found in another page's frame, a row left behind or a
row half written reads wrong. Imports torch only."""
from __future__ import annotations

import torch


def content(ids: torch.Tensor, elems: int, seed: int) -> torch.Tensor:
    """f32[len(ids), elems]: column 0 is the page id, the rest a hash of
    (page, column, seed); every value is an exact float32 integer."""
    ids = ids.to(torch.int64)
    col = torch.arange(elems, dtype=torch.int64, device=ids.device)
    v = (ids[:, None] * 2654435761 + col[None, :] * 40503 + (seed & 0xFFFFFF)) & 0xFFFFFF
    v[:, 0] = ids
    return v.to(torch.float32)


def wrong_pages(read_rows, pages: int, elems: int, seed: int, chunk: int = 1 << 16) -> int:
    """How many of pages [0, pages) read back other bytes than ``content``;
    ``read_rows(ids)`` returns the rows the program holds for ``ids``."""
    bad = 0
    for lo in range(0, pages, chunk):
        ids = torch.arange(lo, min(lo + chunk, pages), dtype=torch.int64)
        got = read_rows(ids)
        want = content(ids.to(got.device), elems, seed)
        bad += int((got.view(torch.int32) != want.view(torch.int32)).any(dim=1).sum())
    return bad
