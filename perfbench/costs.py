"""HBM bytes of the port's kernel entry points that the cells drive, computed
from the call's shapes and, where the work depends on the data, from its
inputs, frozen here as the benchmark's yardstick. They count what the
algorithm needs: each input byte read once and each output byte written
once, whatever a kernel reads again."""
from __future__ import annotations

import torch


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def page_move_bytes(pool: torch.Tensor, src_ids: torch.Tensor, dst_ids: torch.Tensor):
    """Bytes of a ``page_move`` call, a 0-d tensor on the ids' device (so
    that counting waits for nothing): the rows of the entries that move one
    (ids that differ, both in range) read and written once, and both id
    lists read."""
    rows = pool.shape[0]
    s, d = src_ids.to(torch.int64), dst_ids.to(torch.int64)
    real = ((s != d) & (s >= 0) & (s < rows) & (d >= 0) & (d < rows)).sum()
    return 2 * real * (pool[0].numel() * pool.element_size()) + 2 * _nbytes(src_ids)
