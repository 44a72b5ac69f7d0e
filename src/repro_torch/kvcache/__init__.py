"""The tiered paged KV cache on PyTorch."""
