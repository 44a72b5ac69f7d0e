"""MaxMem on PyTorch and CUDA: the port of the JAX package ``repro``.

``repro_torch.core`` holds the policy engine, the manager and the page data
plane; ``repro_torch.kernels`` the hand-written CUDA kernels for Hopper and
their plain PyTorch versions. The package imports torch and numpy only.
"""
