"""fenet on PyTorch and CUDA: the port of the JAX package ``fenet`` to an
NVIDIA H100 (Hopper, sm_90a).

Subpackages mirror ``fenet``'s so that every module has a named counterpart.
The package imports torch and numpy only; hand-written CUDA kernels live in
``csrc/`` and are built at first use by :mod:`fenet_torch.ops._build`.
"""
