"""PyTorch/CUDA port of the HeLoCo asynchronous training system.

Mirrors the module tree of the JAX reference package ``repro`` (which stays
the reference every part of this package is tested against) and imports
nothing from it. Hot sweeps run as hand-written CUDA kernels for Hopper
(``csrc/``); every kernel keeps a plain PyTorch version beside it, used for
CPU tensors only.
"""
