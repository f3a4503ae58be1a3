"""repro_torch — PyTorch / CUDA port of the ``repro`` BranchyNet
partitioning system for one NVIDIA H100 (Hopper, sm_90).

The JAX package ``repro`` stays the reference; every module here mirrors
its counterpart's layout (configs/, core/, kernels/, models/, serving/)
and is held against it by the ``tests/test_torch_*.py`` suite.  The port
imports neither ``jax`` nor anything of ``repro``.
"""
