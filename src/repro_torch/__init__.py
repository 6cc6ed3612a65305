"""PyTorch/CUDA port of the heterogeneous scheduling system.

A second package beside the JAX one (``repro``), laid out like it: the
host-side scheduler stack is a copy with its imports rewritten, the model
path is torch, and the Pallas kernels on the serving path are hand-written
CUDA C++ kernels for Hopper (``repro_torch.kernels``). It imports torch,
numpy and the standard library only.
"""
