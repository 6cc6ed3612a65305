"""Hand-written CUDA kernels for Hopper, replacing the JAX package's Pallas
TPU kernels on the serving path.

Each kernel module (``flash_attention``, ``flash_decode``) holds the CUDA
kernel's wrapper (which launches it for CUDA tensors), its plain PyTorch
version (which the wrapper computes for CPU tensors, and which the tests and
``chip_smoke.py`` hold the kernel against) and a launch count. ``ops`` holds
the model-layout entry points, ``ref`` the plain oracles in the JAX
kernels' layout, and ``_build`` the nvcc build. Importing builds nothing: a
kernel is compiled at its first launch.
"""
