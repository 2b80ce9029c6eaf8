"""Kernels of the port: plain PyTorch versions (``ref``), hand-written CUDA
for Hopper (``csrc``, built and bound by ``build``), and the dispatching
wrappers (``ops``)."""
