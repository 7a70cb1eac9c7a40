"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their wrappers.

Each wrapper takes the JAX function's signature and layout, checks
device, dtype, shape and contiguity, allocates its outputs, launches on
the current stream and adds one to its ``launches`` count.  It runs the
plain PyTorch version (same module) only for tensors on the CPU; for a
CUDA tensor it launches the kernel or raises.
"""
