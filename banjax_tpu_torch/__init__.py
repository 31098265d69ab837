"""PyTorch/CUDA port of banjax-tpu.

A second package beside `banjax_tpu` (the JAX reference, which it never
imports). Two paths so far: the regex rate-limit log path, whose
two-stage NFA match and device-resident fixed windows run as
hand-written CUDA kernels on an NVIDIA Hopper card, and the
`/auth_request` decision chain, whose proof-of-work check runs as a
batched SHA-256 kernel. Each kernel has a plain PyTorch version for the
CPU.
"""
