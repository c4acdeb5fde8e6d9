"""repro_torch — the MAPSIN join engine in PyTorch, with hand-written CUDA
kernels for NVIDIA Hopper (sm_90a).

Each module keeps the name of its counterpart in the JAX package ``repro``,
which is the reference this package is tested against. This package never
imports ``jax`` or ``repro``: composite keys are int64 tensors natively,
so no global switch is needed.
"""
