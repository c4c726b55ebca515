"""PyTorch/CUDA port of the Quasar reproduction (``repro``).

Mirrors ``repro``'s layout module by module.  Imports ``torch`` and numpy
only — never ``jax`` and nothing of ``repro``.  The kernels on the W8A8
speculative decode path are CUDA C++ for Hopper (``csrc/``), each with a
plain PyTorch version beside its wrapper in ``kernels/``.
"""
