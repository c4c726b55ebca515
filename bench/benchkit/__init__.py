"""The benchmark's own code: set-up, the served window, the readers'
records, the frozen roofline counts, the device-trace reduction, the plain
reference and the comparison that decides ``correct``.

Nothing here imports ``jax`` or the JAX package (``repro``); the reference
(:mod:`benchkit.reference`) imports nothing of ``repro_torch`` either.
"""
