"""PyTorch/CUDA port of the continuous-time MAP trajectory estimator.

A second package beside the JAX reference ``repro``, with the same layout
(``core/``, ``kernels/``, ``configs/``).  It imports ``torch`` and
``numpy`` only.  Its entry points run on the CUDA card unless the caller
passes ``device="cpu"``.
"""
