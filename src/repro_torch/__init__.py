"""PyTorch / CUDA port of the Tiled Bit Networks serving path.

Mirrors ``src/repro/`` module for module (same names, same "/"-joined
param-tree key paths) so each module's JAX reference is easy to find.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
the two hand-written Hopper kernels (``kernels/tiled_matvec.py``,
``kernels/tiled_matmul.py``) launch only for CUDA tensors, and their plain
PyTorch versions run only for CPU tensors.
"""
