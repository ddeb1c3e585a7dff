"""PyTorch / CUDA port of Tiled Bit Networks: serving and training the
decoder LM, and the paper's CNN / transformer / PointNet models.

Mirrors ``src/repro/`` module for module (same names, same "/"-joined
param-tree key paths) so each module's JAX reference is easy to find.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
the hand-written Hopper kernels B1-B6 (``kernels/*.py`` over ``csrc/``)
launch only for CUDA tensors, and their plain PyTorch versions run only
for CPU tensors.
"""
