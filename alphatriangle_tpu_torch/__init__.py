"""PyTorch + CUDA port of alphatriangle_tpu: policy serving and training.

A package of its own beside `alphatriangle_tpu` (the JAX reference it
is held against by the `tests/test_torch_*.py` parity tests). It
imports torch and numpy, never JAX. Entry points run on the CUDA card
unless the caller passes `device="cpu"`; the hand-written kernels in
`csrc/` build on first use into `_build/`.
"""

__version__ = "0.1.0"
