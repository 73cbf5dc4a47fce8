"""PyTorch/CUDA port of the CaPGNN reproduction (``src/repro``, JAX).

Same subpackage names as the JAX package, so each module's counterpart is
easy to find.  The port imports ``torch`` and numpy only — never ``jax``
nor anything of ``repro``.  Its entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; the kernels dispatch by tensor device (a
CPU tensor takes the plain version, a CUDA tensor the hand-written Hopper
kernel).
"""
