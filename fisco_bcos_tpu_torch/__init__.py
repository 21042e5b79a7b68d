"""PyTorch/CUDA port of the fisco_bcos_tpu device plane.

Module paths mirror the JAX package (``ops/limb.py``, ``ops/keccak.py``,
``crypto/admission.py``, ...). Every function takes or derives an explicit
``torch.device``; entry points run on CUDA unless the caller passes
``device="cpu"``. On a CUDA tensor a ported kernel launches its hand-written
CUDA kernel or raises; its plain PyTorch version runs only for CPU tensors.

This package imports ``torch`` and never ``jax`` nor anything of
``fisco_bcos_tpu``: what it needs of the JAX package's host-only modules it
keeps as its own copy.
"""
