"""PyTorch / CUDA port of ``repro`` for an NVIDIA H100.

It mirrors the JAX package module for module (``repro/X.py`` pairs with
``repro_torch/X.py``) and imports neither ``jax`` nor ``repro``. Entry
points take an explicit ``device`` (default ``"cuda"``); the tests pass
``device="cpu"``, where each kernel wrapper runs its plain torch version.
"""
