"""PyTorch port of the ``repro`` package for one NVIDIA H100.

Mirrors the module layout of ``repro`` so that every file has one reference
file. It imports ``torch`` and never ``jax``, and nothing from ``repro``.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
