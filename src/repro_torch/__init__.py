"""PyTorch/CUDA port of the RAPIDx alignment system (serving path).

Mirrors the layout of the JAX package module by module; imports torch and
numpy only. Entry points run on the card by default and raise without
one; pass ``device="cpu", backend="reference"`` for the CPU.
"""
