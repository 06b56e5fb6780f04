"""PyTorch/CUDA port of the KGE system: sharded top-k serving, full-graph
and edge mini-batch training, filtered evaluation, with the entity table
dense, row-sharded or int8.

A second package beside the JAX/Pallas reference ``repro``: the same
subpackage layout and names, rewritten in PyTorch, with every Pallas kernel
on those paths replaced by a CUDA C++ kernel for Hopper (``csrc/``).
The port imports ``torch`` and numpy only — never ``jax`` and nothing of
``repro``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
A CPU tensor takes each kernel's plain PyTorch version; a CUDA tensor
launches the kernel or raises.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
