"""BrePartition exact batched kNN in PyTorch, with hand-written CUDA kernels.

The PyTorch counterpart of ``src/repro``: the same module names, the same
arithmetic, tensors in place of jax arrays.  Entry points run on the CUDA
device unless the caller passes ``device="cpu"``; on the CPU every kernel
runs its plain PyTorch version (``kernels/ref.py``).
"""
