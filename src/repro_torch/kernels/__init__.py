"""Hand-written CUDA kernels of the search path, their plain PyTorch
versions (``ref``) and the device dispatch (``ops``)."""
