"""Hand-written CUDA kernels of the inference path, their plain PyTorch
versions (``ref``) and the wrappers that pick between them (``ops``)."""
