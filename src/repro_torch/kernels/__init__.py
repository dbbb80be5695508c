"""Hand-written CUDA kernels of the inference path, of the device trainer,
of the Mamba-2 layer and of attention, their plain PyTorch versions
(``ref``, and beside each kernel) and the wrappers that pick between them
(``ops``)."""
