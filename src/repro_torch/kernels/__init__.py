"""Hand-written CUDA kernels of the inference path and of the device
trainer, their plain PyTorch versions (``ref``, and beside each kernel)
and the wrappers that pick between them (``ops``)."""
