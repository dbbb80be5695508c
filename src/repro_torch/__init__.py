"""repro_torch — Field of Groves in PyTorch for NVIDIA Hopper.

A port of ``repro`` (JAX/Pallas) that mirrors its module layout:
data/ (synthetic UCI twins and LM token batches), forest/ (tensorized
trees, host CART, the packed table format), core/ (groves, confidence,
policy, energy, the Algorithm-2 engine), kernels/ (hand-written CUDA
kernels with their plain PyTorch twins), configs/ (the LM architecture
configs), models/ (the attention and Mamba-2 decoder and its FoG
layer-grove exit), serve/ (the LM steps, the continuous batcher, the
replica plane and the energy governors), registry/ (versioned
multi-tenant artifacts and the resident pack cache) and launch/ (the
serve CLI).  It imports torch and numpy only.
"""

__version__ = "0.1.0"
