"""repro_torch — the Field of Groves inference path in PyTorch for NVIDIA Hopper.

A port of ``repro`` (JAX/Pallas) that mirrors its module layout:
data/ (synthetic UCI twins), forest/ (tensorized trees, host CART, the
packed table format), core/ (groves, confidence, policy, energy, the
Algorithm-2 engine) and kernels/ (hand-written CUDA kernels with their
plain PyTorch twins).  It imports torch and numpy only.
"""

__version__ = "0.1.0"
