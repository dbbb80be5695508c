"""The LM side (port of ``repro.models``): the decoder of attention and
Mamba-2 layers, its serving steps' building blocks and the FoG
layer-grove early exit."""
