"""The LM side (port of ``repro.models``): the Mamba-2 decoder, its serving
steps' building blocks and the FoG layer-grove early exit."""
