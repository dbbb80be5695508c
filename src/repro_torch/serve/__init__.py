"""Serving entry points (port of ``repro.serve``): the LM prefill and
decode steps."""
