"""Runnable examples of the port: ``python -m repro_torch.examples.quickstart``
and ``python -m repro_torch.examples.fog_ring_demo``."""
