"""Runnable examples of the port: ``python -m repro_torch.examples.quickstart``,
``python -m repro_torch.examples.fog_ring_demo`` and
``python -m repro_torch.examples.train_lm``."""
