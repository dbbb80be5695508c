"""Serving (port of ``repro.serve``): the LM prefill and decode steps
(``decode``), the continuous batcher (``scheduler``), the data-parallel
replica plane (``dispatch``) and the energy governors (``governor``)."""
