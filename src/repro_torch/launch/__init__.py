"""Launchers (port of ``repro.launch``): the serve CLI
(``python -m repro_torch.launch.serve``) and the serving plane's device
list."""
