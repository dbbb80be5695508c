"""Launchers (port of ``repro.launch``): the serve CLI
(``python -m repro_torch.launch.serve``), the train CLI
(``python -m repro_torch.launch.train``) and the serving plane's device
list."""
