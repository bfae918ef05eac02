"""Launchers of the LM substrate: its meshes and the training launcher
(``python -m repro_torch.launch.train``)."""
