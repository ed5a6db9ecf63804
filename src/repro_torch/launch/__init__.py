"""Launchers of the PyTorch port: ``python -m repro_torch.launch.serve
--arch <id>`` serves any architecture of the registry
(:mod:`repro_torch.configs.registry`) at its smoke size."""
