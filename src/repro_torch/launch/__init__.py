"""Launchers of the PyTorch port: ``python -m repro_torch.launch.serve
--arch <id>`` serves and ``python -m repro_torch.launch.train --arch <id>``
trains any architecture of the registry
(:mod:`repro_torch.configs.registry`) at its smoke size; :mod:`.steps`
holds the training and serving step functions."""
