"""Launchers of the PyTorch port: the production mesh, the dry run,
training and serving entry points.  ``python -m repro_torch.launch.serve
--arch <id>`` serves and ``python -m repro_torch.launch.train --arch <id>``
trains any architecture of the registry
(:mod:`repro_torch.configs.registry`) at its smoke size; :mod:`.steps`
holds the training and serving step functions; ``python -m
repro_torch.launch.dryrun`` (:mod:`.dryrun`, :mod:`.dryrun_all`) runs a
step of a production cell on ``DTensor``s, :mod:`.op_analysis` counts it.

NOTE: unlike the reference's, :mod:`.dryrun` sets no environment variable
when imported (the ``fake`` process group takes the place of XLA's
placeholder devices), so importing it from here would be harmless; it is
left out all the same, as the reference leaves it out, and is run as
``__main__``.
"""

from .mesh import make_cpu_mesh, make_production_mesh, mesh_axis_sizes
from .steps import (make_loss_grad, make_prefill_step, make_serve_step,
                    make_train_step)
