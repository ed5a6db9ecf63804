"""Device selection for the port's entry points.

Entry points run on the card unless the caller asks for the CPU:
``device=None`` means ``"cuda"``, and without a CUDA device that raises
instead of silently running on the CPU.  Every comparison in this
repository is float32, so TF32 is switched off for matrix products and
convolutions on the way in.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; the port runs on the card by "
            "default -- pass device='cpu' to run on the CPU")
    return dev
