"""Weight bridge from the reference package's parameter tree.

The port keeps the reference's tree and layouts, so bridging is a copy:
nested dicts and tuples of numpy arrays (the reference's ``init_params``
output after ``np.asarray`` on every leaf) become the same nesting of
tensors on ``device``.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["params_from_jax"]


def params_from_jax(tree, device: Optional[str] = None):
    """Nested dicts / tuples / lists of numpy arrays -> tensors on
    ``device`` (default: the card)."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(conv(v) for v in t)
        return torch.from_numpy(np.array(t, copy=True)).to(dev)

    return conv(tree)
