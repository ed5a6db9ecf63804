"""Weight bridge from the reference package's parameter tree.

The port keeps the reference's tree and layouts, so bridging is a copy:
nested dicts and tuples of numpy arrays (the reference's ``init_params``
output after ``np.asarray`` on every leaf) become the same nesting of
tensors on ``device``.  A bfloat16 leaf (numpy has no bfloat16 of its
own: JAX hands out ``ml_dtypes.bfloat16`` arrays, which ``torch.from_numpy``
refuses) crosses as its 16-bit pattern, so it arrives bit for bit.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.optim.adamw import OptState

__all__ = ["params_from_jax", "opt_state_from_jax"]


def params_from_jax(tree, device: Optional[str] = None):
    """Nested dicts / tuples / lists of numpy arrays -> tensors on
    ``device`` (default: the card)."""
    dev = resolve_device(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return type(t)(conv(v) for v in t)
        return _tensor(np.array(t, copy=True)).to(dev)

    return conv(tree)


def opt_state_from_jax(state, device: Optional[str] = None):
    """The reference's AdamW state (``OptState(count, mu, nu)`` of numpy
    arrays, e.g. after ``np.asarray`` on every leaf) -> the port's
    :class:`~repro_torch.optim.adamw.OptState` on ``device`` (default: the
    card), so both packages can start from one state."""
    dev = resolve_device(device)
    return OptState(count=_tensor(np.array(state.count, copy=True)).to(dev),
                    mu=params_from_jax(state.mu, dev),
                    nu=params_from_jax(state.nu, dev))


def _tensor(a: np.ndarray) -> torch.Tensor:
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)
