"""Step functions: training (with gradient accumulation) and serving --
the reference's ``repro.launch.steps`` on one device.

Training routes as the reference's training does.  No kernel of either
package has a backward (:mod:`repro_torch.models.attn_backend`), so the
reference trains through its XLA backends; :func:`make_loss_grad` runs
the forward and backward under :func:`repro_torch.device.route_as`
``("cpu")``, which resolves ``"auto"`` to the reference's CPU choices
(``torch_dense`` / ``torch_chunked`` attention, ``packed_torch`` compute)
on whatever device the tensors are.  A configuration that names a kernel
backend trains into that kernel's wrapper, which raises.

The reference's sharding seams bind logical axes to a device mesh:
``axis_rules`` around the step is installed by
:class:`~repro_torch.runtime.trainer.Trainer` given a mesh, and picks the
attention's head layout.  On plain tensors (one global view) the model's
``constrain`` calls return their input; on the ``DTensor`` inputs of the
dry run (:mod:`repro_torch.launch.dryrun`) they redistribute the
activations where the reference constrains them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional

import torch

from repro_torch.device import route_as
from repro_torch.loops import scan
from repro_torch.models import decode_step, loss_fn, prefill
from repro_torch.optim import AdamWConfig, adamw_update
from repro_torch.sharding.logical import is_dtensor
from repro_torch.tree import leaves, tree_map

__all__ = ["make_train_step", "make_prefill_step", "make_serve_step",
           "make_loss_grad"]

def _with_backend(cfg, attn_backend: Optional[str]):
    """Pin an attention backend for this step (None keeps cfg's choice;
    the reference's names are aliases of the port's, ``"pallas_flash"``
    of ``cuda_flash``)."""
    if attn_backend is None or attn_backend == cfg.attn_backend:
        return cfg
    return dataclasses.replace(cfg, attn_backend=attn_backend)


def _value_and_grad(cfg, params, batch):
    """``(loss, metrics, grads)`` of :func:`loss_fn` at ``params``: each
    floating leaf enters as a fresh autograd leaf sharing its storage, so
    the caller's tensors never require grad; a leaf the loss does not
    reach gets a zero gradient (the reference's ``jax.grad`` gives zeros
    too)."""
    tracked = tree_map(
        lambda p: p.detach().requires_grad_(p.is_floating_point()), params)
    loss, metrics = loss_fn(cfg, tracked, batch)
    flat = [t for t in leaves(tracked) if t.requires_grad]
    got = dict(zip(map(id, flat),
                   torch.autograd.grad(loss, flat, allow_unused=True)))

    def grad_of(t):
        g = got.get(id(t))
        return torch.zeros_like(t) if g is None else g

    return loss.detach(), metrics, tree_map(grad_of, tracked)


def _microbatch(v: torch.Tensor, n_micro: int, i: int) -> torch.Tensor:
    """Microbatch ``i`` of ``n_micro``: rows ``[i * b, (i + 1) * b)`` of a
    plain batch, as the reference splits it.  A ``DTensor`` batch sharded
    over its rows takes every ``n_micro``-th row from ``i`` instead, so
    that each device keeps its own rows (a contiguous block would gather
    the batch)."""
    B = v.shape[0]
    if is_dtensor(v):
        return v.reshape(B // n_micro, n_micro, *v.shape[1:])[:, i]
    return v.reshape(n_micro, B // n_micro, *v.shape[1:])[i]


def make_loss_grad(cfg, n_micro: int = 1) -> Callable:
    """``(params, batch) -> (grads, metrics)``, with microbatch
    accumulation.

    The global batch is reshaped to ``(n_micro, B / n_micro, ...)`` and
    the microbatches run one after another: gradients are summed in
    float32 divided by ``n_micro`` (one microbatch's activations live at a
    time), and so is the loss (``metrics = {"loss"}``).  With ``n_micro``
    1 the gradients keep each parameter's dtype and the metrics are
    :func:`loss_fn`'s."""

    def loss_grad(params, batch: Dict[str, torch.Tensor]):
        with route_as("cpu"):
            if n_micro == 1:
                _, metrics, grads = _value_and_grad(cfg, params, batch)
                return grads, metrics
            B = batch["inputs"].shape[0]
            if B % n_micro:
                raise ValueError(f"global batch {B} is not divisible by "
                                 f"n_micro={n_micro}")
            acc = tree_map(lambda p: torch.zeros_like(
                p, dtype=torch.float32), params)

            def micro(loss_acc, i):
                mb = {k: _microbatch(v, n_micro, i)
                      for k, v in batch.items()}
                loss, _, grads = _value_and_grad(cfg, params, mb)
                with torch.no_grad():
                    for a, g in zip(leaves(acc), leaves(grads)):
                        a.add_(g.float() / n_micro)
                    return loss_acc + loss / n_micro, None

            loss_acc, _ = scan(micro, torch.zeros(
                (), dtype=torch.float32, device=batch["inputs"].device),
                n_micro)
            return acc, {"loss": loss_acc}

    return loss_grad


def make_train_step(cfg, opt_cfg: AdamWConfig, schedule: Callable,
                    n_micro: int = 1) -> Callable:
    """``(params, opt_state, batch) -> (params, opt_state, metrics)``;
    ``params`` and the moments are updated in place."""
    loss_grad = make_loss_grad(cfg, n_micro)

    def train_step(params, opt_state, batch):
        grads, metrics = loss_grad(params, batch)
        lr = schedule(opt_state.count)
        params, opt_state, opt_metrics = adamw_update(
            opt_cfg, grads, opt_state, params, lr)
        return params, opt_state, {**metrics, **opt_metrics}

    return train_step


def make_prefill_step(cfg, attn_backend: Optional[str] = None) -> Callable:
    """``(params, inputs, max_len=None) -> (logits, cache)``, without
    autograd.  SPLS runs here when enabled.  ``attn_backend`` pins an
    attention backend for the whole prefill (``"pallas_flash"`` is the
    port's ``cuda_flash``); default defers to ``cfg`` / auto.  ``max_len``
    (default the prompt's length, the reference's only choice) sizes the
    cache for the decode steps that follow."""
    cfg = _with_backend(cfg, attn_backend)

    @torch.no_grad()
    def prefill_step(params, inputs, max_len: Optional[int] = None):
        return prefill(cfg, params, inputs, max_len=max_len)

    return prefill_step


def make_serve_step(cfg, attn_backend: Optional[str] = None) -> Callable:
    """``(params, cache, tokens, pos) -> (logits, cache)``, without
    autograd (the cache is updated in place).  ``attn_backend`` pins the
    decode backend (``"pallas_flash_decode"`` is the port's
    ``cuda_flash_decode``)."""
    cfg = _with_backend(cfg, attn_backend)

    @torch.no_grad()
    def serve_step(params, cache, tokens, pos):
        return decode_step(cfg, params, cache, tokens, pos)

    return serve_step
