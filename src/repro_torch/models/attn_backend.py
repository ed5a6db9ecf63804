"""Attention backend registry of the port: the paged-decode site.

Paged decode backends (the serving engine's block-pool KV cache) share::

    fn(cfg, q, k_pages, v_pages, *, pos_pages, tables, kv_len, pos,
       window) -> o

with ``q: (B, KV, G, Dh)``, ``k/v_pages: (KV, N, ps, Dh)``, ``pos_pages:
(N, ps)``, ``tables: (B, P)``, ``kv_len / pos: (B,)``.

  * ``torch_paged_decode`` -- the plain version: gather the block table
    into a contiguous view, then dense masked softmax.
  * ``cuda_paged_decode``  -- the CUDA kernel
    (:func:`repro_torch.kernels.paged_flash_decode`).

The reference package's names are aliases (``xla_paged_decode`` ->
``torch_paged_decode``, ``pallas_paged_decode`` -> ``cuda_paged_decode``),
so one ``ServeConfig`` drives both packages.  ``"auto"`` resolves by the
device of the tensors: the kernel on the card, the plain version on the
CPU.  The forward (whole-prompt) and dense-decode sites wait for later
slices (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.kernels import paged_decode_plain, paged_flash_decode

__all__ = ["AUTO", "PAGED_DECODE_BACKENDS", "resolve_paged_backend",
           "get_backend", "site_backend"]

AUTO = "auto"
_ALIASES = {"xla_paged_decode": "torch_paged_decode",
            "pallas_paged_decode": "cuda_paged_decode"}
# the reference's backends of other call sites: a ServeConfig naming one
# of them leaves the paged-decode site on "auto", as the reference does
_OTHER_SITES = ("xla_dense", "xla_packed", "xla_chunked", "pallas_flash",
                "xla_dense_decode", "pallas_flash_decode")


def torch_paged_decode(cfg, q, k_pages, v_pages, *, pos_pages, tables,
                       kv_len, pos, window=None) -> torch.Tensor:
    return paged_decode_plain(q, k_pages, v_pages, pos_pages, tables,
                              kv_len, pos, softcap=cfg.attn_softcap,
                              window=window)


def cuda_paged_decode(cfg, q, k_pages, v_pages, *, pos_pages, tables,
                      kv_len, pos, window=None) -> torch.Tensor:
    return paged_flash_decode(q, k_pages, v_pages, pos_pages, tables,
                              kv_len, pos, softcap=cfg.attn_softcap,
                              window=window)


PAGED_DECODE_BACKENDS: Dict[str, Callable] = {
    "torch_paged_decode": torch_paged_decode,
    "cuda_paged_decode": cuda_paged_decode,
}


def site_backend(name: Optional[str]) -> str:
    """Route a ``ServeConfig.attn_backend`` name to the paged-decode site:
    a paged-decode name (or alias) stays, a name of another site becomes
    ``"auto"``, an unknown name raises."""
    if name is None or name == AUTO:
        return AUTO
    name = _ALIASES.get(name, name)
    if name in PAGED_DECODE_BACKENDS:
        return name
    if name in _OTHER_SITES:
        return AUTO
    raise ValueError(f"unknown attention backend {name!r}; paged-decode "
                     f"backends: {sorted(PAGED_DECODE_BACKENDS)} (aliases "
                     f"{sorted(_ALIASES)})")


def resolve_paged_backend(name: Optional[str], device: torch.device) -> str:
    """Concrete paged-decode backend for tensors on ``device``."""
    name = site_backend(name)
    if name == AUTO:
        return ("cuda_paged_decode" if torch.device(device).type == "cuda"
                else "torch_paged_decode")
    return name


def get_backend(name: str) -> Callable:
    try:
        return PAGED_DECODE_BACKENDS[_ALIASES.get(name, name)]
    except KeyError:
        raise ValueError(f"unknown paged-decode backend {name!r}; "
                         f"registered: {sorted(PAGED_DECODE_BACKENDS)}"
                         ) from None
