"""ESACT reproduction, PyTorch/CUDA port.

The port of the reference JAX package ``repro`` to PyTorch and
hand-written CUDA kernels for an NVIDIA H100 (sm_90a).  It imports
``torch``, ``numpy`` and the standard library, never ``jax`` or ``repro``;
its layout mirrors the reference (``configs``, ``core``, ``models``,
``sparse_compute``, ``serving``, ``kernels``, ``observability``), and
``csrc/`` holds the CUDA sources.  Entry points run on the card unless the
caller passes ``device="cpu"``.

This slice serves the reference's main path: SPLS paged serving of a
causal attention-only model with packed compute
(:class:`repro_torch.serving.PagedServingEngine`).
"""
