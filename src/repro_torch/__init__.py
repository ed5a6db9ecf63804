"""ESACT reproduction, PyTorch/CUDA port.

The port of the reference JAX package ``repro`` to PyTorch and
hand-written CUDA kernels for an NVIDIA H100 (sm_90a).  It imports
``torch``, ``numpy`` and the standard library, never ``jax`` or ``repro``;
its layout mirrors the reference (``configs``, ``core``, ``models``,
``sparse_compute``, ``serving``, ``kernels``, ``observability``,
``optim``, ``data``, ``checkpoint``, ``runtime``, ``launch``), and
``csrc/`` holds the CUDA sources.  Entry points run on the card unless the
caller passes ``device="cpu"``.

The port serves what the reference's engines serve, greedily or by
temperature sampling: the paged engine in every mode --
chunked SPLS prefill on packed or simulation-mode compute, without SPLS,
without page pruning, with a finite vote horizon -- and whole-prompt
prefill, and the dense fixed-slot engine (:mod:`repro_torch.serving`);
``python -m repro_torch.serve_batch`` is the reference's serving example,
and :mod:`repro_torch.observability` its telemetry and
``BENCH_serving.json`` report.  :mod:`repro_torch.configs.registry` holds
the reference's ten architectures -- dense GQA, MoE, Mamba2, the hybrid,
the embeddings input -- and ``python -m repro_torch.launch.serve --arch
<id>`` serves any of them.  The reference's training stack is here too:
``models.loss_fn``, AdamW, the synthetic data pipeline, checkpoints in its
layout and the healing ``Trainer`` (``python -m repro_torch.launch.train
--arch <id>``, ``python -m repro_torch.train_lm``); training runs the
reference's differentiable routes, since no kernel has a backward
(``torch_packed`` at a reduced q capacity).  :mod:`repro_torch.perfmodel`
is the reference's cycle and energy model of the ESACT accelerator;
``python -m repro_torch.quickstart`` and ``python -m
repro_torch.spls_ablation`` are its two examples of the SPLS pipeline.
"""
