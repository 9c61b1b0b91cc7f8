"""PyTorch / CUDA port of distributed_training_tpu for NVIDIA Hopper.

A second package beside the JAX one, with the same module layout and
public names so a reader can find each counterpart. It imports neither
``jax`` nor ``distributed_training_tpu``: what it needs from a
framework-free module of the JAX package is copied here.

Slice 1 is the serving path on one card: ``models.transformer``
(inference forward), ``ops`` (attention, the flash-attention forward and
the paged-decode kernel), ``serving`` (paged KV cache, continuous-
batching engine, HTTP server) and ``telemetry.events``. Slice 2 is
training on one card: ``config``, ``data``, ``models`` (``loss``, remat,
the registry), ``ops.xent``, the flash-attention backward, ``train``
(optimizer, state, trainer, CLI), ``parallel.strategy`` (``ddp``) and
``checkpoint``. Every Pallas kernel of the JAX package is hand-written
CUDA C++ for ``sm_90a`` under ``csrc/``, built at first use by
``kernels.build``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; nothing falls back to the CPU on its own. On CPU
tensors every kernel wrapper runs its plain PyTorch version, which is
what the CPU tests hold against the JAX reference.
"""
