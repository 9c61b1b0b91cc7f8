"""MLP family, the reference parity model (port of ``models/mlp.py``).

``Linear(20, 1)`` of the reference trainer (conf/model/default.yaml) and
the playground's ``Linear(10, 1)``, generalized to an optional stack of
ReLU hidden layers. The weights are a nested dict ``{"layer<i>": {"w":
(in, out), "b": (out,)}}``, the JAX tree leaf for leaf, so
``models/convert.py::mlp_from_jax_params`` carries JAX weights across.
Losses, as in the JAX module:

- ``mse``: the playground's regression loss, the one that learns;
- ``prob_xent``: the reference trainer's ``F.cross_entropy(logits,
  float_targets)`` over ``output_size`` logits; with one logit
  ``log_softmax`` is 0, so the loss and its gradient are 0 (SURVEY.md §8
  B5), reproduced as it is;
- ``xent``: cross entropy over integer labels.

The trainer's model contract is the transformer's (``param_shapes``,
``logical_axes``, ``bind_gather_for_compute``,
``bind_tensor_parallel``). The MLP has no stacked layer leaves: under
FSDP each ``layer<i>/w`` (its ``embed`` dim split over ``fsdp``) is
gathered whole as a top-level leaf, and its gradient reduce-scattered
back. It has no tensor-parallel block: a tp group that would split an
``mlp`` dim (a layer's output width divisible by tp > 1) raises.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import ClassVar

import torch
import torch.nn.functional as F

from distributed_training_tpu_torch.models.base import uniform_fan_in
from distributed_training_tpu_torch.models.transformer import torch_dtype
from distributed_training_tpu_torch.runtime import make_generator, resolve_device


@dataclass
class MLPConfig:
    input_size: int = 20
    output_size: int = 1
    hidden_sizes: list = field(default_factory=list)
    loss_name: str = "mse"
    dtype: str = "float32"

    @property
    def dims(self) -> list:
        """Each layer's (fan_in, fan_out)."""
        d = [self.input_size, *self.hidden_sizes, self.output_size]
        return list(zip(d[:-1], d[1:]))


class MLP:
    """Functional MLP: ``init`` makes the weights, ``apply`` the forward,
    ``loss`` the training loss. ``device=None`` runs on the CUDA card and
    raises without one."""

    batch_keys: ClassVar[tuple] = ("x", "y")
    stacked_keys: ClassVar[tuple] = ()

    def __init__(self, cfg: MLPConfig, device=None):
        if cfg.loss_name not in ("mse", "prob_xent", "xent"):
            raise ValueError(f"unknown loss '{cfg.loss_name}'")
        self.cfg = cfg
        self.device = resolve_device(device)
        self._gather = None

    def param_shapes(self) -> dict:
        return {f"layer{i}": {"w": (a, b), "b": (b,)}
                for i, (a, b) in enumerate(self.cfg.dims)}

    def logical_axes(self) -> dict:
        return {f"layer{i}": {"w": ("embed", "mlp"), "b": ("mlp",)}
                for i in range(len(self.cfg.dims))}

    def init(self, rng) -> dict:
        """torch.nn.Linear's init per layer from a seed (int) or a
        ``torch.Generator`` on this model's device."""
        gen = rng if isinstance(rng, torch.Generator) else \
            make_generator(rng, self.device)
        return {f"layer{i}": {
                    "w": uniform_fan_in(gen, (a, b), a, device=self.device),
                    "b": uniform_fan_in(gen, (b,), a, device=self.device)}
                for i, (a, b) in enumerate(self.cfg.dims)}

    def bind_gather_for_compute(self, gather) -> None:
        """Train on sharded weights: ``gather.leaf("layer<i>/w", w)``
        returns a leaf whole. ``None`` unbinds."""
        self._gather = gather

    def bind_tensor_parallel(self, tp) -> None:
        """Every tp rank computes the whole MLP on the same batch; a tp
        group that would split a layer's output width raises."""
        if tp is None or tp.size == 1:
            return
        for i, (_, out) in enumerate(self.cfg.dims):
            if out % tp.size == 0:
                raise ValueError(
                    f"tensor parallelism: the MLP has no tensor-parallel "
                    f"block, and tp={tp.size} would split layer{i}'s "
                    f"width {out}")

    def _w(self, params: dict, i: int, name: str) -> torch.Tensor:
        w = params[f"layer{i}"][name]
        return w if self._gather is None else self._gather.leaf(
            f"layer{i}/{name}", w)

    def apply(self, params: dict, x) -> torch.Tensor:
        """x (B, input_size) → outputs (B, output_size) in the compute
        dtype."""
        dt = torch_dtype(self.cfg.dtype)
        h = torch.as_tensor(x).to(device=self.device, dtype=dt)
        n = len(self.cfg.dims)
        for i in range(n):
            h = h @ self._w(params, i, "w").to(dt) + self._w(
                params, i, "b").to(dt)
            if i < n - 1:
                h = F.relu(h)
        return h

    def loss(self, params: dict, batch, rng=None,
             train: bool = True) -> tuple:
        """(scalar f32 loss, metrics) over ``batch["x"]``,
        ``batch["y"]``, differentiable in the params by autograd."""
        del rng, train
        pred = self.apply(params, batch["x"]).float()
        y = torch.as_tensor(batch["y"]).to(self.device)
        name = self.cfg.loss_name
        if name == "mse":
            loss = torch.mean((pred - y.float()) ** 2)
        elif name == "prob_xent":
            loss = torch.mean(-torch.sum(
                y.float() * torch.log_softmax(pred, dim=-1), dim=-1))
        else:
            labels = y.long().reshape(-1)
            loss = torch.mean(-torch.gather(
                torch.log_softmax(pred, dim=-1), 1, labels[:, None]))
        return loss, {"loss": loss.detach()}

    def flops_per_sample(self) -> float:
        """Forward + backward: 3 x the forward products' 2 * in * out."""
        return 3.0 * sum(2 * a * b for a, b in self.cfg.dims)
