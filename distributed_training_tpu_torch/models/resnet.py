"""ResNet-18 for CIFAR-10, BASELINE.json config 2 (port of
``models/resnet.py``).

The JAX package's functional ResNet, name for name: a CIFAR stem (3x3
conv, no max-pool), four stages of basic blocks (2-2-2-2), GroupNorm(32)
in place of BatchNorm (stateless, so a data-parallel world of N equals
one process on the global batch), global average pooling and a linear
head. Activations are NHWC, as the data arrives and as JAX computes
them; weights are stored in JAX's HWIO layout ``(kh, kw, cin, cout)``,
so the tree, ``flops_per_sample`` and the leaf the fsdp shape heuristic
splits are JAX's. Each stage is a dict keyed by the block's index
(``params["stage0"]["0"]["conv1"]``) where JAX's tree holds a list: the
port's tree utilities take dicts, and sorted keys give JAX's leaf order
for fewer than ten blocks a stage (``models/convert.py::
resnet_from_jax_params`` carries JAX's weights across).

The convolutions are ``F.conv2d`` on NCHW views of the NHWC tensors (a
``channels_last`` tensor, which cuDNN takes as it is), with XLA's
``SAME`` padding: ``lo = total // 2``, so a 3x3 stride-2 conv on an even
size pads ``(0, 1)``, which ``F.pad`` applies in NHWC before the view.
GroupNorm is the JAX expression in plain PyTorch: f32 statistics over
each group of contiguous channels, the biased variance, ``eps`` 1e-5
inside the rsqrt, the affine in f32, then the compute dtype (an f64
model, the reference of the card's f32 gradients, keeps f64). Nothing
here is a Pallas kernel in the reference: XLA fuses it, and the port
computes it with PyTorch's own operations. ``LAYOUTS`` counts the memory
format of every conv input (``channels_last`` or ``other``).

The trainer's model contract is the MLP's: no logical axes (every leaf
takes the shape heuristic, as JAX's ``logical_axes() -> None``), each
leaf gathered whole by its path under FSDP
(``bind_gather_for_compute``), and under ``tp`` every rank computes the
whole model on the same batch (nothing is split over tp). There is no
sequence to split over ``sp`` and no pipeline over ``pp``: the trainer
raises for either.
"""

from __future__ import annotations

import collections
import math
from dataclasses import dataclass, field
from typing import ClassVar

import torch
import torch.nn.functional as F

from distributed_training_tpu_torch.models.base import normal_init
from distributed_training_tpu_torch.models.transformer import torch_dtype
from distributed_training_tpu_torch.runtime import make_generator, resolve_device

# Conv inputs by memory format since the last clear: "channels_last"
# (NHWC storage under the NCHW view) or "other".
LAYOUTS: collections.Counter = collections.Counter()


def _same_pads(size: int, k: int, stride: int) -> tuple[int, int]:
    """XLA's SAME padding of one spatial dim: (lo, hi)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x: torch.Tensor, w: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """x NHWC, w HWIO → NHWC, SAME padding, in x's dtype."""
    kh, kw = w.shape[0], w.shape[1]
    if (kh, kw) == (1, 1) and stride > 1:
        # A 1x1 conv at stride s reads every s-th pixel (SAME pads
        # nothing): taken as a slice, since PyTorch's CPU backward of a
        # strided 1x1 conv over channels_last corrupts the heap.
        x, stride = x[:, ::stride, ::stride, :].contiguous(), 1
    (ht, hb), (wl, wr) = (_same_pads(x.shape[1], kh, stride),
                          _same_pads(x.shape[2], kw, stride))
    pad = (ht, wl)
    if (ht, wl) != (hb, wr):
        x = F.pad(x, (0, 0, wl, wr, ht, hb))
        pad = (0, 0)
    xc = x.permute(0, 3, 1, 2)
    LAYOUTS["channels_last" if xc.is_contiguous(
        memory_format=torch.channels_last) else "other"] += 1
    # OIHW with channels_last strides: one copy from HWIO, cast included.
    wc = w.permute(3, 0, 1, 2).to(
        x.dtype, memory_format=torch.contiguous_format).permute(0, 3, 1, 2)
    return F.conv2d(xc, wc, stride=stride, padding=pad).permute(0, 2, 3, 1)


def _group_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
                groups: int = 32) -> torch.Tensor:
    """GroupNorm over NHWC: ``min(groups, C)`` lowered until it divides
    C, statistics and affine in f32 (f64 for an f64 input, a reference
    run), the result in x's dtype."""
    dt = x.dtype
    B, H, W, C = x.shape
    g = min(groups, C)
    while C % g:
        g -= 1
    st = torch.promote_types(dt, torch.float32)
    xf = x.to(st).reshape(B, H, W, g, C // g)
    mu = xf.mean(dim=(1, 2, 4), keepdim=True)
    var = xf.var(dim=(1, 2, 4), keepdim=True, correction=0)
    xf = ((xf - mu) * torch.rsqrt(var + 1e-5)).reshape(B, H, W, C)
    return (xf * scale.to(st) + bias.to(st)).to(dt)


@dataclass
class ResNet:
    """ResNet-18 (2-2-2-2 basic blocks), CIFAR stem (3x3, no max-pool).
    ``device=None`` runs on the CUDA card and raises without one."""

    num_classes: int = 10
    width: int = 64
    stage_sizes: list = field(default_factory=lambda: [2, 2, 2, 2])
    dtype: str = "float32"
    loss_name: str = "xent"
    device: object = None
    batch_keys: ClassVar[tuple] = ("x", "y")
    stacked_keys: ClassVar[tuple] = ()

    def __post_init__(self):
        self.device = resolve_device(self.device)
        self._gather = None

    def _stages(self) -> list:
        chans = [self.width * (2 ** i) for i in range(len(self.stage_sizes))]
        return list(zip(self.stage_sizes, chans))

    def _blocks(self):
        """(stage, block, stride, cin, cout) of every block, in order."""
        cin = self.width
        for si, (blocks, cout) in enumerate(self._stages()):
            for bi in range(blocks):
                yield si, bi, 2 if (si > 0 and bi == 0) else 1, cin, cout
                cin = cout

    def param_shapes(self) -> dict:
        def gn(c):
            return {"scale": (c,), "bias": (c,)}
        out: dict = {"stem": {"w": (3, 3, 3, self.width), **gn(self.width)}}
        for si, bi, stride, cin, cout in self._blocks():
            blk = {"conv1": (3, 3, cin, cout), "gn1": gn(cout),
                   "conv2": (3, 3, cout, cout), "gn2": gn(cout)}
            if stride != 1 or cin != cout:
                blk["proj"] = (1, 1, cin, cout)
            out.setdefault(f"stage{si}", {})[str(bi)] = blk
        cin = self._stages()[-1][1]
        out["head"] = {"w": (cin, self.num_classes), "b": (self.num_classes,)}
        return out

    def logical_axes(self) -> dict:
        """None for every leaf (JAX returns None): the strategies' shape
        heuristic places each conv."""
        return {}

    def init(self, rng) -> dict:
        """He-normal convs (``sqrt(2 / (kh kw cin))``), a
        ``sqrt(1 / cin)`` head, unit GroupNorm scales and zero biases,
        drawn in JAX's order from a seed (int) or a ``torch.Generator``
        on this model's device."""
        gen = rng if isinstance(rng, torch.Generator) else \
            make_generator(rng, self.device)
        dev = self.device

        def conv_w(kh, kw, cin, cout):
            return normal_init(gen, (kh, kw, cin, cout),
                               math.sqrt(2.0 / (kh * kw * cin)), device=dev)

        def gn(c):
            return {"scale": torch.ones((c,), device=dev),
                    "bias": torch.zeros((c,), device=dev)}
        params: dict = {"stem": {"w": conv_w(3, 3, 3, self.width),
                                 **gn(self.width)}}
        for si, bi, stride, cin, cout in self._blocks():
            blk = {"conv1": conv_w(3, 3, cin, cout), "gn1": gn(cout),
                   "conv2": conv_w(3, 3, cout, cout), "gn2": gn(cout)}
            if stride != 1 or cin != cout:
                blk["proj"] = conv_w(1, 1, cin, cout)
            params.setdefault(f"stage{si}", {})[str(bi)] = blk
        cin = self._stages()[-1][1]
        params["head"] = {
            "w": normal_init(gen, (cin, self.num_classes),
                             math.sqrt(1.0 / cin), device=dev),
            "b": torch.zeros((self.num_classes,), device=dev)}
        return params

    def bind_gather_for_compute(self, gather) -> None:
        """Train on sharded weights: ``gather.leaf(path, w)`` returns a
        leaf whole. ``None`` unbinds."""
        self._gather = gather

    def bind_tensor_parallel(self, tp) -> None:
        """Every tp rank computes the whole model on the same batch: no
        leaf has a dim the tp rules split."""
        del tp

    def _leaf(self, params: dict, path: str) -> torch.Tensor:
        node = params
        for k in path.split("/"):
            node = node[k]
        return node if self._gather is None else self._gather.leaf(path, node)

    def _gn(self, params: dict, prefix: str, x: torch.Tensor) -> torch.Tensor:
        return _group_norm(x, self._leaf(params, f"{prefix}/scale"),
                           self._leaf(params, f"{prefix}/bias"))

    def apply(self, params: dict, x) -> torch.Tensor:
        """x (B, H, W, 3) → f32 logits (B, num_classes)."""
        dt = torch_dtype(self.dtype)
        x = torch.as_tensor(x).to(device=self.device, dtype=dt)
        x = F.relu(self._gn(params, "stem",
                            _conv(x, self._leaf(params, "stem/w"))))
        for si, bi, stride, cin, cout in self._blocks():
            p = f"stage{si}/{bi}"
            h = F.relu(self._gn(params, f"{p}/gn1", _conv(
                x, self._leaf(params, f"{p}/conv1"), stride)))
            h = self._gn(params, f"{p}/gn2",
                         _conv(h, self._leaf(params, f"{p}/conv2")))
            shortcut = (_conv(x, self._leaf(params, f"{p}/proj"), stride)
                        if stride != 1 or cin != cout else x)
            x = F.relu(h + shortcut)
        x = x.mean(dim=(1, 2))  # global average pool
        logits = (x @ self._leaf(params, "head/w").to(dt)
                  + self._leaf(params, "head/b").to(dt))
        return logits.float()

    def loss(self, params: dict, batch, rng=None,
             train: bool = True) -> tuple:
        """(scalar f32 cross entropy, {"loss", "accuracy"}) over
        ``batch["x"]``, ``batch["y"]``, differentiable in the params by
        autograd."""
        del rng, train
        logits = self.apply(params, batch["x"])
        labels = torch.as_tensor(batch["y"]).to(self.device).long()
        logp = torch.log_softmax(logits, dim=-1)
        loss = -torch.gather(logp, 1, labels[:, None]).mean()
        acc = (logits.argmax(-1) == labels).float().mean()
        return loss, {"loss": loss.detach(), "accuracy": acc}

    def flops_per_sample(self) -> float:
        """JAX's accounting: 3 x the forward's 3x3 convs at 32x32 (2
        flops a MAC), without the projections or the head."""
        hw = 32 * 32
        total = 2 * 3 * 3 * 3 * self.width * hw
        cin = self.width
        for si, (blocks, cout) in enumerate(self._stages()):
            scale = 4 ** si  # spatial halving per stage
            for _ in range(blocks):
                total += 2 * 9 * cin * cout * hw // scale
                total += 2 * 9 * cout * cout * hw // scale
                cin = cout
        return 3.0 * total
