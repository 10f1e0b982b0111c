"""Cellpose-class segmentation U-Net (counterpart of ``aliby_tpu/models/unet.py``).

Residual double-conv blocks with GroupNorm and SiLU, a global L2-normalised
style vector from the bottleneck added into every decoder stage, and a
3-channel head (flow_y, flow_x, cell logit). Widths 32-64-128-256.

The dtype at each boundary follows the Flax model: convolutions and the
style Dense compute in ``dtype`` (bf16 by default) with their bias added
in ``dtype``; GroupNorm computes in f32 and returns f32; residual adds are
in ``dtype``; the head is f32. GroupNorm uses Flax's statistics
(``E[x^2] - E[x]^2`` clipped at 0, ``eps=1e-6``), not ``F.group_norm``'s.
The public ``forward`` takes and returns NHWC like the Flax model; inside
it runs NCHW. Parameters are f32; :func:`aliby_tpu_torch.models.weights.
params_from_flax` names them.

``forward(x, sp=shard)`` runs this rank's block of image rows of a
spatially partitioned forward (:mod:`aliby_tpu_torch.parallel.spatial`):
the 3x3 convolutions take halo rows from the neighbouring ranks, GroupNorm
and the style vector all-reduce their sums. Without ``sp`` nothing of that
runs, and the forward is the one-device forward, bit for bit.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from aliby_tpu_torch.device import resolve_device
from aliby_tpu_torch.parallel import spatial


class GroupNorm(nn.Module):
    """Flax ``nn.GroupNorm(dtype=float32)``: f32 statistics and output."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor, sp: spatial.SpatialShard | None = None) -> torch.Tensor:
        x = x.to(torch.float32)
        B, C, H, W = x.shape
        g = x.reshape(B, self.num_groups, -1)
        if sp is None:
            mu = g.mean(dim=-1)
            mu2 = (g * g).mean(dim=-1)
        else:  # the group's sums over every rank's rows
            sums = spatial.all_reduce(torch.stack([g.sum(dim=-1), (g * g).sum(dim=-1)]),
                                      sp.group)
            n = sp.global_count(g.shape[-1])
            mu, mu2 = sums[0] / n, sums[1] / n
        var = torch.clamp_min(mu2 - mu * mu, 0.0)
        per_c = C // self.num_groups
        mean = mu.repeat_interleave(per_c, dim=1).reshape(B, C, 1, 1)
        mul = torch.rsqrt(var + self.eps).repeat_interleave(per_c, dim=1).reshape(B, C, 1, 1)
        mul = mul * self.weight.reshape(1, C, 1, 1)
        return (x - mean) * mul + self.bias.reshape(1, C, 1, 1)


class Conv(nn.Module):
    """Flax ``nn.Conv`` with ``SAME`` padding, computed in ``dtype``."""

    def __init__(self, cin: int, cout: int, k: int, dtype: torch.dtype):
        super().__init__()
        self.dtype = dtype
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k))
        self.bias = nn.Parameter(torch.zeros(cout))
        nn.init.kaiming_uniform_(self.weight, a=5 ** 0.5)

    def forward(self, x: torch.Tensor, sp: spatial.SpatialShard | None = None) -> torch.Tensor:
        k = self.weight.shape[-1]
        x, w = x.to(self.dtype), self.weight.to(self.dtype)
        if sp is None or k == 1:
            y = F.conv2d(x, w, padding=k // 2)
        else:  # the neighbours' rows stand in for the row padding
            y = F.conv2d(spatial.halo_rows(x, sp, k // 2), w, padding=(0, k // 2))
        return y + self.bias.to(self.dtype).reshape(1, -1, 1, 1)


class ConvBlock(nn.Module):
    def __init__(self, cin: int, features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.norm0 = GroupNorm(min(8, cin), cin)
        self.conv0 = Conv(cin, features, 3, dtype)
        self.norm1 = GroupNorm(8, features)
        self.conv1 = Conv(features, features, 3, dtype)
        self.proj = Conv(cin, features, 1, dtype) if cin != features else None

    def forward(self, x: torch.Tensor, sp: spatial.SpatialShard | None = None) -> torch.Tensor:
        h = self.conv0(F.silu(self.norm0(x, sp)), sp)
        h = self.conv1(F.silu(self.norm1(h, sp)), sp)
        if self.proj is not None:
            x = self.proj(x)
        return x + h


class CellposeNet(nn.Module):
    """U-Net with a global style vector; flagship model of the framework."""

    def __init__(self, base_features: Sequence[int] = (32, 64, 128, 256),
                 out_channels: int = 3, dtype: torch.dtype = torch.bfloat16,
                 in_channels: int = 2):
        super().__init__()
        feats = tuple(base_features)
        self.feats = feats
        self.dtype = dtype
        self.stem = Conv(in_channels, feats[0], 3, dtype)
        self.down = nn.ModuleList()
        cin = feats[0]
        for f in feats:
            self.down.append(nn.ModuleList([ConvBlock(cin, f, dtype), ConvBlock(f, f, dtype)]))
            cin = f
        self.up_reduce = nn.ModuleList()
        self.style = nn.ModuleList()
        self.up = nn.ModuleList()
        for i in range(len(feats) - 1):
            self.up_reduce.append(Conv(feats[i + 1], feats[i], 3, dtype))
            self.style.append(nn.Linear(feats[-1], feats[i]))
            self.up.append(nn.ModuleList([ConvBlock(feats[i], feats[i], dtype),
                                          ConvBlock(feats[i], feats[i], dtype)]))
        self.head = Conv(feats[0], out_channels, 1, torch.float32)

    def forward(self, x: torch.Tensor, style_only: bool = False,
                sp: spatial.SpatialShard | None = None) -> torch.Tensor:
        """(B, H, W, C_in) f32 -> (B, H, W, 3) f32, or the (B, bottleneck)
        style vector with ``style_only=True``. With ``sp``, ``x`` is this
        rank's block of ``sp.own`` rows and so is the output (the style is
        the whole image's)."""
        if sp is not None:
            if x.shape[1] != sp.own:
                raise ValueError(f"rank {sp.rank}'s block has {x.shape[1]} rows, its shard "
                                 f"{sp.own}")
            sp.check_unit(2 ** (len(self.feats) - 1))
        h = x.permute(0, 3, 1, 2).to(self.dtype)
        h = self.stem(h, sp)
        skips = []
        for i, (a, b) in enumerate(self.down):
            h = b(a(h, sp), sp)
            skips.append(h)
            if i < len(self.feats) - 1:
                h = F.avg_pool2d(h, 2, 2)

        if sp is None:
            style = h.to(torch.float32).mean(dim=(2, 3))
        else:
            style = spatial.all_reduce(h.to(torch.float32).sum(dim=(2, 3)), sp.group)
            style = style / sp.global_count(h.shape[2] * h.shape[3])
        norm = torch.linalg.vector_norm(style, dim=-1, keepdim=True)
        style = style / torch.clamp_min(norm, 1e-6)
        if style_only:
            return style

        for i in reversed(range(len(self.feats) - 1)):
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            h = self.up_reduce[i](h, sp)
            dense = self.style[i]
            s = F.linear(style.to(self.dtype), dense.weight.to(self.dtype)) \
                + dense.bias.to(self.dtype)
            h = h + skips[i] + s[:, :, None, None].to(self.dtype)
            a, b = self.up[i]
            h = b(a(h, sp), sp)

        out = self.head(h.to(torch.float32))
        return out.permute(0, 2, 3, 1).to(torch.float32)


@torch.no_grad()
def forward_f64(model: CellposeNet, x: torch.Tensor) -> torch.Tensor:
    """The forward of ``model``'s parameters in f64 throughout, written
    out apart from :meth:`CellposeNet.forward` (GroupNorm by mean and
    variance), a reference for the rounding of the f32 and bf16 forwards:
    (B, H, W, C_in) -> (B, H, W, 3) f64."""

    def conv(m, h):
        k = m.weight.shape[-1]
        return F.conv2d(h, m.weight.double(), m.bias.double(), padding=k // 2)

    def norm(m, h):
        B, C, H, W = h.shape
        g = h.reshape(B, m.num_groups, -1)
        var = g.var(dim=-1, unbiased=False, keepdim=True)
        g = (g - g.mean(dim=-1, keepdim=True)) / torch.sqrt(var + m.eps)
        return g.reshape(B, C, H, W) * m.weight.double().view(1, C, 1, 1) \
            + m.bias.double().view(1, C, 1, 1)

    def block(b, h):
        y = conv(b.conv1, F.silu(norm(b.norm1, conv(b.conv0, F.silu(norm(b.norm0, h))))))
        return (h if b.proj is None else conv(b.proj, h)) + y

    h = conv(model.stem, x.permute(0, 3, 1, 2).double())
    skips = []
    for i, (a, b) in enumerate(model.down):
        h = block(b, block(a, h))
        skips.append(h)
        if i < len(model.feats) - 1:
            h = F.avg_pool2d(h, 2, 2)
    style = h.mean(dim=(2, 3))
    style = style / torch.clamp_min(torch.linalg.vector_norm(style, dim=-1, keepdim=True), 1e-6)
    for i in reversed(range(len(model.feats) - 1)):
        h = conv(model.up_reduce[i], F.interpolate(h, scale_factor=2, mode="nearest"))
        s = F.linear(style, model.style[i].weight.double(), model.style[i].bias.double())
        a, b = model.up[i]
        h = block(b, block(a, h + skips[i] + s[:, :, None, None]))
    return conv(model.head, h).permute(0, 2, 3, 1)


# Flax's lecun_normal: a standard normal truncated at +-2, scaled so that
# the truncated draw has variance 1 / fan_in (the constant is the std of
# the standard normal truncated at +-2)
_TRUNC_STD = 0.87962566103423978


def _lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> None:
    fan_in = weight[0].numel()  # conv (O, I, kh, kw): kh kw I; Linear (out, in): in
    std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
        weight.mul_(std)


def init_params(seed: int, in_channels: int = 2, size: int = 64,
                device: str | torch.device | None = None, **model_kwargs) -> CellposeNet:
    """A :class:`CellposeNet` initialised as Flax initialises the JAX model
    (``aliby_tpu/models/unet.py`` ``init_params``): conv and dense kernels
    from ``lecun_normal``, zero biases, GroupNorm scale 1 and bias 0.

    The draws come from a ``torch.Generator`` seeded by ``seed`` on the CPU,
    so the bits depend on the seed alone (not the device) and the caller's
    global RNG is untouched; they are not Flax's draws (the distribution
    is). ``size`` is accepted for the JAX signature: parameter shapes do not
    depend on it."""
    del size
    dev = resolve_device(device)
    with torch.random.fork_rng(devices=[]):  # the constructors' own draws
        model = CellposeNet(in_channels=in_channels, **model_kwargs)
    gen = torch.Generator().manual_seed(int(seed))
    for module in model.modules():
        if isinstance(module, (Conv, nn.Linear)):
            _lecun_normal_(module.weight, gen)
            nn.init.zeros_(module.bias)
        elif isinstance(module, GroupNorm):
            nn.init.ones_(module.weight)
            nn.init.zeros_(module.bias)
    return model.to(dev)
