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
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn


class GroupNorm(nn.Module):
    """Flax ``nn.GroupNorm(dtype=float32)``: f32 statistics and output."""

    def __init__(self, num_groups: int, channels: int, eps: float = 1e-6):
        super().__init__()
        self.num_groups = num_groups
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        B, C, H, W = x.shape
        g = x.reshape(B, self.num_groups, -1)
        mu = g.mean(dim=-1)
        mu2 = (g * g).mean(dim=-1)
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

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        k = self.weight.shape[-1]
        y = F.conv2d(x.to(self.dtype), self.weight.to(self.dtype), padding=k // 2)
        return y + self.bias.to(self.dtype).reshape(1, -1, 1, 1)


class ConvBlock(nn.Module):
    def __init__(self, cin: int, features: int, dtype: torch.dtype = torch.bfloat16):
        super().__init__()
        self.norm0 = GroupNorm(min(8, cin), cin)
        self.conv0 = Conv(cin, features, 3, dtype)
        self.norm1 = GroupNorm(8, features)
        self.conv1 = Conv(features, features, 3, dtype)
        self.proj = Conv(cin, features, 1, dtype) if cin != features else None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.conv0(F.silu(self.norm0(x)))
        h = self.conv1(F.silu(self.norm1(h)))
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

    def forward(self, x: torch.Tensor, style_only: bool = False) -> torch.Tensor:
        """(B, H, W, C_in) f32 -> (B, H, W, 3) f32, or the (B, bottleneck)
        style vector with ``style_only=True``."""
        h = x.permute(0, 3, 1, 2).to(self.dtype)
        h = self.stem(h)
        skips = []
        for i, (a, b) in enumerate(self.down):
            h = b(a(h))
            skips.append(h)
            if i < len(self.feats) - 1:
                h = F.avg_pool2d(h, 2, 2)

        style = h.to(torch.float32).mean(dim=(2, 3))
        norm = torch.linalg.vector_norm(style, dim=-1, keepdim=True)
        style = style / torch.clamp_min(norm, 1e-6)
        if style_only:
            return style

        for i in reversed(range(len(self.feats) - 1)):
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            h = self.up_reduce[i](h)
            dense = self.style[i]
            s = F.linear(style.to(self.dtype), dense.weight.to(self.dtype)) \
                + dense.bias.to(self.dtype)
            h = h + skips[i] + s[:, :, None, None].to(self.dtype)
            a, b = self.up[i]
            h = b(a(h))

        out = self.head(h.to(torch.float32))
        return out.permute(0, 2, 3, 1).to(torch.float32)
