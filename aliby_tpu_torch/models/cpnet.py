"""The Cellpose CPnet graph (counterpart of ``aliby_tpu/models/cpnet.py``),
so that published torch Cellpose checkpoints (cyto, cyto2, cyto3, nuclei)
run in the port.

The module's parameter and buffer names are the published ``state_dict``
keys (``downsample.down.res_down_{n}.conv.conv_{k}.{0,2}``,
``upsample.up.res_up_{n}.conv.conv_{k}.full``, ``output.*``), so a
checkpoint loads with ``load_state_dict(strict=True)`` once its
``mkldnn*``/``diam*`` entries are dropped. The forward follows the JAX
package's ``CPnetFlax``: residual double-conv blocks of (BatchNorm in
inference mode, eps 1e-5 -> ReLU -> conv), 2x2 max-pool between levels, a
style vector from the full-image mean of the bottleneck, L2-normalised
(eps 1e-12), added through a Dense layer into each up block's convs,
nearest 2x upsampling, the deepest up block fed the bottleneck twice, and a
(BN -> ReLU -> 1x1 conv) head. BatchNorm computes in f32 and returns the
compute dtype; convolutions and the style Dense compute in ``dtype`` (f32
by default, bf16 on request) with the bias added in ``dtype``; the head is
f32. The public forward takes and returns NHWC like the Flax model.

On the card an f32 forward runs with cuDNN's TF32 off, so that it is true
f32 as JAX's is. The flag is the process's, not a thread's: the first f32
forward to start clears it and the last to end restores the caller's value
(:func:`tf32_off`), so forwards on several threads (``run_positions``'
workers, the server's connections) all run in f32.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from aliby_tpu_torch.device import HeldFlags

CYTO_NBASE = (2, 32, 64, 128, 256)

# cuDNN's TF32 off while any thread is inside ``with tf32_off():``; the value
# that the first thread in found is restored when the last one leaves
tf32_off = HeldFlags(torch.backends.cudnn, allow_tf32=False)


def _batchconv(cin: int, cout: int, sz: int) -> nn.Sequential:
    """torch Cellpose ``batchconv``: [0] BN, [1] ReLU, [2] conv."""
    return nn.Sequential(nn.BatchNorm2d(cin, eps=1e-5), nn.ReLU(),
                         nn.Conv2d(cin, cout, sz, padding=sz // 2))


def _batchconv0(cin: int, cout: int, sz: int) -> nn.Sequential:
    """torch Cellpose ``batchconv0``: [0] BN, [1] conv (no ReLU)."""
    return nn.Sequential(nn.BatchNorm2d(cin, eps=1e-5), nn.Conv2d(cin, cout, sz, padding=sz // 2))


def _bn(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """Inference BatchNorm as ``TorchBatchNorm``: f32, returned in x's dtype."""
    inv = torch.rsqrt(bn.running_var.to(torch.float32) + bn.eps) * bn.weight
    out = (x.to(torch.float32) - bn.running_mean.reshape(1, -1, 1, 1)) * inv.reshape(1, -1, 1, 1)
    return (out + bn.bias.reshape(1, -1, 1, 1)).to(x.dtype)


def _conv(conv: nn.Conv2d, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    k = conv.weight.shape[-1]
    y = F.conv2d(x.to(dtype), conv.weight.to(dtype), padding=k // 2)
    return y + conv.bias.to(dtype).reshape(1, -1, 1, 1)


def _apply(seq: nn.Sequential, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A ``batchconv`` (3 members) or ``batchconv0`` (2 members)."""
    h = _bn(seq[0], x)
    if len(seq) == 3:
        h = torch.relu(h)
    return _conv(seq[-1], h, dtype)


class _BatchConvStyle(nn.Module):
    def __init__(self, cin: int, cout: int, cstyle: int, sz: int):
        super().__init__()
        self.conv = _batchconv(cin, cout, sz)
        self.full = nn.Linear(cstyle, cin)

    def run(self, style, x, dtype, y=None):
        if y is not None:
            x = x + y
        feat = F.linear(style.to(dtype), self.full.weight.to(dtype)) + self.full.bias.to(dtype)
        return _apply(self.conv, x + feat[:, :, None, None].to(x.dtype), dtype)


class _ResDown(nn.Module):
    def __init__(self, cin: int, cout: int, sz: int):
        super().__init__()
        self.proj = _batchconv0(cin, cout, 1)
        self.conv = nn.Sequential()
        for t in range(4):
            self.conv.add_module(f"conv_{t}", _batchconv(cin if t == 0 else cout, cout, sz))

    def run(self, x, dtype):
        c = self.conv
        x = _apply(self.proj, x, dtype) + _apply(c[1], _apply(c[0], x, dtype), dtype)
        return x + _apply(c[3], _apply(c[2], x, dtype), dtype)


class _ResUp(nn.Module):
    def __init__(self, cin: int, cout: int, cstyle: int, sz: int):
        super().__init__()
        self.proj = _batchconv0(cin, cout, 1)
        self.conv = nn.Sequential()
        self.conv.add_module("conv_0", _batchconv(cin, cout, sz))
        for t in (1, 2, 3):
            self.conv.add_module(f"conv_{t}", _BatchConvStyle(cout, cout, cstyle, sz))

    def run(self, x, y, style, dtype):
        c = self.conv
        x = _apply(self.proj, x, dtype) + c[1].run(style, _apply(c[0], x, dtype), dtype, y=y)
        return x + c[3].run(style, c[2].run(style, x, dtype), dtype)


class _Down(nn.Module):
    def __init__(self, nbase: Sequence[int], sz: int):
        super().__init__()
        self.down = nn.Sequential()
        for n in range(len(nbase) - 1):
            self.down.add_module(f"res_down_{n}", _ResDown(nbase[n], nbase[n + 1], sz))


class _Up(nn.Module):
    def __init__(self, nbaseup: Sequence[int], cstyle: int, sz: int):
        super().__init__()
        self.up = nn.Sequential()
        for n in range(1, len(nbaseup)):
            self.up.add_module(f"res_up_{n - 1}",
                               _ResUp(nbaseup[n], nbaseup[n - 1], cstyle, sz))


class CPnet(nn.Module):
    """The CPnet graph. ``nbase`` includes the input channel count (cyto:
    ``(2, 32, 64, 128, 256)``); ``nout=3`` (flow_y, flow_x, cell logit)."""

    def __init__(self, nbase: Sequence[int] = CYTO_NBASE, nout: int = 3, sz: int = 3,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.nbase = tuple(int(n) for n in nbase)
        self.dtype = dtype
        nbaseup = list(self.nbase[1:]) + [self.nbase[-1]]
        self.downsample = _Down(self.nbase, sz)
        self.upsample = _Up(nbaseup, self.nbase[-1], sz)
        self.output = _batchconv(nbaseup[0], nout, 1)

    def _run(self, x: torch.Tensor, style_only: bool):
        dtype = self.dtype
        h = x.permute(0, 3, 1, 2).to(dtype)
        xd = []
        for n, block in enumerate(self.downsample.down):
            if n > 0:
                h = F.max_pool2d(xd[n - 1], 2, 2)
            xd.append(block.run(h, dtype))
        style = xd[-1].to(torch.float32).mean(dim=(2, 3))
        norm = torch.sqrt((style * style).sum(dim=1, keepdim=True))
        style = style / torch.clamp_min(norm, 1e-12)
        if style_only:
            return style
        up = self.upsample.up
        h = up[-1].run(xd[-1], xd[-1], style, dtype)
        for n in range(len(up) - 2, -1, -1):
            h = F.interpolate(h, scale_factor=2, mode="nearest")
            h = up[n].run(h, xd[n], style, dtype)
        out = _apply(self.output, h.to(torch.float32), torch.float32)
        return out.permute(0, 2, 3, 1).to(torch.float32), style

    def forward(self, x: torch.Tensor, style_only: bool = False):
        """(B, H, W, nbase[0]) -> ((B, H, W, nout) f32, (B, nbase[-1]) style),
        or the style alone with ``style_only=True``."""
        if x.is_cuda and self.dtype == torch.float32:
            with tf32_off():
                return self._run(x, style_only)
        return self._run(x, style_only)


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _strip(sd: dict) -> dict:
    for key in ("state_dict", "model_state_dict"):
        if isinstance(sd, dict) and key in sd:
            sd = sd[key]
    return {k: v for k, v in sd.items() if not k.startswith(("mkldnn", "diam"))}


def load_cellpose_checkpoint(path, nbase: Sequence[int] = CYTO_NBASE, nout: int = 3,
                             sz: int = 3, dtype: torch.dtype = torch.float32) -> CPnet:
    """A torch Cellpose checkpoint file -> :class:`CPnet` (eval mode, on the
    CPU). Published checkpoints are raw ``state_dict`` pickles; newer ones
    nest it under ``"state_dict"`` or ``"model_state_dict"``. The file is
    read with ``torch.load(weights_only=True)``: one that needs arbitrary
    pickled objects is refused."""
    if not Path(path).is_file():
        raise FileNotFoundError(f"Cellpose checkpoint not found: {path}")
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # pickle.UnpicklingError, or not a torch file at all
        raise ValueError(
            f"{path} is not a torch Cellpose checkpoint that loads with "
            f"torch.load(weights_only=True) (a state_dict of tensors): {type(e).__name__}: "
            f"{str(e).splitlines()[0] if str(e) else ''}") from e
    model = CPnet(nbase=nbase, nout=nout, sz=sz, dtype=dtype)
    model.load_state_dict(_strip(sd), strict=True)
    return model.eval()


def _bn_keys(prefix: str, p: dict) -> dict:
    return {
        f"{prefix}.weight": p["scale"], f"{prefix}.bias": p["bias"],
        f"{prefix}.running_mean": p["mean"], f"{prefix}.running_var": p["var"],
        f"{prefix}.num_batches_tracked": np.zeros((), np.int64),
    }


def _batchconv_keys(prefix: str, p: dict, relu: bool = True) -> dict:
    conv = 2 if relu else 1
    return {
        **_bn_keys(f"{prefix}.0", p["bn"]),
        f"{prefix}.{conv}.weight": np.transpose(np.asarray(p["conv"]["kernel"]), (3, 2, 0, 1)),
        f"{prefix}.{conv}.bias": p["conv"]["bias"],
    }


def _style_keys(prefix: str, p: dict) -> dict:
    return {
        **_batchconv_keys(f"{prefix}.conv", p["conv"]),
        f"{prefix}.full.weight": np.transpose(np.asarray(p["full"]["kernel"])),
        f"{prefix}.full.bias": p["full"]["bias"],
    }


def cpnet_state_dict_from_flax(params: dict) -> dict[str, torch.Tensor]:
    """``CPnetFlax`` parameters (``{"params": ...}`` or the inner tree, as
    numpy arrays) -> the published torch ``state_dict``: the inverse of the
    JAX package's ``convert_torch_state_dict``."""
    p = params.get("params", params)
    n_levels = sum(1 for k in p if k.startswith("down_"))
    sd: dict = {}
    for n in range(n_levels):
        d, pre = p[f"down_{n}"], f"downsample.down.res_down_{n}"
        sd.update(_batchconv_keys(f"{pre}.proj", d["proj"], relu=False))
        for t in range(4):
            sd.update(_batchconv_keys(f"{pre}.conv.conv_{t}", d[f"conv_{t}"]))
    for n in range(n_levels):
        u, pre = p[f"up_{n}"], f"upsample.up.res_up_{n}"
        sd.update(_batchconv_keys(f"{pre}.proj", u["proj"], relu=False))
        sd.update(_batchconv_keys(f"{pre}.conv.conv_0", u["conv_0"]))
        for t in (1, 2, 3):
            sd.update(_style_keys(f"{pre}.conv.conv_{t}", u[f"conv_{t}"]))
    sd.update(_batchconv_keys("output", p["output"]))
    return {k: torch.tensor(np.asarray(v)) for k, v in sd.items()}

