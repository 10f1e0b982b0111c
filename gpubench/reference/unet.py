"""Plain PyTorch forwards of the two segmentation networks, written apart
from the program: the flagship Cellpose-class U-Net read straight from its
Flax msgpack checkpoint, and Cellpose's published CPnet graph.

Both run NCHW in float32 with TF32 off unless a caller asks for one of the
lower precisions that the output check uses as its control:

- ``"tf32"``: the same forward with cuDNN's and cuBLAS's TF32 on (the
  control of an f32 configuration; it changes nothing on the CPU);
- ``"fp8"``: every convolution's input and weight rounded to float8 e4m3
  with one scale a tensor (amax / 448), then convolved in f32 (the control
  of a bf16 configuration);
- ``"bf16"``: every convolution's input and weight rounded to bfloat16.

The flagship U-Net (``aliby_tpu/models/unet.py``'s Flax model, the
architecture the bundled checkpoint was trained with): a 3x3 stem, four
levels of two residual blocks (GroupNorm eps 1e-6 with min(8, C) groups on
the block input and 8 on the middle, SiLU, 3x3 convs, a 1x1 projection
where the width changes) with 2x2 average pooling between levels, a style
vector (the bottleneck's spatial mean, L2-normalised, floor 1e-6), then per
decoder level from the deepest: 2x nearest upsampling, a 3x3 reduce conv,
plus the skip, plus a Dense of the style, two residual blocks; a 1x1 head
to (flow_y, flow_x, cell logit).
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import msgpack
import numpy as np
import torch
import torch.nn as tnn
import torch.nn.functional as F

PRECISIONS = ("f32", "tf32", "bf16", "fp8")
FP8_MAX = 448.0  # the largest finite float8 e4m3fn


def read_msgpack_tree(path: str | Path) -> dict:
    """A Flax msgpack checkpoint -> nested dicts of float32 numpy arrays
    (ext type 1 holds ``(shape, dtype name, bytes)``)."""

    def ext(code, data):
        if code != 1:
            raise ValueError(f"unexpected msgpack ext type {code}")
        shape, dtype, buf = msgpack.unpackb(data, raw=False)
        return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape).astype(np.float32)

    tree = msgpack.unpackb(Path(path).read_bytes(), ext_hook=ext, raw=False,
                           strict_map_key=False)
    return tree.get("params", tree)


def _round_to(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "bf16":
        return x.to(torch.bfloat16).to(torch.float32)
    if precision == "fp8":
        scale = x.abs().amax().clamp_min(1e-30) / FP8_MAX
        return (x / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x


@contextlib.contextmanager
def tf32(on: bool):
    """cuDNN's and cuBLAS's TF32 switches held at ``on`` inside."""
    saved = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = saved


def conv2d(x, weight, bias, precision: str):
    k = weight.shape[-1]
    return F.conv2d(_round_to(x, precision), _round_to(weight, precision), bias,
                    padding=k // 2)


class FlagshipUNet:
    """The flagship U-Net's forward over a parameter tree of numpy arrays."""

    def __init__(self, tree: dict, device="cpu"):
        def to_t(a, conv: bool):
            t = torch.from_numpy(np.ascontiguousarray(a))
            if conv and t.dim() == 4:  # HWIO -> OIHW
                t = t.permute(3, 2, 0, 1)
            elif conv and t.dim() == 2:  # Dense (in, out) -> (out, in)
                t = t.t()
            return t.contiguous().to(device)

        self.p = {}
        for top, sub in tree.items():
            for name, leaf in sub.items():
                if isinstance(leaf, dict):
                    for inner, arr in leaf.items():
                        self.p[(top, name, inner)] = to_t(arr, inner == "kernel")
                else:
                    self.p[(top, name)] = to_t(leaf, name == "kernel")
        self.levels = 1 + max(int(k[0][4]) for k in self.p if k[0].startswith("down"))

    def _conv(self, h, *path, precision):
        return conv2d(h, self.p[(*path, "kernel")], self.p[(*path, "bias")], precision)

    def _norm(self, h, *path, groups: int):
        B, C, H, W = h.shape
        g = h.reshape(B, groups, -1)
        mu = g.mean(dim=-1, keepdim=True)
        var = g.var(dim=-1, unbiased=False, keepdim=True)
        g = (g - mu) / torch.sqrt(var + 1e-6)
        return (g.reshape(B, C, H, W) * self.p[(*path, "scale")].reshape(1, C, 1, 1)
                + self.p[(*path, "bias")].reshape(1, C, 1, 1))

    def _block(self, h, name, precision):
        cin = h.shape[1]
        y = self._conv(F.silu(self._norm(h, name, "GroupNorm_0", groups=min(8, cin))),
                       name, "Conv_0", precision=precision)
        y = self._conv(F.silu(self._norm(y, name, "GroupNorm_1", groups=8)),
                       name, "Conv_1", precision=precision)
        if (name, "proj", "kernel") in self.p:
            h = self._conv(h, name, "proj", precision=precision)
        return h + y

    @torch.no_grad()
    def __call__(self, x: torch.Tensor, precision: str = "f32") -> torch.Tensor:
        """(B, 2, H, W) normalised images -> (B, 3, H, W) f32."""
        with tf32(precision == "tf32"):
            h = self._conv(x.float(), "stem", precision=precision)
            skips = []
            for i in range(self.levels):
                h = self._block(self._block(h, f"down{i}a", precision), f"down{i}b", precision)
                skips.append(h)
                if i < self.levels - 1:
                    h = F.avg_pool2d(h, 2, 2)
            style = h.mean(dim=(2, 3))
            style = style / torch.linalg.vector_norm(style, dim=-1, keepdim=True).clamp_min(1e-6)
            for i in reversed(range(self.levels - 1)):
                h = F.interpolate(h, scale_factor=2, mode="nearest")
                h = self._conv(h, f"up{i}_reduce", precision=precision)
                w, b = self.p[(f"style{i}", "kernel")], self.p[(f"style{i}", "bias")]
                s = F.linear(_round_to(style, precision), _round_to(w, precision), b)
                h = h + skips[i] + s[:, :, None, None]
                h = self._block(self._block(h, f"up{i}a", precision), f"up{i}b", precision)
            return self._conv(h, "head", precision=precision)


# --- Cellpose's CPnet, as published (MouseLand/cellpose resnet_torch) ------


def _batchconv(cin, cout, sz):
    return tnn.Sequential(tnn.BatchNorm2d(cin, eps=1e-5), tnn.ReLU(inplace=True),
                          tnn.Conv2d(cin, cout, sz, padding=sz // 2))


def _batchconv0(cin, cout, sz):
    return tnn.Sequential(tnn.BatchNorm2d(cin, eps=1e-5), tnn.Conv2d(cin, cout, sz, padding=sz // 2))


class _ResDown(tnn.Module):
    def __init__(self, cin, cout, sz):
        super().__init__()
        self.proj = _batchconv0(cin, cout, 1)
        self.conv = tnn.Sequential()
        for t in range(4):
            self.conv.add_module(f"conv_{t}", _batchconv(cin if t == 0 else cout, cout, sz))

    def forward(self, x):
        x = self.proj(x) + self.conv[1](self.conv[0](x))
        return x + self.conv[3](self.conv[2](x))


class _BatchConvStyle(tnn.Module):
    def __init__(self, cin, cout, cstyle, sz):
        super().__init__()
        self.conv = _batchconv(cin, cout, sz)
        self.full = tnn.Linear(cstyle, cin)

    def forward(self, style, x, y=None):
        if y is not None:
            x = x + y
        feat = self.full(style)
        return self.conv(x + feat.unsqueeze(-1).unsqueeze(-1))


class _ResUp(tnn.Module):
    def __init__(self, cin, cout, cstyle, sz):
        super().__init__()
        self.proj = _batchconv0(cin, cout, 1)
        self.conv = tnn.Sequential()
        self.conv.add_module("conv_0", _batchconv(cin, cout, sz))
        for t in (1, 2, 3):
            self.conv.add_module(f"conv_{t}", _BatchConvStyle(cout, cout, cstyle, sz))

    def forward(self, x, y, style):
        x = self.proj(x) + self.conv[1](style, self.conv[0](x), y=y)
        return x + self.conv[3](style, self.conv[2](style, x))


class _Downsample(tnn.Module):
    def __init__(self, nbase, sz):
        super().__init__()
        self.down = tnn.Sequential()
        for n in range(len(nbase) - 1):
            self.down.add_module(f"res_down_{n}", _ResDown(nbase[n], nbase[n + 1], sz))
        self.maxpool = tnn.MaxPool2d(2, stride=2)

    def forward(self, x):
        xd = []
        for n in range(len(self.down)):
            y = self.maxpool(xd[n - 1]) if n > 0 else x
            xd.append(self.down[n](y))
        return xd


class _Upsample(tnn.Module):
    def __init__(self, nbase, sz):
        super().__init__()
        self.upsampling = tnn.Upsample(scale_factor=2, mode="nearest")
        self.up = tnn.Sequential()
        for n in range(1, len(nbase)):
            self.up.add_module(f"res_up_{n - 1}", _ResUp(nbase[n], nbase[n - 1], nbase[-1], sz))

    def forward(self, style, xd):
        x = self.up[-1](xd[-1], xd[-1], style)
        for n in range(len(self.up) - 2, -1, -1):
            x = self.upsampling(x)
            x = self.up[n](x, xd[n], style)
        return x


class CPnet(tnn.Module):
    """Cellpose's CPnet (Stringer et al. 2021): ``nbase`` includes the input
    channels (cyto: (2, 32, 64, 128, 256)), 3 outputs, 3x3 kernels."""

    def __init__(self, nbase=(2, 32, 64, 128, 256), nout=3, sz=3):
        super().__init__()
        self.downsample = _Downsample(nbase, sz)
        nbaseup = list(nbase[1:]) + [nbase[-1]]
        self.upsample = _Upsample(nbaseup, sz)
        self.output = _batchconv(nbaseup[0], nout, 1)

    def forward(self, x):
        xd = self.downsample(x)
        flat = F.avg_pool2d(xd[-1], kernel_size=(xd[-1].shape[-2], xd[-1].shape[-1])).flatten(1)
        style = flat / torch.sum(flat ** 2, dim=1, keepdim=True) ** 0.5
        return self.output(self.upsample(style, xd)), style


class CPnetForward:
    """A :class:`CPnet` with a state dict, run at a chosen precision."""

    def __init__(self, state_dict: dict, nbase, device="cpu"):
        self.model = CPnet(nbase=tuple(nbase))
        self.model.load_state_dict(state_dict, strict=True)
        self.model.to(device).eval()
        self._convs = [m for m in self.model.modules() if isinstance(m, tnn.Conv2d)]

    @torch.no_grad()
    def __call__(self, x: torch.Tensor, precision: str = "f32") -> torch.Tensor:
        """(B, 2, H, W) normalised images -> (B, 3, H, W) f32."""
        hooks = []
        if precision in ("bf16", "fp8"):
            saved = [c.weight.data for c in self._convs]
            for c in self._convs:
                c.weight.data = _round_to(c.weight.data, precision)
                hooks.append(c.register_forward_pre_hook(
                    lambda _m, args: (_round_to(args[0], precision),)))
        try:
            with tf32(precision == "tf32"):
                return self.model(x.float())[0]
        finally:
            for h in hooks:
                h.remove()
            if hooks:
                for c, w in zip(self._convs, saved):
                    c.weight.data = w


def normalize_percentile(img: np.ndarray) -> np.ndarray:
    """One plane mapped by its 1st and 99th percentiles (NumPy's linear
    interpolation): (x - lo) / max(hi - lo, 1e-6)."""
    lo, hi = np.percentile(img.astype(np.float64), [1.0, 99.0])
    return ((img - lo) / max(hi - lo, 1e-6)).astype(np.float32)


def network_input(plane: np.ndarray) -> torch.Tensor:
    """A raw (H, W) plane -> the (1, 2, H, W) input of either network: the
    normalised plane and a second channel of zeros (Cellpose's 'no second
    channel')."""
    x = normalize_percentile(plane)
    return torch.from_numpy(np.stack([x, np.zeros_like(x)]))[None]
