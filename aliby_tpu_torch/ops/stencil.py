"""Stencil iteration for the segmentation dynamics (counterpart of
``aliby_tpu/ops/pallas_stencil.py``).

- :func:`successor_prop`: ``key <- key[succ]`` for ``n_prop`` rounds. The
  plain version keeps the reference's blocked early exit (stop when a block
  of ``block`` rounds leaves the key unchanged); the kernel computes all
  ``n_prop`` rounds by successor-map doubling, which gives the same bits
  (``kernels/csrc/stencil.cu`` says why).
- :func:`diffuse_heat`: cellpose's centre-source heat diffusion with
  absorbing same-label boundaries (the ``masks_to_flows`` interior loop).

Each wrapper runs its plain PyTorch version for CPU tensors and launches
the CUDA kernel (``kernels/csrc/stencil.cu``) for CUDA tensors; there is no
fallback between the two. On the card neither wrapper synchronises with
the host. ``<wrapper>.launches`` counts kernel launches. A launch runs on
its tensors' card, whatever the calling thread's current device.
"""

from __future__ import annotations

import torch

from aliby_tpu_torch.kernels import _build

OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)]
PROP_HALO = 6  # largest early-exit block (the reference's); the kernel runs every round
DIFFUSE_HALO = 9  # most rounds one diffuse_heat launch runs (stencil.cu kDHalo)


def diffuse_launches(n_iter: int) -> int:
    """Launches of one ``diffuse_heat`` call on the card: the flags, then
    rounds of up to ``DIFFUSE_HALO`` (12 at 96); none for n_iter <= 0."""
    return 1 + -(-n_iter // DIFFUSE_HALO) if n_iter > 0 else 0


def shift(x: torch.Tensor, dy: int, dx: int, fill=0) -> torch.Tensor:
    """out[..., y, x] = x[..., y + dy, x + dx], ``fill`` outside the grid
    (the JAX package's pad-and-slice ``_shift``)."""
    H, W = x.shape[-2:]
    p = torch.nn.functional.pad(x, (1, 1, 1, 1), value=fill)
    return p[..., 1 + dy : H + 1 + dy, 1 + dx : W + 1 + dx]


def _check(x: torch.Tensor, dtype: torch.dtype, name: str) -> None:
    if x.dim() != 3:
        raise ValueError(f"{name} must be (B, H, W), got {tuple(x.shape)}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")


# ---------------------------------------------------------------------------
# successor-map propagation
# ---------------------------------------------------------------------------


def successor_prop_plain(dcode: torch.Tensor, key: torch.Tensor, n_prop: int = 96,
                         block: int = 6) -> torch.Tensor:
    """Plain PyTorch version of :func:`successor_prop`."""
    sels = []
    k = 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            if (dy, dx) != (0, 0):
                sels.append((dcode == k, dy, dx))
            k += 1

    def one_round(key):
        new = key
        for sel, dy, dx in sels:
            new = torch.where(sel, shift(key, dy, dx), new)
        return new

    for _ in range(n_prop % block):
        key = one_round(key)
    for _ in range(n_prop // block):
        new = key
        for _ in range(block):
            new = one_round(new)
        changed = bool((new != key).any())
        key = new
        if not changed:
            break
    return key


def successor_prop(dcode: torch.Tensor, key0: torch.Tensor, n_prop: int = 96,
                   block: int = 6) -> torch.Tensor:
    """(B, H, W) int32 dcode in [0, 9) (4 = stay) + (B, H, W) int32 keys ->
    keys after ``n_prop`` rounds of ``key <- key[succ]``. On the card:
    ``n_prop.bit_length()`` launches (7 at 96), whatever ``block``."""
    _check(dcode, torch.int32, "dcode")
    _check(key0, torch.int32, "key0")
    if dcode.shape != key0.shape or dcode.device != key0.device:
        raise ValueError("dcode and key0 must share shape and device")
    if not 1 <= block <= PROP_HALO:
        raise ValueError(f"block must be in [1, {PROP_HALO}], got {block}")
    if n_prop < 0:
        raise ValueError(f"n_prop must be >= 0, got {n_prop}")
    if key0.device.type == "cpu":
        return successor_prop_plain(dcode, key0, n_prop, block)
    if key0.device.type != "cuda":
        raise ValueError(f"unsupported device {key0.device}")
    B, H, W = key0.shape
    if H * W >= 2**31 or B > 65535:
        raise ValueError(f"the kernel takes H * W < 2^31 and B <= 65535, got {(B, H, W)}")
    key0 = key0.contiguous()
    if n_prop == 0 or key0.numel() == 0:
        return key0.clone()
    lib = _build.load("stencil")
    dcode = dcode.contiguous()
    out = torch.empty_like(key0)
    n = n_prop.bit_length()
    # two powers of the successor map and their composition so far
    maps = torch.empty(3 * key0.numel(), dtype=torch.int32, device=key0.device) if n > 1 else None
    with _build.on_device(key0):
        _build.check(
            lib.successor_prop(dcode.data_ptr(), key0.data_ptr(), out.data_ptr(),
                               maps.data_ptr() if n > 1 else None, B, H, W, n_prop,
                               _build.stream_of(key0)),
            "successor_prop",
        )
    _build.count(successor_prop, n)
    return out


successor_prop.launches = 0


# ---------------------------------------------------------------------------
# same-label heat diffusion
# ---------------------------------------------------------------------------


def diffuse_heat_plain(labels: torch.Tensor, source: torch.Tensor,
                       n_iter: int = 96) -> torch.Tensor:
    """Plain PyTorch version of :func:`diffuse_heat` (the reference's order
    of operations; the division by 9 is a true division on every device)."""
    fg = labels > 0
    same = [(shift(labels, dy, dx, -1) == labels).to(torch.float32) for dy, dx in OFFSETS]
    nine = torch.full((), 9.0, dtype=torch.float32, device=labels.device)
    zero = torch.zeros((), dtype=torch.float32, device=labels.device)
    T = torch.zeros(labels.shape, dtype=torch.float32, device=labels.device)
    for _ in range(n_iter):
        T = T + source
        acc = T
        for (dy, dx), m in zip(OFFSETS, same):
            acc = acc + shift(T, dy, dx) * m
        T = torch.where(fg, torch.div(acc, nine), zero)
    return T


def diffuse_heat(labels: torch.Tensor, source: torch.Tensor, n_iter: int = 96) -> torch.Tensor:
    """(B, H, W) int32 labels + (B, H, W) f32 centre sources -> (B, H, W) f32
    heat after ``n_iter`` rounds of masked 3x3 diffusion. On the card:
    :func:`diffuse_launches` launches (12 at 96)."""
    _check(labels, torch.int32, "labels")
    _check(source, torch.float32, "source")
    if labels.shape != source.shape or labels.device != source.device:
        raise ValueError("labels and source must share shape and device")
    if labels.device.type == "cpu":
        return diffuse_heat_plain(labels, source, n_iter)
    if labels.device.type != "cuda":
        raise ValueError(f"unsupported device {labels.device}")
    B, H, W = labels.shape
    if H * W >= 2**31 or B > 65535:
        raise ValueError(f"the kernel takes H * W < 2^31 and B <= 65535, got {(B, H, W)}")
    if n_iter <= 0 or labels.numel() == 0:
        return torch.zeros(labels.shape, dtype=torch.float32, device=labels.device)
    lib = _build.load("stencil")
    labels = labels.contiguous()
    source = source.contiguous()
    out = torch.empty(labels.shape, dtype=torch.float32, device=labels.device)
    tmp = torch.empty_like(out)
    flags = torch.empty(labels.shape, dtype=torch.int16, device=labels.device)
    with _build.on_device(labels):
        _build.check(
            lib.diffuse_heat(labels.data_ptr(), source.data_ptr(), out.data_ptr(),
                             tmp.data_ptr(), flags.data_ptr(), B, H, W, n_iter,
                             _build.stream_of(labels)),
            "diffuse_heat",
        )
    _build.count(diffuse_heat, diffuse_launches(n_iter))
    return out


diffuse_heat.launches = 0
