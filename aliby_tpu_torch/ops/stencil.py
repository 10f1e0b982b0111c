"""Stencil iteration for the segmentation dynamics (counterpart of
``aliby_tpu/ops/pallas_stencil.py``).

- :func:`successor_prop`: ``key <- key[succ]`` for ``n_prop`` rounds, with
  the blocked early exit (stop when a block of ``block`` rounds leaves the
  key unchanged; exact, since a fixed point stays fixed).
- :func:`diffuse_heat`: cellpose's centre-source heat diffusion with
  absorbing same-label boundaries (the ``masks_to_flows`` interior loop).

Each wrapper runs its plain PyTorch version for CPU tensors and launches
the CUDA kernel (``kernels/csrc/stencil.cu``) for CUDA tensors; there is no
fallback between the two. ``<wrapper>.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from aliby_tpu_torch.kernels import _build

OFFSETS = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)]
PROP_HALO = 6  # most rounds one successor_prop launch runs (stencil.cu kHalo)


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
    keys after ``n_prop`` rounds of ``key <- key[succ]``."""
    _check(dcode, torch.int32, "dcode")
    _check(key0, torch.int32, "key0")
    if dcode.shape != key0.shape or dcode.device != key0.device:
        raise ValueError("dcode and key0 must share shape and device")
    if not 1 <= block <= PROP_HALO:
        raise ValueError(f"block must be in [1, {PROP_HALO}], got {block}")
    if key0.device.type == "cpu":
        return successor_prop_plain(dcode, key0, n_prop, block)
    if key0.device.type != "cuda":
        raise ValueError(f"unsupported device {key0.device}")
    lib = _build.load("stencil")
    B, H, W = key0.shape
    dcode = dcode.contiguous()
    cur = key0.contiguous()
    bufs = [torch.empty_like(cur), torch.empty_like(cur)]
    changed = torch.zeros(1, dtype=torch.int32, device=cur.device)
    stream = _build.stream_of(cur)

    def launch(rounds: int) -> torch.Tensor:
        out = bufs[0] if cur.data_ptr() != bufs[0].data_ptr() else bufs[1]
        _build.check(
            lib.successor_prop_rounds(dcode.data_ptr(), cur.data_ptr(), out.data_ptr(),
                                      changed.data_ptr(), B, H, W, rounds, stream),
            "successor_prop",
        )
        successor_prop.launches += 1
        return out

    if n_prop % block:
        cur = launch(n_prop % block)
    for _ in range(n_prop // block):
        cur = launch(block)
        if not int(changed.item()):
            break
    return cur


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
    heat after ``n_iter`` rounds of masked 3x3 diffusion."""
    _check(labels, torch.int32, "labels")
    _check(source, torch.float32, "source")
    if labels.shape != source.shape or labels.device != source.device:
        raise ValueError("labels and source must share shape and device")
    if labels.device.type == "cpu":
        return diffuse_heat_plain(labels, source, n_iter)
    if labels.device.type != "cuda":
        raise ValueError(f"unsupported device {labels.device}")
    lib = _build.load("stencil")
    B, H, W = labels.shape
    labels = labels.contiguous()
    source = source.contiguous()
    stream = _build.stream_of(labels)
    mask = torch.empty(labels.shape, dtype=torch.int16, device=labels.device)
    _build.check(lib.diffuse_mask(labels.data_ptr(), mask.data_ptr(), B, H, W, stream),
                 "diffuse_heat mask")
    T = torch.zeros(labels.shape, dtype=torch.float32, device=labels.device)
    nxt = torch.empty_like(T)
    for _ in range(n_iter):
        _build.check(
            lib.diffuse_step(T.data_ptr(), source.data_ptr(), mask.data_ptr(),
                             nxt.data_ptr(), B, H, W, stream),
            "diffuse_heat",
        )
        diffuse_heat.launches += 1
        T, nxt = nxt, T
    return T


diffuse_heat.launches = 0
