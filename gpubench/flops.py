"""The networks' floating-point operations a forward, worked out from a
configuration's widths and the field shape alone.

Counts what ``torch.utils.flop_counter.FlopCounterMode`` counts: 2 x
multiply-accumulates of every convolution (bias and elementwise work not
counted) and of every dense layer; normalisation, activations, pooling and
upsampling are not counted. ``gpubench/tests`` pins both functions to
``FlopCounterMode`` on the reference networks.
"""

from __future__ import annotations


def _conv(cin: int, cout: int, k: int, h: int, w: int) -> int:
    return 2 * cin * cout * k * k * h * w


def cellposenet_flops(features, in_channels: int, out_channels: int, height: int,
                      width: int) -> int:
    """One image through the flagship U-Net (3x3 stem; two residual blocks
    a level, a 1x1 projection where the width changes; a 3x3 reduce conv
    and a style Dense a decoder level; a 1x1 head)."""
    f = list(features)
    levels = len(f)
    h, w = [height >> i for i in range(levels)], [width >> i for i in range(levels)]
    total = _conv(in_channels, f[0], 3, h[0], w[0])
    cin = f[0]
    for i, c in enumerate(f):
        for _ in range(2):
            total += _conv(cin, c, 3, h[i], w[i]) + _conv(c, c, 3, h[i], w[i])
            if cin != c:
                total += _conv(cin, c, 1, h[i], w[i])
            cin = c
    for i in range(levels - 1):
        total += _conv(f[i + 1], f[i], 3, h[i], w[i]) + 2 * f[-1] * f[i]
        total += 2 * (2 * _conv(f[i], f[i], 3, h[i], w[i]))
    return total + _conv(f[0], out_channels, 1, h[0], w[0])


def cpnet_flops(nbase, nout: int, sz: int, height: int, width: int) -> int:
    """One image through Cellpose's CPnet (``nbase`` with the input
    channels first): four convs and a 1x1 projection a down level, then up
    levels from the deepest with a projection, four convs and three style
    Dense layers each; a 1x1 head."""
    nb = list(nbase)
    levels = len(nb) - 1
    h, w = [height >> i for i in range(levels)], [width >> i for i in range(levels)]
    total = 0
    for n in range(levels):
        cin, cout = nb[n], nb[n + 1]
        total += _conv(cin, cout, 1, h[n], w[n]) + _conv(cin, cout, sz, h[n], w[n])
        total += 3 * _conv(cout, cout, sz, h[n], w[n])
    up = nb[1:] + [nb[-1]]
    for n in range(levels):
        cin, cout = up[n + 1], up[n]
        total += _conv(cin, cout, 1, h[n], w[n]) + _conv(cin, cout, sz, h[n], w[n])
        total += 3 * (_conv(cout, cout, sz, h[n], w[n]) + 2 * nb[-1] * cout)
    return total + _conv(up[0], nout, 1, h[0], w[0])


def network_flops(config: dict, height: int, width: int) -> int:
    """One forward of a configuration's network on one image."""
    net = config["network"]
    if net["kind"] == "cellposenet":
        return cellposenet_flops(net["base_features"], net["in_channels"],
                                 net["out_channels"], height, width)
    if net["kind"] == "cpnet":
        return cpnet_flops(net["nbase"], net["nout"], net["sz"], height, width)
    raise ValueError(f"unknown network kind {net['kind']!r}")


def field_flops(config: dict) -> int:
    """A field's forwards: one image a segmented object (nuclei, cell)."""
    size = config["field"]["size"]
    return len(config["segment"]) * network_flops(config, size, size)
