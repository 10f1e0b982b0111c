"""A CPnet ``state_dict`` in Cellpose's published key layout, made from the
seed on the card: convolution and dense weights and biases uniform in
+-1/sqrt(fan_in) (PyTorch's default initialisation), BatchNorm running
means N(0, 0.3) and variances U(0.5, 1.5) with scale 1 and shift 0, the
head scaled by ``HEAD_GAIN`` and shifted so that, on a probe field
rendered from the same seed, the flows average 0 and the cell logit
averages ``HEAD_LIFT`` (random flows then still give objects).
"""

from __future__ import annotations

import numpy as np
import torch

from gpubench.reference.unet import CPnet, network_input, tf32

HEAD_GAIN = 20.0
HEAD_LIFT = 1.75
PROBE = (256, 40)  # the probe field's size and cells


def cpnet_state_dict(seed: int, nbase, device, field: dict) -> dict:
    """Tensors on the CPU, made on ``device`` in three draws; the heads are
    centred on a probe field of the configuration's objects (``field``)."""
    from gpubench.plate import render_field

    template = CPnet(nbase=tuple(nbase)).state_dict()
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    def weight_of(k):
        return k[:-len("bias")] + "weight" if k.endswith("bias") else k

    # convolutions and dense layers (their weights have 2 or more dimensions)
    dense = [k for k in template if k.endswith(("weight", "bias"))
             and template[weight_of(k)].dim() >= 2]
    sizes = [template[k].numel() for k in dense]
    uniform = torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1
    means = [k for k in template if k.endswith("running_mean")]
    n_bn = sum(template[k].numel() for k in means)
    bn_mean = torch.randn(n_bn, generator=gen, device=device) * 0.3
    bn_var = torch.rand(n_bn, generator=gen, device=device) + 0.5
    sd = {}
    for k, part in zip(dense, torch.split(uniform, sizes)):
        w = template[weight_of(k)]
        bound = 1.0 / np.sqrt(int(np.prod(w.shape[1:])))
        sd[k] = (part * bound).reshape(template[k].shape)
    off = 0
    for k in means:
        n = template[k].numel()
        sd[k] = bn_mean[off:off + n].clone()
        sd[k[:-len("running_mean")] + "running_var"] = bn_var[off:off + n].clone()
        off += n
    for k, t in template.items():
        if k.endswith("num_batches_tracked"):
            sd[k] = torch.zeros((), dtype=torch.int64)
        elif k not in sd:  # BatchNorm scale and shift
            sd[k] = torch.ones_like(t) if k.endswith("weight") else torch.zeros_like(t)
    sd = {k: v.to("cpu", torch.float32) if v.is_floating_point() else v for k, v in sd.items()}
    sd["output.2.weight"] *= HEAD_GAIN
    sd["output.2.bias"] *= HEAD_GAIN
    model = CPnet(nbase=tuple(nbase))
    model.load_state_dict(sd)
    model.to(device).eval()
    probe = render_field(seed, -1 % (1 << 32), PROBE[0], dict(field, cells=PROBE[1]))[3]  # AGP
    with torch.no_grad(), tf32(False):
        out = model(network_input(probe).to(device))[0]
    shift = -out.mean(dim=(0, 2, 3)).cpu()
    shift[2] += HEAD_LIFT
    sd["output.2.bias"] = sd["output.2.bias"] + shift
    return sd
