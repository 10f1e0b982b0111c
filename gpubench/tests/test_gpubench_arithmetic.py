"""The benchmark's own arithmetic on the CPU: the networks' FLOPs against
``FlopCounterMode``, the kernels' least bytes and operations against the
kernel table that ``chip_smoke.py`` printed (``PERF.md``), and the device
idle share of a synthetic trace with overlapping streams."""

import json
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from gpubench import flops, roofline, trace
from gpubench.reference import unet

CONFIGS = Path(__file__).resolve().parents[1] / "configs"


def config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def counted(fn, x) -> int:
    with FlopCounterMode(display=False) as fc:
        fn(x)
    return fc.get_total_flops()


def test_cellposenet_flops_match_the_flop_counter_at_256():
    cfg = config("cellposenet-jump1080")
    torch.manual_seed(0)
    model = unet.FlagshipUNet(_random_flax_tree(cfg["network"]["base_features"]))
    x = torch.rand(1, 2, 256, 256)
    assert flops.network_flops(cfg, 256, 256) == counted(model, x)


def test_cpnet_flops_match_the_flop_counter_at_256():
    cfg = config("cpnet-cyto-jump1080")
    model = unet.CPnet(nbase=tuple(cfg["network"]["nbase"])).eval()
    x = torch.rand(1, 2, 256, 256)
    with torch.no_grad():
        assert flops.network_flops(cfg, 256, 256) == counted(model, x)


@pytest.mark.parametrize("name,tflop", [("cellposenet-jump1080", 0.70),
                                        ("cpnet-cyto-jump1080", 0.72)])
def test_a_forward_at_1080(name, tflop):
    assert flops.network_flops(config(name), 1080, 1080) / 1e12 == pytest.approx(tflop, abs=0.01)


def _random_flax_tree(features, cin=2, cout=3):
    """A parameter tree in the flagship checkpoint's layout (HWIO kernels)."""
    g = torch.Generator().manual_seed(0)

    def conv(i, o, k):
        return {"kernel": torch.randn(k, k, i, o, generator=g).numpy() * 0.05,
                "bias": torch.zeros(o).numpy()}

    def norm(c):
        return {"scale": torch.ones(c).numpy(), "bias": torch.zeros(c).numpy()}

    def block(i, o):
        b = {"GroupNorm_0": norm(i), "Conv_0": conv(i, o, 3), "GroupNorm_1": norm(o),
             "Conv_1": conv(o, o, 3)}
        if i != o:
            b["proj"] = conv(i, o, 1)
        return b

    tree, c = {"stem": conv(cin, features[0], 3)}, features[0]
    for i, f in enumerate(features):
        tree[f"down{i}a"], tree[f"down{i}b"] = block(c, f), block(f, f)
        c = f
    for i in range(len(features) - 1):
        tree[f"up{i}_reduce"] = conv(features[i + 1], features[i], 3)
        tree[f"style{i}"] = {"kernel": torch.randn(features[-1], features[i], generator=g).numpy(),
                             "bias": torch.zeros(features[i]).numpy()}
        tree[f"up{i}a"], tree[f"up{i}b"] = block(features[i], features[i]), \
            block(features[i], features[i])
    tree["head"] = conv(features[0], cout, 1)
    return tree


# kernel table rows (PERF.md, "TPU kernels of the repo"): shape -> bound ms
@pytest.mark.parametrize("shape,bound_ms", [((16, 256, 256), 0.0038), ((2, 1080, 1080), 0.0084)])
def test_successor_prop_least_time(shape, bound_ms):
    d = torch.zeros(shape, dtype=torch.int32)
    assert roofline.successor_prop(d, d, 96) * 1e3 == pytest.approx(bound_ms, abs=5e-5)


@pytest.mark.parametrize("B,N,K,bins,bound_ms", [(16, 65536, 17, 65, 0.0226),
                                                 (2, 1166400, 6, 66049, 0.0204)])
def test_binned_sum_least_time(B, N, K, bins, bound_ms):
    v = torch.zeros(B, N, K)
    b = torch.zeros(B, N, dtype=torch.int32)
    assert roofline.binned_sum_cols_batched(v, b, bins) * 1e3 == pytest.approx(bound_ms, abs=5e-5)


@pytest.mark.parametrize("B,N,K,bins,bound_ms", [(16, 65536, 2, 65, 0.0038),
                                                 (8, 1166400, 2, 257, 0.0334)])
def test_binned_minmax_least_time(B, N, K, bins, bound_ms):
    v = torch.zeros(B, N, K)
    b = torch.zeros(B, N, dtype=torch.int32)
    assert roofline.binned_minmax_batched(v, b, bins) * 1e3 == pytest.approx(bound_ms, abs=5e-5)


@pytest.mark.parametrize("B,N,L,K,bound_ms", [(16, 65536, 64, 3, 0.0050),
                                               (8, 1166400, 256, 2, 0.0334)])
def test_table_lookup_least_time(B, N, L, K, bound_ms):
    t = torch.zeros(B, L, K)
    b = torch.zeros(B, N, dtype=torch.int32)
    assert roofline.table_lookup_batched(t, b) * 1e3 == pytest.approx(bound_ms, abs=5e-5)


def test_diffuse_heat_counts_the_least_instructions():
    labels = torch.zeros(1, 6, 6, dtype=torch.int32)
    labels[0, 1:4, 1:4] = 1  # a 3x3 object: 9 pixels, 40 same-label neighbour pairs
    source = torch.zeros(1, 6, 6)
    source[0, 2, 2] = 1.0
    assert roofline.diffuse_counts(labels, source) == (9, 40, 1)
    ops = 96 * (40 + 1 + 9 * roofline.DIFFUSE_DIV_INSTR)
    want = max(12 * 36 / roofline.PEAK_BYTES_S, ops / roofline.PEAK_F32_INSTR_S)
    assert roofline.diffuse_heat(labels, source, 96) == pytest.approx(want)


# --- the idle share, from a synthetic trace --------------------------------


class _Event:
    def __init__(self, dev, start, end, name="k", act="kernel", tid=1, corr=0, linked=0, card=0):
        self._d = (dev, start, end, name, act, tid, corr, linked, card)

    def device_type(self):
        from torch.autograd import DeviceType

        return DeviceType.CUDA if self._d[0] == "cuda" else DeviceType.CPU

    def start_ns(self):
        return self._d[1]

    def end_ns(self):
        return self._d[2]

    def name(self):
        return self._d[3]

    def activity_type(self):
        return self._d[4]

    def start_thread_id(self):
        return self._d[5]

    def correlation_id(self):
        return self._d[6]

    def linked_correlation_id(self):
        return self._d[7]

    def device_index(self):
        return self._d[8]


def test_idle_share_takes_the_union_of_overlapping_streams():
    events = [
        _Event("cpu", 0, 1000, trace.PASS, "user_annotation", corr=1),
        _Event("cpu", 100, 400, trace.SEG, "user_annotation", corr=2),
        _Event("cpu", 150, 160, trace.KERNEL + "successor_prop", "user_annotation", corr=3),
        _Event("cpu", 110, 111, "cudaLaunchKernel", "cuda_runtime", corr=10, linked=2),
        _Event("cpu", 120, 121, "cudaLaunchKernel", "cuda_runtime", corr=11, linked=2),
        _Event("cpu", 500, 501, "cudaLaunchKernel", "cuda_runtime", corr=12, linked=1),
        # two streams of card 0 overlap in 200..300: the union is 100..400
        _Event("cuda", 100, 300, "conv", corr=10),
        _Event("cuda", 200, 400, "conv", corr=11),
        _Event("cuda", 600, 700, "Memcpy HtoD", "gpu_memcpy", corr=12),
        # launched through ctypes inside the kernel's range: no aten op, only
        # its runtime call
        _Event("cpu", 155, 156, "cuLaunchKernel", "cuda_driver", corr=13),
        _Event("cuda", 300, 350, "succ", corr=13),
        # the pass's range mirrored on the device's timeline: no operation
        _Event("cuda", 0, 1000, trace.PASS, "gpu_user_annotation", corr=1),
        # card 1 busy 0..500
        _Event("cuda", 0, 500, "tree", corr=12, card=1),
    ]
    prof = SimpleNamespace(profiler=SimpleNamespace(
        kineto_results=SimpleNamespace(events=lambda: events)))
    out = trace.reduce_events(prof)
    assert out["window_s"] == pytest.approx(1e-6)
    assert out["busy_s"][0] == pytest.approx(400e-9)  # 300 of kernels + 100 of copy
    assert out["busy_s"][1] == pytest.approx(500e-9)
    assert out["kernels"] == 4  # the copy is not a kernel
    assert out["range_ms"][trace.SEG] == pytest.approx(450e-6)  # launched inside the range
    assert out["range_ms"][trace.KERNEL + "successor_prop"] == pytest.approx(50e-6)
    ctx = {"trace": out, "devices": ["cuda:0", "cuda:1"]}
    read = _reader("device.idle_pct")
    assert read(ctx) == pytest.approx(100 * (1 - (400 + 500) / 2 / 1000))
    longest = out["idle_gaps"][0]
    assert longest[0] == "card 1: no host op open" and longest[1] == pytest.approx(500e-9)


def _reader(metric):
    from gpubench.bench import reader

    return reader(metric)
