"""The benchmark's plain reference against the program, on the CPU at
small sizes: both networks' forwards, the mask reconstruction (label for
label) and the feature oracle, and the oracle on an object's crop against
the whole image."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from gpubench import plate
from gpubench.reference import dynamics, unet
from gpubench.reference import features as O
from gpubench.weights import cpnet_state_dict

ROOT = Path(__file__).resolve().parents[2]
FIELD = json.loads((ROOT / "gpubench/configs/cellposenet-jump1080.json").read_text())["field"]
torch.set_num_threads(4)


def rel(a, b) -> float:
    a, b = a.double(), b.double()
    return float(((a - b) ** 2).mean().sqrt() / (b ** 2).mean().sqrt())


@pytest.fixture(scope="module")
def field():
    return plate.render_field(7, 0, 128, dict(FIELD, cells=12))  # (5, 128, 128), STAINS order


@pytest.fixture(scope="module")
def flagship():
    cfg = json.loads((ROOT / "gpubench/configs/cellposenet-jump1080.json").read_text())
    return unet.FlagshipUNet(unet.read_msgpack_tree(ROOT / cfg["network"]["weights"]))


def test_flagship_forward_matches_the_program_in_f32(field, flagship):
    from aliby_tpu_torch.models.unet import CellposeNet
    from aliby_tpu_torch.models.weights import (BUNDLED_WEIGHTS, params_from_flax,
                                                read_flax_checkpoint)

    net = CellposeNet(dtype=torch.float32)
    net.load_state_dict(params_from_flax(read_flax_checkpoint(BUNDLED_WEIGHTS)))
    x = unet.network_input(field[3])
    with torch.no_grad():
        got = net.eval()(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
    assert rel(got, flagship(x)) < 1e-5


def test_flagship_lower_precisions_move_the_output(field, flagship):
    x = unet.network_input(field[0])
    want = flagship(x)
    assert rel(flagship(x, "bf16"), want) < 0.02
    assert rel(flagship(x, "fp8"), want) > 3 * rel(flagship(x, "bf16"), want)


def test_cpnet_forward_matches_the_program_in_f32(field):
    from aliby_tpu_torch.models.cpnet import CPnet

    nbase = (2, 32, 64, 128, 256)
    sd = cpnet_state_dict(11, nbase, "cpu", FIELD)
    ref = unet.CPnetForward(sd, nbase)
    prog = CPnet(nbase=nbase)
    prog.load_state_dict(sd)
    x = unet.network_input(field[3])
    with torch.no_grad():
        got = prog.eval()(x.permute(0, 2, 3, 1))[0].permute(0, 3, 1, 2)
    assert rel(got, ref(x)) < 1e-5


def _program_output(img):
    from aliby_tpu_torch.models.segment import CellposeTorch, _normalize_percentile

    eng = CellposeTorch(device="cpu")
    x = torch.from_numpy(np.stack([img, np.zeros_like(img)], -1)[None].astype(np.float32))
    with torch.no_grad():
        return eng._forward(_normalize_percentile(x))[0].permute(2, 0, 1)


@pytest.mark.parametrize("n_iter,qc", [(2, 0.4), (8, 0.4), (2, None)])
def test_mask_reconstruction_matches_the_program_label_for_label(field, n_iter, qc):
    from aliby_tpu_torch.models.flows import _div, masks_from_flows

    pred = _program_output(field[0].astype(np.float32))
    flows = _div(pred[None, :2], 5.0)
    with torch.no_grad():
        want = masks_from_flows(flows, pred[None, 2], n_iter=n_iter, max_labels=256,
                                min_size=15, flow_threshold=qc)[0].numpy()
    got, undecided = dynamics.masks_from_output(pred, n_iter=n_iter, flow_threshold=qc)
    assert want.max() >= 5
    np.testing.assert_array_equal(got, want)
    assert not undecided.any()


@pytest.mark.parametrize("n_iter", [2, 8])
def test_the_reconstruction_in_bfloat16_moves_labels(n_iter):
    """The control's reconstruction: at 512^2 rows and columns past 256 are
    not integers in bfloat16."""
    pred = _program_output(plate.render_field(9, 0, 512, dict(FIELD, cells=60))[3].astype(np.float32))
    want, _ = dynamics.masks_from_output(pred, n_iter=n_iter)
    lower, _ = dynamics.masks_from_output(pred, n_iter=n_iter, dtype=torch.bfloat16)
    assert want.max() >= 20
    assert (dynamics.canonical(lower) != dynamics.canonical(want)).mean() > 1e-4


def test_canonical_labels_ignore_the_numbering():
    a = np.array([[0, 2, 2], [1, 1, 0], [3, 0, 0]])
    b = np.array([[0, 5, 5], [7, 7, 0], [9, 0, 0]])
    np.testing.assert_array_equal(dynamics.canonical(a), dynamics.canonical(b))
    assert dynamics.canonical(a).max() == 3


def test_feature_oracle_agrees_with_the_program_on_isolated_objects(field):
    from aliby_tpu_torch.extract import features as F
    from aliby_tpu_torch.extract import texture as T

    labels = dynamics.masks_from_output(_program_output(field[0].astype(np.float32)), 2)[0]
    img = field[3].astype(np.float32)
    tl, ti = torch.from_numpy(labels)[None], torch.from_numpy(img)[None]
    L = int(labels.max())
    ours = {**F.intensity(tl, ti, L), **F.sizeshape(tl, L), **T.texture(tl, ti, L)}
    checked = 0
    for lab in range(1, L + 1):
        mask = labels == lab
        want = {**O.o_intensity(mask, img), **O.o_sizeshape(mask), **O.o_texture(mask, img)}
        for name in ("Intensity_IntegratedIntensity", "Intensity_MeanIntensity",
                     "Intensity_MaxIntensity", "AreaShape_Area", "AreaShape_Perimeter",
                     "Texture_Contrast_3_00_256"):
            got = float(ours[name][0, lab - 1])
            assert got == pytest.approx(want[name], rel=1e-3, abs=1e-6), (lab, name)
            checked += 1
    assert checked >= 30


def test_an_objects_crop_gives_the_whole_images_values(field):
    from gpubench import check

    labels = dynamics.masks_from_output(_program_output(field[3].astype(np.float32)), 2)[0]
    lab = int(np.bincount(labels.ravel())[1:].argmax()) + 1
    stack = plate.as_read(field)
    check._STACKS.clear()
    check._STACKS[0] = stack
    columns = {"1/max/texture/Texture_Contrast_3_00_256": ("texture", "Texture_Contrast_3_00_256", (1,)),
               "1/max/intensity/Location_CenterMassIntensity_X":
                   ("intensity", "Location_CenterMassIntensity_X", (1,)),
               "None/None/sizeshape/AreaShape_SpatialMoment_1_2":
                   ("sizeshape", "AreaShape_SpatialMoment_1_2", ()),
               "1/max/radial_distribution/RadialDistribution_FracAtD_2of4":
                   ("radial_distribution", "RadialDistribution_FracAtD_2of4", (1,)),
               "1/max/zernike/Zernike_4_2": ("zernike", "Zernike_4_2", (1,)),
               "(1, 4)/None/max/pearson": ("coloc", "pearson", (1, 4))}
    (job,) = check.object_jobs(0, labels, [lab], columns, True)
    got = check._object_features(job)
    mask = labels == lab
    img = stack[1].astype(np.float64)
    want = {"1/max/texture/Texture_Contrast_3_00_256": O.o_texture(mask, img)[
                "Texture_Contrast_3_00_256"],
            "1/max/intensity/Location_CenterMassIntensity_X": O.o_intensity(mask, img)[
                "Location_CenterMassIntensity_X"],
            "None/None/sizeshape/AreaShape_SpatialMoment_1_2": O.o_sizeshape(mask)[
                "AreaShape_SpatialMoment_1_2"],
            "1/max/radial_distribution/RadialDistribution_FracAtD_2of4":
                O.o_radial_distribution(mask, img)["RadialDistribution_FracAtD_2of4"],
            "1/max/zernike/Zernike_4_2": O.o_zernike(mask)[(4, 2)],
            "(1, 4)/None/max/pearson": O.o_pearson(mask, img, stack[4].astype(np.float64))[
                "pearson"]}
    for c, v in want.items():
        assert got[c] == pytest.approx(v, rel=1e-9, abs=1e-12), c
