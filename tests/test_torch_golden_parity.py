"""Golden parity gate through the port: ``aliby_tpu_torch``'s feature bank
against the independent numpy oracle (``tests/oracle_features.py``) on
``parity_common.make_fields()`` (three non-touching 128x128 fields,
max_labels 16), feature by feature under the bounds of
``tests/test_golden_parity.py``: 1e-3 relative error against the oracle
(the denominator clamped at 1e-3 of the feature's scale), with that file's
waivers where float32 or discretisation makes 1e-3 unattainable. The
bounds and the error measure are imported, not copied.
"""

import numpy as np
import pytest
import torch

import oracle_features as O
from aliby_tpu_torch.extract import features as F
from aliby_tpu_torch.extract import texture as T
from parity_common import MAX_LABELS, make_fields, max_errors
from test_golden_parity import _bound_for

torch.set_num_threads(1)


def port_pairs() -> dict:
    """{feature: (port values, oracle values)} aligned per object over the
    fields, as ``parity_common.compute_pairs`` builds them for the JAX bank."""
    pairs: dict = {}
    L = MAX_LABELS
    for labels, img, img2 in make_fields():
        tl = torch.from_numpy(labels)[None]
        ti, ti2 = torch.from_numpy(img)[None], torch.from_numpy(img2)[None]
        ours = {}
        ours.update(F.sizeshape(tl, L))
        ours.update(F.intensity(tl, ti, L))
        for fn in (F.pearson, F.manders_fold, F.rwc, F.costes):
            ours.update(fn(tl, ti, ti2, L))
        for fn in (T.texture, T.granularity, T.radial_zernikes, T.radial_distribution):
            ours.update(fn(tl, ti, L))
        ours.update(T.zernike(tl, L))
        ours = {k: v[0].numpy() for k, v in ours.items()}
        for lbl in range(1, labels.max() + 1):
            mask = labels == lbl
            oracle = {}
            oracle.update(O.o_sizeshape(mask))
            oracle.update(O.o_intensity(mask, img))
            for fn in (O.o_pearson, O.o_manders_fold, O.o_rwc, O.o_costes):
                oracle.update(fn(mask, img, img2))
            oracle.update(O.o_texture(mask, img))
            oracle.update(O.o_granularity(mask, img))
            for (n, m), v in O.o_zernike(mask).items():
                oracle[f"Zernike_{n}_{m}"] = v
            w = img.astype(np.float64) / max(float(img[mask].sum()), 1e-12)
            for (n, m), v in O.o_zernike(mask, weight=w).items():
                oracle[f"RadialZernike_{n}_{m}"] = v
            oracle.update(O.o_radial_distribution(mask, img))
            for name, val in oracle.items():
                if name in ours:
                    a, b = pairs.setdefault(name, ([], []))
                    a.append(float(ours[name][lbl - 1]))
                    b.append(float(val))
    return {k: (np.asarray(a), np.asarray(b)) for k, (a, b) in sorted(pairs.items())}


@pytest.fixture(scope="module")
def parity():
    pairs = port_pairs()
    return pairs, max_errors(pairs)


FAMILIES = ("AreaShape", "Intensity", "Location", "Texture", "Granularity", "Zernike",
            "RadialZernike", "RadialDistribution", "pearson", "manders_fold", "rwc", "slope",
            "costes")


def test_coverage(parity):
    pairs, _ = parity
    assert len(pairs) > 200
    assert {n.split("_")[0] for n in pairs} | set(pairs) >= set(FAMILIES)
    assert all(n.startswith(FAMILIES) for n in pairs)  # the family cases below cover every pair


@pytest.mark.parametrize("family", FAMILIES)
def test_every_feature_within_tolerance(parity, family):
    _, errs = parity
    failures = []
    mine = {n: e for n, e in errs.items() if n == family or n.split("_")[0] == family}
    assert mine, f"family {family} missing from the parity set"
    for name, e in mine.items():
        if e["n"] == 0:
            failures.append((name, "no finite samples"))
            continue
        kind, bound, _why = _bound_for(name)
        val = e["abs"] if kind == "abs" else e["rel"]
        if not np.isfinite(val) or val > bound:
            failures.append((name, f"{kind} err {val:.3e} > {bound:.1e}"))
    assert not failures, "\n".join(f"{n}: {m}" for n, m in failures)
