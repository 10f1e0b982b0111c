"""Each feature's tolerance against the per-object oracle, as the golden
parity gate of the feature bank states it (a frozen copy): a relative
error of 1e-3 against the oracle (the denominator floored at 1e-3 of the
feature's scale), with waivers where float32 or discretisation makes 1e-3
unattainable, and absolute bounds for features that are zero by
definition."""

import fnmatch

DEFAULT_REL = 1e-3
# feature-name pattern -> (kind, bound, reason)
WAIVERS = {
    "AreaShape_CentralMoment_0_1": ("abs", 2e-2, "identically zero"),
    "AreaShape_CentralMoment_1_0": ("abs", 2e-2, "identically zero"),
    "AreaShape_NormalizedMoment_0_1": ("abs", 1e-4, "identically zero"),
    "AreaShape_NormalizedMoment_1_0": ("abs", 1e-4, "identically zero"),
    "Zernike_1_1": ("abs", 1e-4, "identically ~zero (symmetric disk)"),
    "AreaShape_Zernike_1_1": ("abs", 1e-4, "identically ~zero (symmetric disk)"),
    "AreaShape_CentralMoment_0_3": ("rel", 2.5e-2, "float32 cancellation"),
    "AreaShape_CentralMoment_3_0": ("rel", 2.5e-2, "float32 cancellation"),
    "AreaShape_CentralMoment_2_1": ("rel", 2.5e-2, "float32 cancellation"),
    "AreaShape_CentralMoment_1_2": ("rel", 2.5e-2, "float32 cancellation"),
    "AreaShape_CentralMoment_2_3": ("rel", 2.5e-2, "float32 cancellation"),
    "AreaShape_CentralMoment_3_2": ("rel", 2.5e-2, "float32 cancellation"),
    "AreaShape_CentralMoment_3_3": ("rel", 2.5e-2, "float32 cancellation"),
    "AreaShape_NormalizedMoment_0_3": ("rel", 2.5e-2, "float32 cancellation"),
    "AreaShape_NormalizedMoment_3_0": ("rel", 2.5e-2, "float32 cancellation"),
    "AreaShape_NormalizedMoment_2_1": ("rel", 2.5e-2, "float32 cancellation"),
    "AreaShape_NormalizedMoment_1_2": ("rel", 2.5e-2, "float32 cancellation"),
    "AreaShape_NormalizedMoment_2_3": ("rel", 2.5e-2, "float32 cancellation"),
    "AreaShape_NormalizedMoment_3_2": ("rel", 2.5e-2, "float32 cancellation"),
    "AreaShape_NormalizedMoment_3_3": ("rel", 2.5e-2, "float32 cancellation"),
    "AreaShape_HuMoment_3": ("rel", 2.5e-2, "third-order composition"),
    "AreaShape_HuMoment_4": ("rel", 2.5e-2, "third-order composition"),
    "AreaShape_HuMoment_5": ("rel", 2.5e-2, "third-order composition"),
    "AreaShape_HuMoment_6": ("rel", 2.5e-2, "third-order composition"),
    "Granularity_*": ("rel", 5e-3, "iterated morphology float accumulation"),
    "Intensity_MassDisplacement": ("rel", 5e-3, "small-denominator metric"),
    "AreaShape_MinFeretDiameter": ("rel", 2e-3, "360-direction calipers"),
}


def bound_for(name: str) -> tuple[str, float]:
    """(kind, bound) of a feature: 'rel' or 'abs'."""
    for pat, (kind, bound, _why) in WAIVERS.items():
        if fnmatch.fnmatch(name, pat):
            return kind, bound
    return "rel", DEFAULT_REL
