"""Global imaging settings (reference: ``aliby/global_settings.py:4-59``)."""

# Imaging physics of the trap (ALCATRAS) pipeline: 60x objective.
imaging_specifications = {
    "pixel_size": 0.236,  # microns per pixel
    "z_spacing": 0.6,     # microns between z sections
    "tile_size": 117,     # pixels per trap tile edge
}

# Early-stop thresholds for clogged traps/positions (declared for parity with
# the reference's policy surface; consumed by engine.earlystop).
earlystop = {
    "min_tp": 100,
    "thresh_pos_clogged": 0.4,
    "thresh_trap_ncells": 8,
    "thresh_trap_area": 0.9,
    "ntps_to_eval": 5,
}

# Candidate channel names treated as fluorescence (non-brightfield).
possible_imaging_channels = [
    "Citrine", "GFP", "GFPFast", "mCherry", "Flavin", "Citrine", "mKO2",
    "Cy5", "pHluorin405", "pHluorin488",
]

# Default function lists for legacy outline/fluorescence processing.
outline_functions = ["area", "eccentricity"]
fluorescence_functions = ["mean", "median", "std", "imBackground"]
