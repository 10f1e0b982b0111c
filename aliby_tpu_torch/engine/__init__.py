"""The fused per-timepoint step and its pipeline front end."""
