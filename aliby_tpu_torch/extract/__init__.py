"""Per-label reductions."""
