"""Per-label reductions, the feature bank and the feature-tree executor."""
