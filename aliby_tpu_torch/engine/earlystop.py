"""Early-stop policy: abandon clogged positions (counterpart of
``aliby_tpu/engine/earlystop.py``).

The reference *declares* these thresholds (``aliby/global_settings.py:4-10``)
but nothing consumes them in the shipped tree (SURVEY §5.3 "declared, not
wired"). Here the policy is live: opt in with ``pipeline["earlystop"] =
{...overrides...}`` (or ``True`` for the defaults) and the run loop stops a
position once the clogged-tile fraction stays above threshold.

A tile counts as clogged when its object count exceeds
``thresh_trap_ncells`` or its foreground area fraction exceeds
``thresh_trap_area``; a position stops when more than
``thresh_pos_clogged`` of its tiles are clogged for ``ntps_to_eval``
consecutive timepoints after ``min_tp``.
"""

from __future__ import annotations

import logging

import numpy as np

from aliby_tpu_torch.utils.settings import earlystop as DEFAULTS

logger = logging.getLogger("aliby_tpu_torch")


class EarlyStopMonitor:
    def __init__(self, config: dict | bool | None):
        cfg = dict(DEFAULTS)
        if isinstance(config, dict):
            cfg.update(config)
        self.cfg = cfg
        self.enabled = bool(config)
        self._consecutive = 0

    def _tile_clogged(self, mask: np.ndarray) -> bool:
        mask = np.asarray(mask)
        if mask.ndim == 3:
            mask = mask.max(axis=0)
        n_cells = len(np.unique(mask)) - 1
        area_frac = float((mask > 0).mean())
        return (
            n_cells > self.cfg["thresh_trap_ncells"]
            or area_frac > self.cfg["thresh_trap_area"]
        )

    def should_stop(self, tp: int, segment_results: list) -> bool:
        """Feed the tp's segment outputs; True when the position is done."""
        if not self.enabled or tp < self.cfg["min_tp"]:
            return False
        masks = []
        for result in segment_results:
            tiles = result["masks"] if isinstance(result, dict) else result
            masks.extend(tiles)
        if not masks:
            return False
        clogged = np.mean([self._tile_clogged(m) for m in masks])
        if clogged > self.cfg["thresh_pos_clogged"]:
            self._consecutive += 1
        else:
            self._consecutive = 0
        if self._consecutive >= self.cfg["ntps_to_eval"]:
            logger.warning(
                "Early stop at tp %d: %.0f%% of tiles clogged for %d tps",
                tp, 100 * clogged, self._consecutive,
            )
            return True
        return False
