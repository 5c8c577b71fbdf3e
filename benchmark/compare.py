"""How a run's answers are held against the plain reference's."""

from __future__ import annotations

import numpy as np


class Gaps:
    """Absolute gaps between answers and the reference's: their mean and
    the widest, over every compared value."""

    def __init__(self):
        self.total = 0.0
        self.count = 0
        self.widest = 0.0

    def add(self, have, want) -> None:
        gap = np.abs(np.asarray(have, np.float64) - want)
        self.total += float(gap.sum())
        self.count += gap.size
        self.widest = max(self.widest, float(gap.max(initial=0.0)))

    def checks(self, unit: str) -> dict:
        if not self.count:
            return {f"gap_mean_{unit}": float("inf"),
                    f"gap_max_{unit}": float("inf")}
        return {f"gap_mean_{unit}": self.total / self.count,
                f"gap_max_{unit}": self.widest}


def compare_residue_maps(answers, ref, per_pass, missing_name):
    """Checks of per-pass {key: residue values} against the reference's
    {key: residue values}: answers missing, and the residue gaps (A^2)."""
    missing = 0
    gaps = Gaps()
    for got, miss in answers:
        missing += miss
        if miss:
            continue
        for key, want in ref.items():
            have = got.get(key)
            if have is None or np.shape(have) != want.shape:
                missing += 1
                continue
            gaps.add(have, want)
    checks = {missing_name: float(missing), **gaps.checks("residue_A2")}
    return checks, per_pass * len(answers), missing
