"""The card a measurement ran on, as `nvidia-smi` names it.

Every time the port's benches and gate report stands beside the card's
name and power limit: a card set below its maximum power runs slower
under load.
"""

from __future__ import annotations

import subprocess


def nvidia_smi() -> tuple[str, str] | None:
    """(name, power limit) of the first card, from
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`;
    None where nvidia-smi is missing or fails."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.strip().splitlines()
    if not lines:
        return None
    name, _, limit = lines[0].rpartition(",")
    return name.strip(), limit.strip()
