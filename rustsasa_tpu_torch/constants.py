"""Shared constants for the TPU-native SASA engine.

Parity notes reference the upstream RustSASA implementation
(reference: src/utils/consts.rs).
"""

import math

# Default solvent probe radius in Angstroms (reference: options.rs:500).
DEFAULT_PROBE_RADIUS = 1.4

# Default number of Shrake-Rupley test points (reference: options.rs:501).
DEFAULT_N_POINTS = 100

# Golden-section spiral constants (reference: consts.rs:18-19).
# The reference uses a truncated f32 literal 1.618034 rather than the exact
# golden ratio; we match it so sphere points agree bit-for-bit in f32.
GOLDEN_RATIO = 1.618034
ANGLE_INCREMENT = 2.0 * math.pi * GOLDEN_RATIO

# Polar residue set used for the is_polar flag and the protein-level
# polar/non-polar split (reference: consts.rs:7-16).  Intentionally small:
# the reference only counts S/T/C/N/Q/Y sidechain-polar residues.
POLAR_AMINO_ACIDS = frozenset({"SER", "THR", "CYS", "ASN", "GLN", "TYR"})
