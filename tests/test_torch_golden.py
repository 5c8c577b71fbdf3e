"""Golden-value regression of the port against the reference's pinned
outputs, on the CPU (the plain-torch kernels).

The port's counterpart of tests/test_golden.py (reference:
tests/units.rs), with the same tolerances:
  * per-atom SASA of example.cif (2622 atoms, vdW radii, probe 1.4, n=100)
    vs the stored golden array, eps=25 A^2/atom;
  * protein totals for example.cif, bad_seqadv_1A06.pdb, 151L_H3.pdb
    (ProtOr radii via the options pipeline), eps=1500;
  * 960-point totals including the polar/non-polar split.
"""

import numpy as np
import pytest
pytest.importorskip("torch")
import torch

from rustsasa_tpu_torch import (
    Level,
    SASAOptions,
    calculate_sasa_internal,
    get_vdw_radius,
    read_structure,
)
from rustsasa_tpu_torch.levels import aggregate

GOLDEN = np.load("tests/data/golden_example_atom_sasa.npy")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def example(example_cif):
    return read_structure(str(example_cif))


def test_internal_vdw_golden(example):
    """reference: tests/units.rs:17-43 (calculate_sasa_internal, vdW radii)."""
    t = example.atoms
    order = list(example.iter_hierarchy_atom_indices())
    radii = np.array(
        [get_vdw_radius(t.element[i]) for i in order], dtype=np.float32
    )
    sasa = calculate_sasa_internal(
        t.coords[order], radii, group_ids=t.serial[order], probe_radius=1.4,
        n_points=100, device="cpu",
    )
    assert sasa.shape == GOLDEN.shape
    np.testing.assert_allclose(sasa, GOLDEN, atol=25.0)
    # Tight check: the vast majority of atoms agree to well under the
    # tolerance (f32 boundary flips move single test points).
    assert float(np.abs(sasa - GOLDEN).mean()) < 1.5


def test_protein_chain_levels(example):
    """reference: tests/units.rs:45-65."""
    protein = SASAOptions.protein_level().with_device("cpu").process(
        example).protein
    assert protein.global_total == pytest.approx(20268.004, abs=1500.0)

    chains = SASAOptions.chain_level().with_device("cpu").process(
        example).chains
    assert len(chains) == 1
    assert chains[0].name == "A"

    atoms = SASAOptions.atom_level().with_device("cpu").process(example).atoms
    assert atoms.shape == GOLDEN.shape  # no H / HETATM in example.cif


def test_bad_seqadv_pdb(reference_data_dir):
    """reference: tests/units.rs:67-78 (malformed SEQADV header tolerated)."""
    s = read_structure(str(reference_data_dir / "pdbs" / "bad_seqadv_1A06.pdb"))
    protein = SASAOptions.protein_level().with_device("cpu").process(
        s).protein
    assert protein.global_total == pytest.approx(14466.709, abs=1500.0)


def test_atypical_spacegroup_pdb(reference_data_dir):
    """reference: tests/units.rs:80-91."""
    s = read_structure(str(reference_data_dir / "pdbs" / "151L_H3.pdb"))
    protein = SASAOptions.protein_level().with_device("cpu").process(
        s).protein
    assert protein.global_total == pytest.approx(9558.812, abs=1500.0)


def test_high_res_960_points(example):
    """reference: tests/units.rs:93-129.  The plain-torch count takes
    ~35 s a call at 960 points on one CPU thread, so the protein and
    chain levels aggregate one atom-level `process`: the three selections
    of example.cif are checked to be the same atoms."""
    result, sel = SASAOptions.atom_level().with_n_points(960).with_device(
        "cpu").process_with_selection(example)
    sels = {level: SASAOptions(level=level).build_selection(example)
            for level in (Level.PROTEIN, Level.CHAIN)}
    for other in sels.values():
        for field in ("coords", "radii", "group_ids"):
            np.testing.assert_array_equal(getattr(other, field),
                                          getattr(sel, field))
    protein = aggregate(sels[Level.PROTEIN], result.atoms,
                        Level.PROTEIN).protein
    assert protein.global_total == pytest.approx(20131.227, abs=1500.0)
    assert protein.polar_total == pytest.approx(4279.8906, abs=1500.0)
    assert protein.non_polar_total == pytest.approx(15999.43, abs=1500.0)

    chains = aggregate(sels[Level.CHAIN], result.atoms, Level.CHAIN).chains
    assert chains[0].value == pytest.approx(20131.227, abs=1500.0)
    assert chains[0].name == "A"


def test_residue_level_shape(example):
    residues = SASAOptions(level=Level.RESIDUE, device="cpu").process(
        example).residues
    assert len(residues) > 100
    total = sum(r.value for r in residues)
    protein = SASAOptions.protein_level().with_device("cpu").process(
        example).protein
    assert total == pytest.approx(protein.global_total, rel=1e-3)
    # is_polar only for the reference's small polar set
    polar_names = {r.name for r in residues if r.is_polar}
    assert polar_names <= {"SER", "THR", "CYS", "ASN", "GLN", "TYR"}
