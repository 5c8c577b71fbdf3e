"""CLI end-to-end tests of the port (reference: tests/integration.rs).

The port's counterpart of tests/test_cli.py: runs the port's CLI
in-process (main(argv)) with --device cpu (the plain-torch kernels) over
real inputs: every output format for single files and directories,
flags, and failure modes; plus the default device, which fails without
CUDA, and the single-file native route's bytes against the Python
route's (`batch.serialize_result`).
"""

import json
import os

import numpy as np
import pytest
pytest.importorskip("torch")
import torch

from rustsasa_tpu_torch.api import SASAOptions
from rustsasa_tpu_torch.batch import serialize_result
from rustsasa_tpu_torch.cli import main
from rustsasa_tpu_torch.io.read import read_structure
from rustsasa_tpu_torch.io.serialize import (
    fast_selection_json,
    fast_selection_xml,
    parse_json_result,
)
from rustsasa_tpu_torch.ops.engine import calculate_sasa_internal
from rustsasa_tpu_torch.levels import Level

GOLDEN = np.load("tests/data/golden_example_atom_sasa.npy")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: the suite runs in several worker processes."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def run_cli(*argv):
    return main([str(a) for a in argv] + ["--device", "cpu"])


@pytest.fixture()
def example(example_cif):
    return str(example_cif)


def test_atom_json_output(example, tmp_path):
    out = tmp_path / "out.json"
    assert run_cli(example, out, "--output-depth", "atom") == 0
    result = parse_json_result(out.read_text())
    assert result.atoms.shape == GOLDEN.shape
    np.testing.assert_allclose(result.atoms, GOLDEN, atol=25.0)


def test_residue_json_output(example, tmp_path):
    out = tmp_path / "out.json"
    assert run_cli(example, out) == 0  # default depth: residue
    data = json.loads(out.read_text())
    assert "Residue" in data
    row = data["Residue"][0]
    assert set(row) == {
        "serial_number", "insertion_code", "value", "name", "is_polar",
        "chain_id",
    }


def test_protein_xml_output(example, tmp_path):
    out = tmp_path / "out.xml"
    assert run_cli(example, out, "--output-depth", "protein") == 0
    text = out.read_text()
    assert text.startswith("<Protein><global_total>")


def test_pdb_writeback_output(example, tmp_path):
    out = tmp_path / "out.pdb"
    assert run_cli(example, out, "--output-depth", "protein") == 0
    s = read_structure(str(out))
    assert s.n_atoms() == 2622
    # Every atom's B-factor is the protein total.
    assert np.allclose(s.atoms.bfactor, s.atoms.bfactor[0])
    assert s.atoms.bfactor[0] == pytest.approx(20268.0, abs=1500.0)


def test_cif_writeback_output(example, tmp_path):
    out = tmp_path / "out.cif"
    assert run_cli(example, out, "--output-depth", "chain") == 0
    s = read_structure(str(out))
    assert s.n_atoms() == 2622
    assert np.allclose(s.atoms.bfactor, s.atoms.bfactor[0])


def test_custom_flags(example, tmp_path):
    out = tmp_path / "out.json"
    assert (
        run_cli(
            example, out, "--output-depth", "protein", "-n", "60",
            "-p", "1.2", "-a",
        )
        == 0
    )
    data = json.loads(out.read_text())
    assert data["Protein"]["global_total"] > 0


def test_directory_batch(reference_data_dir, tmp_path):
    out_dir = tmp_path / "outputs"
    assert (
        run_cli(
            reference_data_dir / "pdbs", out_dir, "--format", "json",
            "--output-depth", "residue",
        )
        == 0
    )
    produced = sorted(os.listdir(out_dir))
    assert produced == ["151L_H3.json", "bad_seqadv_1A06.json", "example.json"]
    for f in produced:
        data = json.loads((out_dir / f).read_text())
        assert "Residue" in data
        assert sum(r["value"] for r in data["Residue"]) > 1000


def test_missing_input_fails():
    with pytest.raises(SystemExit) as e:
        run_cli("/nonexistent/input.pdb", "/tmp/out.json")
    assert e.value.code != 0


def test_missing_input_directory_fails():
    with pytest.raises(SystemExit) as e:
        run_cli("/nonexistent/dir/", "/tmp/outdir")
    assert e.value.code != 0


def test_directory_without_format_fails(reference_data_dir, tmp_path):
    with pytest.raises(SystemExit) as e:
        run_cli(reference_data_dir / "pdbs", tmp_path / "o")
    assert e.value.code != 0


def test_bad_radii_file_fails(example, tmp_path):
    with pytest.raises(SystemExit) as e:
        run_cli(example, tmp_path / "o.json", "-r", "/nonexistent/radii.cfg")
    assert e.value.code != 0


def test_output_is_directory_fails(example, tmp_path):
    with pytest.raises(SystemExit) as e:
        run_cli(example, tmp_path)
    assert e.value.code != 0


def test_zero_threads_fails(example, tmp_path):
    with pytest.raises(SystemExit) as e:
        run_cli(example, tmp_path / "o.json", "-t", "0")
    assert e.value.code != 0


def test_batch_error_isolation(tmp_path, capsys):
    """A corrupt file must not abort the batch (reference: main.rs:447-477)."""
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    (in_dir / "good.pdb").write_text(
        "ATOM      1  N   ALA A   1       0.000   0.000   0.000  1.00  0.00"
        "           N\nEND\n"
    )
    # HETATM-only file -> all atoms filtered; still "processes" to empty.
    # A file whose radius cannot be resolved -> per-file error.
    (in_dir / "bad.pdb").write_text(
        "ATOM      1  XQ  ZZZ A   1       0.000   0.000   0.000  1.00  0.00"
        "           XQ\nEND\n"
    )
    out_dir = tmp_path / "out"
    assert run_cli(in_dir, out_dir, "--format", "json") == 0
    assert sorted(os.listdir(out_dir)) == ["good.json"]
    err = capsys.readouterr().err
    assert "bad" in err
    assert "Total errors: 1" in err


def test_radii_from_occupancy(tmp_path):
    pdb = (
        "ATOM      1  N   ALA A   1       0.000   0.000   0.000  2.00  0.00"
        "           N\nEND\n"
    )
    f = tmp_path / "s.pdb"
    f.write_text(pdb)
    out = tmp_path / "o.json"
    assert run_cli(f, out, "--output-depth", "atom", "-R") == 0
    atoms = parse_json_result(out.read_text()).atoms
    # Radius 2.0 from occupancy: SASA = 4*pi*(2.0+1.4)^2
    assert atoms[0] == pytest.approx(4 * np.pi * 3.4**2, rel=1e-3)


def test_trajectory_cli(tmp_path):
    from rustsasa_tpu_torch.trajectory import write_dcd

    top = tmp_path / "top.pdb"
    top.write_text(
        "ATOM      1  N   ALA A   1      20.154  16.967  25.000  1.00 10.00"
        "           N\n"
        "ATOM      2  CA  ALA A   1      19.030  16.155  25.000  1.00 15.00"
        "           C\nEND\n"
    )
    s = read_structure(str(top))
    coords = np.stack([s.atoms.coords, s.atoms.coords + 5.0])
    dcd = tmp_path / "t.dcd"
    write_dcd(str(dcd), coords)
    out = tmp_path / "traj.json"
    assert run_cli(dcd, out, "-T", top) == 0
    data = json.loads(out.read_text())
    assert data["n_frames"] == 2
    assert len(data["totals"]) == 2
    assert data["totals"][0] == pytest.approx(data["totals"][1], rel=1e-4)
    assert data["residue_names"] == ["ALA"]


@pytest.mark.parametrize("fmt", ["xml", "pdb", "cif"])
def test_directory_batch_format_matrix(fmt, reference_data_dir, tmp_path):
    """Directory mode for every non-json output format (reference:
    tests/integration.rs directory coverage)."""
    out_dir = tmp_path / f"outputs_{fmt}"
    assert (
        run_cli(
            reference_data_dir / "pdbs", out_dir, "--format", fmt,
            "--output-depth", "atom" if fmt in ("pdb", "cif") else "residue",
        )
        == 0
    )
    produced = sorted(os.listdir(out_dir))
    assert produced == [
        f"151L_H3.{fmt}", f"bad_seqadv_1A06.{fmt}", f"example.{fmt}"
    ]
    example_out = (out_dir / f"example.{fmt}").read_text()
    if fmt == "xml":
        assert example_out.startswith("<")
        assert "Residue" in example_out
    else:
        # b-factor write-back: re-parse and check SASA values landed.
        reparsed = read_structure(str(out_dir / f"example.{fmt}"))
        bf = reparsed.atoms.bfactor
        assert bf.shape[0] > 2000
        assert float(bf.max()) > 10.0  # SASA values, not original b-factors


def test_default_device_fails_without_cuda(example, tmp_path, monkeypatch,
                                           capsys):
    """--device defaults to cuda and never falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "o.json"
    with pytest.raises(SystemExit) as e:
        main([example, str(out)])
    assert e.value.code == 2
    assert "CUDA is not available" in capsys.readouterr().err
    assert not out.exists()


@pytest.mark.parametrize("fmt", ["json", "xml"])
def test_single_file_native_route_bytes_match_python_route(
        reference_data_dir, tmp_path, fmt):
    """The single-file fast path (native parse, select and emit) writes
    the bytes of the batch's Python route (`fast_selection_json`/`_xml`,
    as tests/test_native_pipe.py holds for the reference), and the values
    of the CLI's Python route (`batch.serialize_result`, which prints the
    shortest f32 repr where the emit prints 9 significant digits, in both
    packages)."""
    path = str(reference_data_dir / "freesasa_pdbs" / "2drt.pdb.gz")
    out = tmp_path / f"o.{fmt}"
    assert run_cli(path, out) == 0
    structure = read_structure(path)
    result, sel = SASAOptions(level=Level.RESIDUE, device="cpu"
                              ).process_with_selection(structure)
    atom_sasa = calculate_sasa_internal(
        sel.coords, sel.radii, group_ids=sel.group_ids, device="cpu")
    fast = fast_selection_json if fmt == "json" else fast_selection_xml
    assert out.read_text() == fast(sel, atom_sasa, Level.RESIDUE)
    python_route = serialize_result(structure, result, fmt, selection=sel)
    if fmt == "json":
        got = json.loads(out.read_text())["Residue"]
        want = json.loads(python_route)["Residue"]
        assert [{k: v for k, v in r.items() if k != "value"} for r in got] \
            == [{k: v for k, v in r.items() if k != "value"} for r in want]
        np.testing.assert_allclose([r["value"] for r in got],
                                   [r["value"] for r in want],
                                   rtol=1e-6, atol=0)
