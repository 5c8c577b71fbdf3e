"""Command-line interface of the PyTorch port.

Mirrors the reference CLI's arguments, defaults, inference rules and exit
behaviors (reference: src/main.rs:56-106, 482-588), plus --device:

    rustsasa-tpu-torch <input> <output> [--output-depth ...] [--format ...]
        [-n N] [-p PROBE] [-H] [-r FILE] [-a] [-e] [-t THREADS] [-R]
        [-T TOPOLOGY] [--device cuda|cpu]

    python -m rustsasa_tpu_torch.cli tests/data/pdbs/example.cif out.json \
        --output-depth residue --device cpu

Single files infer the output format from the output extension; directories
require --format and get per-file error isolation + a progress bar.  Every
mode computes on --device: "cuda" by default, which fails without CUDA
(no fallback), or "cpu", where the plain-torch kernels run.
"""

from __future__ import annotations

import argparse
import os
import sys

from . import __version__
from .api import SASAOptions
from .batch import process_directory, serialize_result
from .io.read import read_structure
from .levels import Level
from .ops.engine import _device

FORMATS = ("json", "xml", "pdb", "cif")


def format_from_extension(filename: str) -> str:
    ext = filename.rsplit(".", 1)[-1].lower() if "." in filename else ""
    return ext if ext in FORMATS else "json"


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rustsasa-tpu-torch",
        description=(
            "Shrake-Rupley solvent-accessible surface area calculator on "
            "PyTorch and CUDA (RustSASA-compatible)."
        ),
    )
    p.add_argument("--version", action="version", version=__version__)
    p.add_argument("input", help="File or directory to read from.")
    p.add_argument("output", help="Output file or directory path.")
    p.add_argument(
        "-o", "--output-depth",
        choices=[level.value for level in Level],
        default=Level.RESIDUE.value,
        help="Output depth (default: residue).",
    )
    p.add_argument(
        "-f", "--format",
        choices=FORMATS,
        default=None,
        help=(
            "Output format (required when processing directories, inferred "
            "from the output extension for single files)."
        ),
    )
    p.add_argument(
        "-n", "--n-points", type=int, default=100,
        help="Number of Shrake-Rupley points (default: 100).",
    )
    p.add_argument(
        "-p", "--probe-radius", type=float, default=1.4,
        help="Probe radius in Angstroms (default: 1.4).",
    )
    p.add_argument(
        "-H", "--include-hydrogens", action="store_true",
        help="Include hydrogen atoms in the calculation.",
    )
    p.add_argument(
        "-r", "--radii-file", default=None,
        help="Path to a custom FreeSASA-format radii configuration file.",
    )
    p.add_argument(
        "-a", "--allow-vdw-fallback", action="store_true",
        help="Fall back to element van der Waals radii when a radius is "
             "not found in the radii config.",
    )
    p.add_argument(
        "-e", "--include-hetatms", action="store_true",
        help="Include HETATM records.",
    )
    p.add_argument(
        "-t", "--threads", type=int, default=-1,
        help="Host worker threads for batch parsing (-1: automatic). "
             "Chunks are dealt over every card --device names.",
    )
    p.add_argument(
        "-R", "--read-radii-from-occupancy", action="store_true",
        help="Read atomic radii from the occupancy column.",
    )
    p.add_argument(
        "-T", "--trajectory-topology", default=None, metavar="STRUCTURE",
        help="Treat the input as a DCD trajectory with this PDB/mmCIF "
             "topology; output is per-frame SASA JSON (the mdsasa-bolt "
             "workload).",
    )
    p.add_argument(
        "--device", default="cuda",
        help="Torch device to compute on (default: cuda, every visible "
             "card; cuda:N one card; cpu runs the plain-torch kernels).",
    )
    return p


def _make_options(args: argparse.Namespace) -> SASAOptions:
    opts = SASAOptions(
        level=Level(args.output_depth),
        probe_radius=args.probe_radius,
        n_points=args.n_points,
        include_hydrogens=args.include_hydrogens,
        allow_vdw_fallback=args.allow_vdw_fallback,
        include_hetatms=args.include_hetatms,
        read_radii_from_occupancy=args.read_radii_from_occupancy,
        device=args.device,
    )
    if args.radii_file:
        try:
            opts = opts.with_radii_file(args.radii_file)
        except OSError as e:
            raise CLIError(f"Failed to load radii file: {e}") from e
    return opts


class CLIError(Exception):
    pass


def run(args: argparse.Namespace) -> int:
    if args.threads == 0:
        raise CLIError(
            "Thread count must be -1 (automatic) or a positive number"
        )

    try:
        _device(args.device)
    except (RuntimeError, ValueError) as e:
        raise CLIError(str(e)) from e

    if not os.path.exists(args.input):
        if args.input.endswith(("/", "\\")):
            raise CLIError(
                f"Input path appears to be a directory but does not exist: "
                f"{args.input}"
            )
        raise CLIError(f"Input path does not exist: {args.input}")

    if args.trajectory_topology is not None:
        return _run_trajectory(args)

    if os.path.isdir(args.input):
        if args.format is None:
            raise CLIError(
                "Format argument is required when processing directories"
            )
        opts = _make_options(args)
        try:
            report = process_directory(
                args.input,
                args.output,
                opts,
                args.format,
                workers=None if args.threads < 0 else args.threads,
            )
        except (FileNotFoundError, NotADirectoryError) as e:
            raise CLIError(str(e)) from e
        if report.errors:
            sys.stderr.write(
                "\nThe following errors occurred during processing:\n"
            )
            for err in report.errors:
                sys.stderr.write(f"  - {err}\n")
            sys.stderr.write(f"\nTotal errors: {len(report.errors)}\n")
        else:
            print("All files processed successfully!")
        return 0

    # Single file.
    print("Processing single file...")
    parent = os.path.dirname(args.output)
    if parent and not os.path.exists(parent):
        try:
            os.makedirs(parent, exist_ok=True)
        except OSError as e:
            raise CLIError(f"Failed to write output file: {e}") from e
    fmt = args.format or format_from_extension(args.output)
    opts = _make_options(args)
    if os.path.isdir(args.output):
        raise CLIError(
            f"Failed to write output file: {args.output} is a directory"
        )
    if _run_single_native(args, opts, fmt):
        print("Finished!")
        return 0
    try:
        structure = read_structure(args.input)
        result, sel = opts.process_with_selection(structure)
        payload = serialize_result(structure, result, fmt, selection=sel)
    except CLIError:
        raise
    except Exception as e:  # noqa: BLE001 - typed exit below
        raise CLIError(f"SASA calculation failed: {e}") from e
    try:
        with open(args.output, "w", encoding="utf-8") as f:
            f.write(payload)
    except OSError as e:
        raise CLIError(f"Failed to write output file: {e}") from e
    print("Finished!")
    return 0


def _run_single_native(args, opts: SASAOptions, fmt: str) -> bool:
    """Single-file fast path: C++ parse + select + emit, device in between.

    Same output bytes as the Python route (tests/test_native_pipe.py);
    returns False when this configuration (format/radii/file quirks) needs
    the Python pipeline.
    """
    from .native import (
        NativeFallback,
        native_process_file,
        pipe_library,
        set_pipe_radii,
    )
    from .ops.engine import BatchedSasaEngine, SasaParams

    if fmt not in ("json", "xml") or pipe_library() is None:
        return False
    set_pipe_radii(opts.radii_config)
    try:
        ns = native_process_file(
            args.input,
            level=opts.level.value,
            include_hydrogens=opts.include_hydrogens,
            include_hetatms=opts.include_hetatms,
            read_radii_from_occupancy=opts.read_radii_from_occupancy,
            allow_vdw_fallback=opts.allow_vdw_fallback,
        )
    except NativeFallback:
        return False
    except CLIError:
        raise
    except Exception as e:  # noqa: BLE001 - typed exit below
        raise CLIError(f"SASA calculation failed: {e}") from e
    try:
        try:
            engine = BatchedSasaEngine(
                SasaParams(
                    probe_radius=opts.probe_radius, n_points=opts.n_points
                ),
                device=opts.device,
            )
            (sasa,) = engine.compute([(ns.coords, ns.radii, ns.gids)])
        except Exception as e:  # noqa: BLE001 - typed exit below
            raise CLIError(f"SASA calculation failed: {e}") from e
        try:
            ns.emit(sasa, opts.level.value, fmt, args.output)
        except OSError as e:
            # Same user-facing contract as the Python route's write stage.
            raise CLIError(f"Failed to write output file: {e}") from e
        except Exception as e:  # noqa: BLE001 - typed exit below
            raise CLIError(f"SASA calculation failed: {e}") from e
    finally:
        ns.close()
    return True


def _run_trajectory(args: argparse.Namespace) -> int:
    """Per-frame trajectory SASA -> JSON (totals + per-residue tracks)."""
    import json

    from .trajectory import compute_trajectory_sasa

    opts = _make_options(args)
    print("Processing trajectory...")
    try:
        result = compute_trajectory_sasa(
            args.trajectory_topology, args.input, opts
        )
    except Exception as e:  # noqa: BLE001 - typed exit below
        raise CLIError(f"SASA calculation failed: {e}") from e
    payload: dict = {
        "n_frames": result.n_frames,
        "n_atoms": result.n_atoms,
        "totals": [round(float(v), 4) for v in result.totals],
    }
    if result.residue_values is not None:
        payload["residue_names"] = result.residue_names
        payload["residues"] = [
            [round(float(v), 4) for v in row] for row in result.residue_values
        ]
    try:
        with open(args.output, "w", encoding="utf-8") as f:
            json.dump(payload, f)
    except OSError as e:
        raise CLIError(f"Failed to write output file: {e}") from e
    print("Finished!")
    return 0


def main(argv: list[str] | None = None) -> int:
    parser = build_arg_parser()
    args = parser.parse_args(argv)
    try:
        return run(args)
    except CLIError as e:
        parser.exit(2, f"error: {e}\n")
        return 2  # unreachable; parser.exit raises SystemExit


if __name__ == "__main__":
    sys.exit(main())
