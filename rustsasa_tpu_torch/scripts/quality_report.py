#!/usr/bin/env python
"""Quality report vs FreeSASA through the port: RMSE + Pearson r per
output depth.

The port's counterpart of `scripts/quality_report.py` (the analog of the
reference's paper eval tooling, paper/eval/scripts/quality_scatter.py):
runs the port's batch pipeline over a PDB directory on `device` and
compares chain totals against stored FreeSASA JSON outputs (the
reference's gate semantics, tests/quality.rs:107-122).

Usage:
    python -m rustsasa_tpu_torch.scripts.quality_report \\
        [pdb_dir] [reference_dir] [--device cuda|cpu]
Defaults to the reference quality-gate dataset on "cuda".
"""

import argparse
import gzip
import json
import math
import os
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_PDB_DIR = os.path.join(REPO, "tests", "data", "freesasa_pdbs")
DEFAULT_REF_DIR = os.path.join(REPO, "tests", "data", "freesasa_reference")


def pearson(xs, ys):
    n = len(xs)
    if n == 0:
        return float("nan")
    mx = sum(xs) / n
    my = sum(ys) / n
    cov = sum((a - mx) * (b - my) for a, b in zip(xs, ys))
    vx = sum((a - mx) ** 2 for a in xs)
    vy = sum((b - my) ** 2 for b in ys)
    return cov / math.sqrt(vx * vy) if vx > 0 and vy > 0 else float("nan")


def _score(depth, out_dir, ref_dir, report, use_file_total):
    """Match our outputs in out_dir against the FreeSASA chain totals (or
    file totals, for the atom and protein depths) and return the row."""
    ours, ref = [], []
    for fname in sorted(os.listdir(ref_dir)):
        if not fname.endswith(".json"):
            continue
        out_path = os.path.join(out_dir, fname)
        if not os.path.exists(out_path):
            continue
        with open(os.path.join(ref_dir, fname)) as f:
            ref_data = json.load(f)
        ref_chains = {}
        total = 0.0
        for result in ref_data["results"]:
            for structure in result["structure"]:
                for chain in structure["chains"]:
                    ref_chains[chain["label"]] = chain["area"]["total"]
                    total += chain["area"]["total"]
        stem = os.path.splitext(fname)[0]
        with open(out_path) as f:
            data = json.load(f)
        mine = {}
        if "Atom" in data:
            mine[stem] = float(sum(data["Atom"]))
        elif "Residue" in data:
            for r in data["Residue"]:
                mine[r["chain_id"]] = mine.get(r["chain_id"], 0.0) + r["value"]
        elif "Chain" in data:
            for c in data["Chain"]:
                mine[c["name"]] = c["value"]
        elif "Protein" in data:
            mine[stem] = data["Protein"]["global_total"]
        targets = {stem: total} if use_file_total else ref_chains
        for key, rv in targets.items():
            if key in mine:
                ref.append(rv)
                ours.append(mine[key])
    # Zero matched comparisons IS the catastrophic case the gate exists
    # for (e.g. every file errored): report rmse=inf so the artifact says
    # pass=false instead of crashing with ZeroDivisionError.
    rmse = (
        math.sqrt(sum((a - b) ** 2 for a, b in zip(ours, ref)) / len(ours))
        if ours else float("inf")
    )
    return {
        "depth": depth,
        "n": len(ours),
        "rmse": rmse,
        "pearson_r": pearson(ours, ref),
        "n_files": report.n_files,
        "n_ok": report.n_ok,
        "errors": list(report.errors),
    }


def evaluate_depth(depth: str, pdb_dir: str = DEFAULT_PDB_DIR,
                   ref_dir: str = DEFAULT_REF_DIR, device="cuda"):
    """Run the port's batch pipeline at `depth` over pdb_dir on `device`
    and score against the stored FreeSASA outputs.

    Returns a dict: n (matched comparisons), rmse, pearson_r, n_files,
    n_ok, errors (list of per-file error strings).
    """
    from ..api import SASAOptions
    from ..batch import process_directory
    from ..levels import Level

    with tempfile.TemporaryDirectory(prefix=f"rsasa_quality_{depth}_") as out:
        report = process_directory(
            pdb_dir, out, SASAOptions(level=Level(depth), device=device),
            "json", progress=False,
        )
        return _score(depth, out, ref_dir, report,
                      use_file_total=depth in ("atom", "protein"))


_TWO_LETTER_ELEMENTS = (
    "FE", "ZN", "MG", "MN", "CU", "NA", "CL", "BR", "CA", "NI", "SE",
    "CO", "CD", "HG",
)


def guess_element(atom_name: str) -> str:
    """Element from a PDB atom-name field (columns 13-16), reference
    fallback behavior: strip digits, take the leading letter(s)."""
    name = atom_name.strip()
    stripped = name.lstrip("0123456789")
    if len(atom_name) >= 1 and atom_name[0] != " " and len(stripped) >= 2:
        two = stripped[:2].upper()
        if two in _TWO_LETTER_ELEMENTS:
            return two
    return stripped[:1].upper() if stripped else "C"


def rewrite_occupancy_with_radii(pdb_text: str) -> str:
    """Stamp each ATOM/HETATM record's occupancy column (55-60) with its
    ProtOr radius (VdW fallback), like the reference's fifth quality test
    does via pdbtbx (quality.rs:289-324)."""
    from ..radii import get_protor_radius, get_vdw_radius

    out_lines = []
    for line in pdb_text.splitlines():
        if line.startswith(("ATOM  ", "HETATM")) and len(line) >= 60:
            atom_name = line[12:16]
            res_name = line[17:20].strip()
            element = line[76:78].strip() if len(line) >= 78 else ""
            radius = get_protor_radius(res_name, atom_name.strip())
            if radius is None:
                radius = get_vdw_radius(element or guess_element(atom_name))
            if radius is None:
                radius = 1.5  # same spirit as the reference's hard error;
                # keep the file processable rather than abort the corpus
            line = f"{line[:54]}{radius:6.2f}{line[60:]}"
        out_lines.append(line)
    return "\n".join(out_lines) + "\n"


def evaluate_occupancy(pdb_dir: str = DEFAULT_PDB_DIR,
                       ref_dir: str = DEFAULT_REF_DIR, device="cuda"):
    """The -R path end-to-end (reference: quality.rs:260-442): rewrite
    radii into the occupancy column of every gate PDB, run the port's
    pipeline with read_radii_from_occupancy=True at residue depth on
    `device`, and score against the same FreeSASA chain totals."""
    from ..api import SASAOptions
    from ..batch import process_directory
    from ..levels import Level

    with tempfile.TemporaryDirectory(prefix="rsasa_quality_occ_") as tmp:
        modified_dir = os.path.join(tmp, "src")
        out_dir = os.path.join(tmp, "out")
        os.makedirs(modified_dir)
        for fname in sorted(os.listdir(pdb_dir)):
            path = os.path.join(pdb_dir, fname)
            if fname.endswith(".gz"):
                with gzip.open(path, "rt") as f:
                    text = f.read()
                fname = fname[:-3]
            else:
                with open(path) as f:
                    text = f.read()
            if not fname.endswith((".pdb", ".ent")):
                continue  # the rewrite is PDB-columnar
            with open(os.path.join(modified_dir, fname), "w") as f:
                f.write(rewrite_occupancy_with_radii(text))
        report = process_directory(
            modified_dir, out_dir,
            SASAOptions(level=Level.RESIDUE, read_radii_from_occupancy=True,
                        device=device),
            "json", progress=False,
        )
        return _score("occupancy_residue", out_dir, ref_dir, report,
                      use_file_total=False)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("pdb_dir", nargs="?", default=DEFAULT_PDB_DIR)
    p.add_argument("ref_dir", nargs="?", default=DEFAULT_REF_DIR)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    rows = [evaluate_depth(depth, args.pdb_dir, args.ref_dir, args.device)
            for depth in ("residue", "chain", "atom", "protein")]
    rows.append(evaluate_occupancy(args.pdb_dir, args.ref_dir, args.device))
    for r in rows:
        print(
            f"[{r['depth']:17s}] n={r['n']:4d}  RMSE={r['rmse']:8.2f} A^2  "
            f"pearson_r={r['pearson_r']:.5f}  "
            f"({r['n_ok']}/{r['n_files']} files)"
        )
    return 0


if __name__ == "__main__":
    sys.exit(main())
