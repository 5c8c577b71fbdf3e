"""Directory runner: `process_directory` over a seeded corpus, whole
passes back to back, as the command line's directory mode runs it.

Inputs: the corpus rule (`generate.corpus_plan`) over the
configuration's structures, each copy a symbolic link named
`<position>_<structure>.pdb.gz` in the cell's work directory, the
positions in the seed's order.  A pass writes every output into a
directory of its own; the warm-up is one pass.  Compared, after the
window: every output file of every pass.  Copies of one structure get
the same input, so each distinct output of a structure is parsed once
and its residues compared with the plain reference's.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil

from .. import generate, reference, structures
from ..compare import Gaps


class Runner:
    def __init__(self, config, traffic, seed, workdir, device, say):
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.workdir = workdir
        self.device = device
        self.say = say
        self.passes = []
        self.bytes_written = 0

    def make_inputs(self):
        cfg = self.config
        self.paths = {os.path.basename(p).split(".")[0]: p
                      for p in cfg["structure_paths"]}
        self.atoms = {n: structures.read_atoms(p)
                      for n, p in self.paths.items()}
        sizes = {n: len(a.name) for n, a in self.atoms.items()}
        self.plan = generate.corpus_plan(sizes, cfg["target_files"],
                                         cfg["target_atoms"], self.seed)
        self.file_atoms = sum(sizes[n] for n in self.plan)
        self.sources = sorted(set(self.plan))

    def setup(self):
        from rustsasa_tpu_torch.api import SASAOptions
        from rustsasa_tpu_torch.batch import process_directory
        from rustsasa_tpu_torch.levels import Level

        self.make_inputs()
        shutil.rmtree(self.workdir, ignore_errors=True)
        self.corpus = os.path.join(self.workdir, "corpus")
        os.makedirs(self.corpus)
        self.names = []
        for k, name in enumerate(self.plan):
            src = self.paths[name]
            link = f"{k:05d}_{name}{os.path.basename(src)[len(name):]}"
            os.symlink(os.path.abspath(src), os.path.join(self.corpus, link))
            self.names.append((f"{k:05d}_{name}", name))
        self.options = SASAOptions(
            level=Level.RESIDUE, probe_radius=self.config["probe_radius"],
            n_points=self.config["n_points"], device=self.device)
        self._run = process_directory
        self.say(f"corpus: {len(self.plan)} files, {self.file_atoms} atoms, "
                 f"{len(self.sources)} distinct structures")
        self.run_pass("warm")
        warm = self.passes.pop()[0]
        self.bytes_written += sum(e.stat().st_size for e in os.scandir(warm))
        shutil.rmtree(warm)

    def run_pass(self, tag=None) -> dict:
        out = os.path.join(self.workdir, f"out_{tag or len(self.passes)}")
        report = self._run(self.corpus, out, self.options,
                           self.traffic["format"], progress=False)
        self.passes.append((out, report))
        return {"file_atoms": self.file_atoms, "files": len(self.plan)}

    def window_work(self, passes, device):
        return None

    def release(self):
        self._run = None

    def answers(self):
        """Per pass: ({(structure, digest): residue values}, missing)."""
        out = []
        for out_dir, report in self.passes:
            missing = len(report.errors)
            got = {}
            for stem, name in self.names:
                path = os.path.join(out_dir, f"{stem}.{self.traffic['format']}")
                try:
                    with open(path, "rb") as f:
                        data = f.read()
                except OSError:
                    missing += 1
                    continue
                self.bytes_written += len(data)
                key = (name, hashlib.blake2b(data, digest_size=16).digest())
                if key not in got:
                    got[key] = data
            out.append((got, missing))
        return out

    def reference(self, dtype, device):
        """[({(structure, "reference"): {residue key: value}}, 0)], in the
        form of `answers`."""
        cfg = self.config
        got = {}
        for name in self.sources:
            sel = structures.select(self.atoms[name])
            sasa = reference.atom_sasa(sel.coords, sel.radii,
                                       cfg["probe_radius"], cfg["n_points"],
                                       dtype=dtype, device=device)
            sums = reference.residue_sums(sasa, sel.residue,
                                          len(sel.residues))
            got[name, "reference"] = dict(zip(sel.residues, sums))
        return [(got, 0)]

    def compare(self, answers, ref):
        """Every pass's outputs: the files missing or refused, then each
        distinct output's residue keys against the reference's (exact)
        and its residue gaps (A^2)."""
        ref = {name: v for (name, _), v in ref[0][0].items()}
        missing = mismatch = 0
        gaps = Gaps()
        parsed = {}
        for got, miss in answers:
            missing += miss
            for (name, digest), data in got.items():
                if (name, digest) not in parsed:
                    parsed[name, digest] = (_residues(data)
                                            if isinstance(data, bytes)
                                            else data)
                have, want = parsed[name, digest], ref[name]
                if have is None or set(have) != set(want):
                    mismatch += 1
                    continue
                gaps.add([have[k] for k in want], list(want.values()))
        checks = {"files_missing": float(missing),
                  "residue_keys_mismatch": float(mismatch),
                  **gaps.checks("residue_A2")}
        return checks, len(self.names) * len(answers), missing + mismatch

    def cleanup(self):
        shutil.rmtree(self.workdir, ignore_errors=True)


def _residues(data: bytes):
    """{(chain, serial, icode): value} of a residue-level JSON output."""
    try:
        rows = json.loads(data)["Residue"]
        return {(r["chain_id"], int(r["serial_number"]),
                 r["insertion_code"]): float(r["value"]) for r in rows}
    except (ValueError, KeyError, TypeError):
        return None
