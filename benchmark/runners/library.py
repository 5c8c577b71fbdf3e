"""Library runner: `BatchedSasaEngine.enqueue(...).collect()` over models
held in memory, whole passes back to back, as a Python pipeline runs it.

Inputs: the corpus rule (`generate.corpus_plan`) over the
configuration's structures, read and selected by the benchmark itself
(`structures.py`), each copy moved by one of `poses` rigid motions drawn
from the seed (a uniform rotation about the structure's centroid and a
shift), so that copies differ; a (coords, radii, None) triple a copy.
One engine serves every pass; the warm-up is one pass.  Compared, after
the window: every per-atom array of a seeded sample of the passes (the
first and about `kept_share` of the others), against the plain
reference of its own input, in units of sphere points.
"""

from __future__ import annotations

import os

import numpy as np

from .. import generate, reference, structures, work
from ..compare import Gaps


class Runner:
    def __init__(self, config, traffic, seed, workdir, device, say):
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.workdir = workdir
        self.device = device
        self.say = say
        self.outputs = []
        self.bytes_written = 0

    def make_inputs(self):
        cfg = self.config
        paths = {os.path.basename(p).split(".")[0]: p
                 for p in cfg["structure_paths"]}
        atoms = {n: structures.read_atoms(p) for n, p in paths.items()}
        self.sel = {n: structures.select(a) for n, a in atoms.items()}
        sizes = {n: len(a.name) for n, a in atoms.items()}
        plan = generate.corpus_plan(sizes, cfg["target_files"],
                                    cfg["target_atoms"], self.seed)
        rot, shift = generate.poses(self.traffic["poses"],
                                    self.traffic["max_shift_A"],
                                    [self.seed, 2])
        pose_of = np.random.default_rng([self.seed, 3]).integers(
            0, len(rot), size=len(plan))
        self.inputs = {}
        self.copies = []
        for name, p in zip(plan, pose_of):
            key = (name, int(p))
            if key not in self.inputs:
                c = self.sel[name].coords.astype(np.float64)
                mid = c.mean(axis=0)
                moved = (c - mid) @ rot[p].T + mid + shift[p]
                self.inputs[key] = np.ascontiguousarray(moved, np.float32)
            self.copies.append(key)
        self.triples = [(self.inputs[k], self.sel[k[0]].radii, None)
                        for k in self.copies]
        self.atoms = sum(len(t[1]) for t in self.triples)

    def setup(self):
        from rustsasa_tpu_torch.ops.engine import BatchedSasaEngine, SasaParams

        self.make_inputs()
        self.engine = BatchedSasaEngine(
            SasaParams(probe_radius=self.config["probe_radius"],
                       n_points=self.config["n_points"]),
            device=self.device)
        self.say(f"library: {len(self.triples)} structures, {self.atoms} "
                 f"atoms, {len(self.inputs)} distinct inputs")
        self.run_pass()
        self.outputs.clear()
        self.keep = np.random.default_rng([self.seed, 4])

    def run_pass(self) -> dict:
        out = self.engine.enqueue(self.triples).collect()
        # A seeded sample of the passes (the first always) is kept for the
        # check; the others' arrays are freed at once, so the window's
        # memory is a pipeline's and not a growing archive.
        if not self.outputs or self.keep.random() < self.traffic["kept_share"]:
            self.outputs.append(out)
        return {"atoms": self.atoms, "structures": len(self.triples)}

    def window_work(self, passes, device):
        pairs = {n: work.pairs_in_reach(s.coords, s.radii,
                                        self.config["probe_radius"],
                                        device=device)
                 for n, s in self.sel.items()}
        instr, nbytes = work.sasa_work(
            sum(pairs[name] for name, _ in self.copies), self.atoms,
            self.config["n_points"])
        return instr * passes, nbytes * passes

    def release(self):
        self.engine = None

    def answers(self):
        return [(out, 0) for out in self.outputs]

    def reference(self, dtype, device):
        """[(per-copy SASA arrays, 0)] of the plain reference, each
        distinct input computed once."""
        cfg = self.config
        got = {k: reference.atom_sasa(c, self.sel[k[0]].radii,
                                      cfg["probe_radius"], cfg["n_points"],
                                      dtype=dtype, device=device)
               for k, c in self.inputs.items()}
        return [([got[k] for k in self.copies], 0)]

    def compare(self, answers, ref):
        """Per-atom gaps in sphere points over every array of every pass;
        an array of the wrong length counts as missing."""
        cfg = self.config
        want = ref[0][0]
        area = [reference.point_area(self.sel[name].radii,
                                     cfg["probe_radius"], cfg["n_points"])
                for name, _ in self.copies]
        missing = 0
        gaps = Gaps()
        for out, _ in answers:
            if len(out) != len(want):
                missing += len(want)
                continue
            for have, w, a in zip(out, want, area):
                if np.shape(have) != w.shape:
                    missing += 1
                    continue
                gaps.add(np.asarray(have, np.float64) / a, w / a)
        checks = {"answers_missing": float(missing), **gaps.checks("atom_pts")}
        return checks, len(want) * len(answers), missing

    def cleanup(self):
        pass
