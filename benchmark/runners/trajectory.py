"""Trajectory runner: `compute_trajectory_sasa` over a seeded DCD, whole
trajectories back to back.

Inputs: the configuration's topology, and `n_frames` frames of its
coordinates jittered by N(0, jitter_sigma) per frame and axis from the
seed, written once as a DCD in the cell's work directory.  A pass is one
`compute_trajectory_sasa(topology, dcd, options, block=traffic block)`
call; the warm-up is one pass.  Compared: each pass's frame count and
shapes, and the residue values of a seeded sample of frames (the same in
every pass) against the plain reference.
"""

from __future__ import annotations

import os

import numpy as np

from .. import generate, reference, structures, work
from ..compare import compare_residue_maps


class Runner:
    def __init__(self, config, traffic, seed, workdir, device, say):
        self.config = config
        self.traffic = traffic
        self.seed = seed
        self.workdir = workdir
        self.device = device
        self.say = say
        self.results = []
        self.bytes_written = 0

    def make_inputs(self):
        cfg = self.config
        self.topology = cfg["topology_path"]
        atoms = structures.read_atoms(self.topology)
        self.sel = structures.select(atoms)
        self.frames = generate.jitter_frames(
            atoms.coords, cfg["n_frames"], cfg["jitter_sigma_A"], self.seed)
        rng = np.random.default_rng([self.seed, 1])
        n = min(self.traffic["checked_frames"], cfg["n_frames"])
        self.sample = np.sort(rng.choice(cfg["n_frames"], n, replace=False))

    def setup(self):
        from rustsasa_tpu_torch.api import SASAOptions
        from rustsasa_tpu_torch.levels import Level
        from rustsasa_tpu_torch.trajectory import compute_trajectory_sasa

        self.make_inputs()
        os.makedirs(self.workdir, exist_ok=True)
        self.dcd = os.path.join(self.workdir, "trajectory.dcd")
        self.bytes_written += generate.write_dcd(self.dcd, self.frames)
        self.options = SASAOptions(
            level=Level.RESIDUE, probe_radius=self.config["probe_radius"],
            n_points=self.config["n_points"], device=self.device)
        self._run = compute_trajectory_sasa
        self.say(f"trajectory: {self.frames.shape[0]} frames x "
                 f"{self.frames.shape[1]} atoms, "
                 f"{self.bytes_written} B of DCD")
        self.run_pass()
        self.results.clear()

    def run_pass(self) -> dict:
        res = self._run(self.topology, self.dcd, self.options,
                        block=self.traffic.get("block"))
        self.results.append(res)
        return {"frames": int(res.n_frames)}

    def window_work(self, passes, device):
        pairs = work.frame_pairs_in_reach(
            self.frames[:, self.sel.index], self.sel.radii,
            self.config["probe_radius"], device=device)
        instr, nbytes = work.sasa_work(
            int(pairs.sum()), self.frames.shape[0] * len(self.sel.index),
            self.config["n_points"])
        return instr * passes, nbytes * passes

    def release(self):
        self._run = None

    def answers(self):
        """Per pass: ({frame: residue values}, frames missing)."""
        out = []
        n_res = len(self.sel.residues)
        for res in self.results:
            vals = res.residue_values
            ok = (res.n_frames == self.frames.shape[0] and vals is not None
                  and vals.shape == (self.frames.shape[0], n_res))
            if not ok:
                out.append(({}, self.frames.shape[0]))
                continue
            out.append(({int(f): vals[f].astype(np.float64)
                         for f in self.sample}, 0))
        return out

    def reference(self, dtype, device):
        """[({frame: residue values}, 0)] of the plain reference."""
        cfg = self.config
        got = {}
        for f in self.sample:
            sasa = reference.atom_sasa(
                self.frames[f][self.sel.index], self.sel.radii,
                cfg["probe_radius"], cfg["n_points"], dtype=dtype,
                device=device)
            got[int(f)] = reference.residue_sums(
                sasa, self.sel.residue, len(self.sel.residues))
        return [(got, 0)]

    def compare(self, answers, ref):
        return compare_residue_maps(answers, ref[0][0],
                                    self.frames.shape[0], "frames_missing")

    def cleanup(self):
        if getattr(self, "dcd", None) and os.path.exists(self.dcd):
            os.remove(self.dcd)
