"""The system under test, driven as a user's smoothing job: one
``Smoother.steps(centroidalIters)`` call from the start state, the call
``Smoother.run`` makes when no write falls inside the job.

This is the only module that imports the program (``smoothmesh_torch``,
the PyTorch and CUDA package).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from harness import inputs

#: a configuration's ``dtype``: the coordinates' type in the program
DTYPES = {"float32": torch.float32, "float64": torch.float64}


class Program:
    """The port's smoother for one cell and seed, and its start state."""

    def __init__(self, config: dict, mix: dict, seed: int, device="cuda"):
        self.config, self.mix, self.seed = config, mix, seed
        self.device = torch.device(device)
        self.mesh = inputs.make_mesh(config, mix, seed)
        self.times = {}

    def params(self):
        from smoothmesh_torch.params import SmoothingParams

        job = self.mix["job"]
        return SmoothingParams(centroidal_iters=int(job["iterations"]),
                               rel_tol=float(job["rel_tol"]),
                               **self.mix["params"])

    def polymesh(self):
        from smoothmesh_torch.io.polymesh import Patch, PolyMesh

        m = self.mesh
        return PolyMesh(points=m["points"], face_flat=m["face_flat"],
                        face_offsets=m["face_offsets"], owner=m["owner"],
                        neighbour=m["neighbour"],
                        patches=[Patch(name, "wall", n, start)
                                 for name, n, start in m["patches"]])

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def setup(self) -> None:
        """The smoother, the boundary set-up where the mix asks for it,
        the batch (on the card: its capture) and one warm batch, from
        which the start state is restored."""
        from smoothmesh_torch import kernels, native
        from smoothmesh_torch.driver import Smoother

        mesh = self.polymesh()
        params = self.params()
        # the port's compiled parts, built where the checkout has none
        # (its first run) and loaded: the CUDA kernels and the topology
        # compiler's library
        t0 = time.perf_counter()
        if self.device.type == "cuda":
            kernels.build_all()
        native.MESHCOMPILER.load()
        self.times["build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        self.sm = Smoother(mesh, params, device=self.device,
                           dtype=DTYPES[self.config["dtype"]])
        self._sync()
        self.times["smoother_init_s"] = time.perf_counter() - t0
        target = inputs.target(self.config, self.mix)
        if target is not None:
            t0 = time.perf_counter()
            self.sm.enable_boundary_smoothing(*target)
            self._sync()
            self.times["boundary_setup_s"] = time.perf_counter() - t0
        self.sm.prepare_batch()
        self.start = (self.sm.points.clone(), self.sm.normals.clone())
        self.sm.steps(max(self.sm.iter_batch, 1))
        self.restore()
        self._sync()

    def restore(self) -> None:
        """The start state, into the tensors ``steps`` reads."""
        self.sm.points = self.start[0].clone()
        self.sm.normals = self.start[1].clone()

    def job(self, iterations=None) -> list:
        """One smoothing job from the start state -> its StepResults."""
        self.restore()
        n = int(self.mix["job"]["iterations"]) if iterations is None \
            else iterations
        return self.sm.steps(n)

    def window(self, seconds: float) -> dict:
        """Whole jobs back to back until ``seconds`` have passed, then a
        synchronize -> walls (``StepResult.wall_ms``, one an iteration),
        each job's host wall (ms; each job ends in the host read of its
        last batch), jobs, the window's seconds, face-angle stops and
        the last job's results."""
        stops0 = self.sm.face_angle_stops
        walls, job_ms, jobs, failed, last = [], [], 0, 0, []
        self._sync()
        t0 = t = time.perf_counter()
        while t - t0 < seconds:
            try:
                last = self.job()
            except RuntimeError:
                failed += 1
                continue
            finally:
                jobs += 1
                t, t_job = time.perf_counter(), t
                job_ms.append((t - t_job) * 1e3)
            walls += [r.wall_ms for r in last]
        self._sync()
        return dict(seconds=time.perf_counter() - t0, walls=walls,
                    job_ms=job_ms, jobs=jobs, failed=failed, last=last,
                    stops=self.sm.face_angle_stops - stops0,
                    final=self.external())

    def external(self) -> np.ndarray:
        """The current points in the mesh's own order and coordinates."""
        return self.sm.denormalize()

    def segment(self, start: int, length: int) -> dict:
        """The state after ``start`` iterations of a job and after
        ``length`` more (both through ``steps``, as the job runs) ->
        points before and after, the iterations that ran and their
        residuals."""
        self.job(start)
        before = self.external()
        ran = self.sm.steps(length)
        return dict(start=start, before=before, after=self.external(),
                    ran=len(ran), residuals=[r.residual for r in ran])

    def external_normals(self) -> np.ndarray:
        """The boundary normals' state in the mesh's own point order."""
        return self.sm.to_external_point_field(
            self.sm.normals.detach().to("cpu", torch.float64).numpy())

    def single_steps(self, start: int, length: int) -> dict:
        """After ``start`` iterations of a job, ``length`` calls of
        ``steps(1)`` (each a replay of the job's captured iteration) ->
        the start and, per iteration, the points and normals before and
        after."""
        self.job(start)
        out = []
        for _ in range(length):
            before = (self.external(), self.external_normals())
            if not self.sm.steps(1):
                break
            out.append(dict(before=before[0], normals=before[1],
                            after=self.external(),
                            normals_after=self.external_normals()))
        return dict(start=start, steps=out)

    def close(self) -> None:
        """Free the program's device state."""
        self.sm = None
        self.start = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
