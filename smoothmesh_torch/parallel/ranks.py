"""Running a decomposition's smoother one shard a rank over
``torch.distributed``.

:func:`run_ranks` starts ``world`` processes of this module (``python
-m smoothmesh_torch.parallel.ranks JOB RANK WORLD``), each of which
joins a gloo process group through a ``FileStore`` in the job's
directory, builds the smoother of its rank (``distributed=True``): the
halo's :class:`~smoothmesh_torch.parallel.halo.HaloSmoother`
(:class:`~smoothmesh_torch.parallel.sync.DistSync`) or the disjoint
:class:`~smoothmesh_torch.parallel.sharded.ShardedSmoother`
(:class:`~smoothmesh_torch.parallel.sync.DistPointSync`), runs its
steps and writes its results there.  A rank imports only ``torch`` and
this package, so it starts in about a second on the CPU.  The backend
is gloo, the only one the ranks support: on ``cuda`` every rank takes
the current device, so the ranks share one card.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import torch

#: the seconds a rank's collective waits for the others
COLLECTIVE_TIMEOUT_S = 300.0


@dataclasses.dataclass
class Job:
    """One run: the mesh, the parameters, how many steps, where."""

    mesh: object
    params: object
    n_steps: int
    #: the smoother's device and dtype by name; None: its defaults
    #: (``cuda``, float32)
    device: str = None
    dtype: str = None
    #: enable_boundary_smoothing's arguments, or None
    geometry: tuple = None
    #: "halo" (HaloSmoother) or "disjoint" (ShardedSmoother)
    decomposition: str = "halo"


def run_ranks(job: Job, world: int, workdir, timeout_s: float = 600.0):
    """Run ``job`` on ``world`` ranks in processes of their own -> each
    rank's result dict (``points``: its union rows, ``results``: the
    StepResults as tuples, ``denormalized``: the global points,
    ``quality``: the global report, and ``setup_times``), in rank
    order.  Raises if a rank fails; every process started here has
    ended when it returns or raises."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    job_path = workdir / "job.pkl"
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    procs = [subprocess.Popen(
        [sys.executable, "-m", "smoothmesh_torch.parallel.ranks",
         str(job_path), str(rank), str(world)], env=env, cwd=root,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for rank in range(world)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=timeout_s)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {rank} exited with {p.returncode}:\n"
                               f"{log}")
    out = []
    for rank in range(world):
        with open(workdir / f"rank{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(job_path: str, rank: int, world: int) -> None:
    import torch.distributed as dist

    from smoothmesh_torch.parallel.halo import HaloSmoother
    from smoothmesh_torch.parallel.sharded import ShardedSmoother

    torch.set_num_threads(1)
    with open(job_path, "rb") as f:
        job: Job = pickle.load(f)
    workdir = Path(job_path).parent
    store = dist.FileStore(str(workdir / "store"), world)
    dist.init_process_group("gloo", store=store, rank=rank,
                            world_size=world,
                            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    try:
        dtype = None if job.dtype is None else getattr(torch, job.dtype)
        cls = {"halo": HaloSmoother,
               "disjoint": ShardedSmoother}[job.decomposition]
        sm = cls(job.mesh, job.params, device=job.device, dtype=dtype,
                 distributed=True)
        if job.geometry is not None:
            sm.enable_boundary_smoothing(*job.geometry)
        results = sm.steps(job.n_steps)
        out = dict(points=sm.points.cpu(),
                   results=[dataclasses.astuple(r) for r in results],
                   denormalized=sm.denormalize(), quality=sm.quality(),
                   setup_times=sm.setup_times)
        with open(workdir / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
