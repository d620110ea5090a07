"""Running a decomposition's smoother one shard a rank over
``torch.distributed``.

:func:`join` is the one rule by which a process joins the ranks (used
here and by the CLI under ``torchrun``): on ``cuda`` the backend is
NCCL and each rank takes a card of its own, ``cuda:LOCAL_RANK``; on the
CPU it is gloo.  Gloo on ``cuda``, with every rank on the current card,
is taken only where the caller names it (a machine with one card can
run several ranks so), never because NCCL failed.

:func:`run_ranks` starts ``world`` processes of this module (``python
-m smoothmesh_torch.parallel.ranks JOB RANK WORLD``) on this machine,
each of which joins through a ``FileStore`` in the job's directory,
builds the smoother of its rank (``distributed=True``): the halo's
:class:`~smoothmesh_torch.parallel.halo.HaloSmoother`
(:class:`~smoothmesh_torch.parallel.sync.DistSync`) or the disjoint
:class:`~smoothmesh_torch.parallel.sharded.ShardedSmoother`
(:class:`~smoothmesh_torch.parallel.sync.DistPointSync`), runs its
steps and writes its results there.  A rank imports only ``torch`` and
this package, so it starts in about a second on the CPU.
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import time
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
    #: the process group's backend; None: from the device (:func:`join`)
    backend: str = None


def join(device, rank: int, world: int, backend: str = None, store=None,
         init_method: str = None) -> torch.device:
    """Join the default process group as ``rank`` of ``world`` (through
    ``store`` or ``init_method``) -> the device this rank runs on.

    ``backend`` None takes it from ``device``: NCCL on ``cuda``, gloo on
    the CPU.  Under NCCL the rank's card is ``cuda:LOCAL_RANK`` (from
    the environment, as ``torchrun`` sets it; else ``cuda:rank``), made
    the current device before the group is joined; it raises, before
    joining, where NCCL is not available, where ``device`` names
    another card, or where this machine's ranks (``LOCAL_WORLD_SIZE``
    from the environment, else ``world``) outnumber its cards: one
    card never holds two NCCL ranks.  ``backend="gloo"`` keeps
    ``device`` as it is, so on ``cuda`` the ranks share the current
    card.
    """
    import torch.distributed as dist

    device = torch.device(device)
    env = os.environ
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl":
        if device.type != "cuda":
            raise ValueError(f"NCCL runs on cuda, not on {device}")
        if not dist.is_nccl_available():
            raise RuntimeError("this torch has no NCCL backend")
        local_rank = int(env.get("LOCAL_RANK", rank))
        local_world = int(env.get("LOCAL_WORLD_SIZE", world))
        n_cards = torch.cuda.device_count()
        if max(local_world, local_rank + 1) > n_cards:
            raise RuntimeError(
                f"{max(local_world, local_rank + 1)} NCCL ranks on this "
                f"machine need a card each, and it has {n_cards} card(s): "
                "NCCL takes no two ranks on one card")
        if device.index not in (None, local_rank):
            raise ValueError(f"NCCL rank {rank} runs on cuda:{local_rank}, "
                             f"not on {device}")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    elif backend != "gloo":
        raise ValueError(f"backend {backend!r}: expected nccl or gloo")
    dist.init_process_group(backend, store=store, init_method=init_method,
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
    return device


def run_ranks(job: Job, world: int, workdir, timeout_s: float = 600.0):
    """Run ``job`` on ``world`` ranks in processes of their own on this
    machine (under NCCL rank ``r`` on ``cuda:r``) -> each rank's result
    dict (``points``: its union rows, ``results``: the StepResults as
    tuples, ``denormalized``: the global points, ``quality``: the
    global report, ``setup_times``, the group's ``backend``, the rank's
    ``device``, its kernels' ``launches`` by name and its host peak RSS
    in KiB, ``host_peak_rss_kib``), in rank order.
    Raises, with the failed rank's log, as soon as a rank fails (a rank
    that cannot join fails before any collective); every process
    started here has ended when it returns or raises."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    job_path = workdir / "job.pkl"
    with open(job_path, "wb") as f:
        pickle.dump(job, f)
    root = str(Path(__file__).resolve().parents[2])
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in [env.get("PYTHONPATH")] if p])
    for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
        env.pop(k, None)
    logs = [workdir / f"rank{rank}.log" for rank in range(world)]
    procs = []
    try:
        for rank in range(world):
            with open(logs[rank], "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "smoothmesh_torch.parallel.ranks",
                     str(job_path), str(rank), str(world)], env=env,
                    cwd=root, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.poll() for p in procs]
            failed = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if failed or None not in codes:
                break
            if time.monotonic() > deadline:
                raise TimeoutError(f"the ranks ran past {timeout_s} s")
            time.sleep(0.05)
    finally:
        for p in procs:             # the others wait for the failed one
            if p.poll() is None:
                p.kill()
            p.wait()
    if failed:
        rank = failed[0]
        raise RuntimeError(f"rank {rank} exited with "
                           f"{procs[rank].returncode}:\n"
                           f"{logs[rank].read_text()}")
    out = []
    for rank in range(world):
        with open(workdir / f"rank{rank}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(job_path: str, rank: int, world: int) -> None:
    import resource

    import torch.distributed as dist

    from smoothmesh_torch import kernels
    from smoothmesh_torch.device import resolve_device
    from smoothmesh_torch.parallel.halo import HaloSmoother
    from smoothmesh_torch.parallel.sharded import ShardedSmoother

    torch.set_num_threads(1)
    with open(job_path, "rb") as f:
        job: Job = pickle.load(f)
    workdir = Path(job_path).parent
    device = join(resolve_device(job.device), rank, world,
                  backend=job.backend,
                  store=dist.FileStore(str(workdir / "store"), world))
    try:
        dtype = None if job.dtype is None else getattr(torch, job.dtype)
        cls = {"halo": HaloSmoother,
               "disjoint": ShardedSmoother}[job.decomposition]
        sm = cls(job.mesh, job.params, device=device, dtype=dtype,
                 distributed=True)
        if job.geometry is not None:
            sm.enable_boundary_smoothing(*job.geometry)
        results = sm.steps(job.n_steps)
        out = dict(points=sm.points.cpu(),
                   results=[dataclasses.astuple(r) for r in results],
                   denormalized=sm.denormalize(), quality=sm.quality(),
                   setup_times=sm.setup_times, backend=dist.get_backend(),
                   device=str(sm.device),
                   launches={k.name: k.launches for k in kernels.ALL},
                   host_peak_rss_kib=resource.getrusage(
                       resource.RUSAGE_SELF).ru_maxrss)
        with open(workdir / f"rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
