#!/usr/bin/env python3
"""Both domain decompositions over several cards in one process, one
host thread a card (``devices=``, ``smoothmesh_torch.parallel.cards``),
against the same decomposition's union on one card and its NCCL ranks
(one process a card, ``parallel.ranks``), on bench.py's mesh
(``--side``^3, the default parameters, ``--iters`` steps).

For each world size W of ``--worlds`` (each at most the card count) and
each decomposition:

  - the card group (``cls(mesh, params, devices=cuda:0..W-1)``) in a
    process of its own: its host set-up seconds (the constructor's
    wall) and the process's host peak RSS after its steps, its
    ms/iteration (the last batch's wall over its iterations, eager);
    then in the same process the union of W shards on cuda:0 (its
    batch captured; the shards built once for both), held bit for bit
    (results, points, ``denormalize()``) and its ms/iteration;
  - W NCCL ranks (``run_ranks``), their last batch's ms/iteration, the
    host set-up seconds (shard build, union, upload) and host peak RSS
    summed over the ranks, held bit for bit against the group (results,
    ``denormalize()``).

``--big-side S`` (with ``--dtype float64``) then runs the disjoint
decomposition's group alone on all the machine's cards (two CPU members
with ``--device cpu``) at S^3 (``--big-iters`` steps): a mesh one card
cannot hold; finite residuals and points, each card's peak memory.
Prints a line per run and one JSON line of the figures.

    python3 experiments/torch_cards_in_process.py --worlds 2 4
    python3 experiments/torch_cards_in_process.py --worlds \\
        --big-side 288 --big-iters 8      # the big mesh alone
    python3 experiments/torch_cards_in_process.py --device cpu \\
        --side 12 --iters 4 --worlds 2 3     # rehearsal on the CPU
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import resource
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

KINDS = ("halo", "disjoint")


def _classes():
    from smoothmesh_torch.parallel.halo import HaloSmoother
    from smoothmesh_torch.parallel.sharded import ShardedSmoother

    return {"halo": HaloSmoother, "disjoint": ShardedSmoother}


def _devices(device: str, world: int) -> list:
    if device == "cuda":
        return [torch.device("cuda", i) for i in range(world)]
    return [torch.device("cpu")] * world


def _row(r) -> tuple:
    return dataclasses.astuple(r)[:3] + dataclasses.astuple(r)[4:]


def _peak_rss_gib() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def group_run(args) -> dict:
    """One card group and its union in this process (``--group KIND W``)
    -> the figures; its ``denormalize()`` and results go to
    ``--out``."""
    from smoothmesh_torch.params import SmoothingParams

    kind, world = args.group[0], int(args.group[1])
    cls = _classes()[kind]
    devices = _devices(args.device, world)
    mesh = cs.bench_mesh(args.side)
    params = SmoothingParams(centroidal_iters=args.iters, rel_tol=0.0)
    with cs.memo_shards(_classes().values()):
        t0 = time.perf_counter()
        group = cls(mesh, params, devices=devices)
        setup_s = time.perf_counter() - t0
        got = group.steps(args.iters)
        rss = _peak_rss_gib()
        den = group.denormalize()
        pts = group.points.cpu()
        un = cls(mesh, params, n_shards=world, device=devices[0])
        un.prepare_batch()
        want = un.steps(args.iters)
    cs.require([_row(r) for r in got] == [_row(r) for r in want],
               f"{kind} group of {world}: results differ from the union's")
    cs.require(torch.equal(pts, un.points.cpu()),
               f"{kind} group of {world}: points not bit-equal")
    cs.require(np.array_equal(den, un.denormalize()),
               f"{kind} group of {world}: denormalize() not bit-equal")
    cs.require(cs.card_holders_identical(group, un),
               f"{kind} group of {world}: the holders of a shared point "
               "differ")
    np.save(args.out, den)
    return dict(ms_group=got[-1].wall_ms, ms_group_first=got[0].wall_ms,
                ms_union=want[-1].wall_ms, setup_s_group=setup_s,
                host_peak_rss_gib_group=rss,
                results=[_row(r) for r in got])


def big_run(args, world: int) -> dict:
    """The disjoint decomposition's group alone at ``--big-side``^3 on
    ``world`` cards -> the figures."""
    from smoothmesh_torch.params import SmoothingParams

    cls = _classes()["disjoint"]
    dtype = getattr(torch, args.dtype)
    devices = _devices(args.device, world)
    t0 = time.perf_counter()
    mesh = cs.bench_mesh(args.big_side)
    t_mesh = time.perf_counter() - t0
    params = SmoothingParams(centroidal_iters=args.big_iters, rel_tol=0.0)
    t0 = time.perf_counter()
    group = cls(mesh, params, devices=devices, dtype=dtype)
    setup_s = time.perf_counter() - t0
    got = group.steps(args.big_iters)
    den = group.denormalize()
    cs.require(all(np.isfinite(r.residual) for r in got)
               and bool(np.isfinite(den).all()),
               f"{args.big_side}^3: residuals or points not finite")
    cs.require(float(np.abs(den - mesh.points).max()) > 0,
               f"{args.big_side}^3: no point moved")
    peak = ([torch.cuda.max_memory_allocated(d) / 1e9 for d in devices]
            if args.device == "cuda" else None)
    return dict(side=args.big_side, cells=mesh.n_cells,
                points=mesh.n_points, dtype=args.dtype, world=world,
                mesh_s=t_mesh, setup_s_group=setup_s,
                host_peak_rss_gib=_peak_rss_gib(),
                ms_group=got[-1].wall_ms, ms_group_first=got[0].wall_ms,
                residuals=[r.residual for r in got],
                n_frozen=[r.n_frozen for r in got], peak_gb_per_card=peak)


def ranks_run(args, kind: str, world: int, workdir: str) -> tuple:
    """``world`` NCCL ranks (gloo on the CPU) -> (their figures, rank 0's
    output)."""
    from smoothmesh_torch.parallel.ranks import Job, run_ranks
    from smoothmesh_torch.params import SmoothingParams

    mesh = cs.bench_mesh(args.side)
    params = SmoothingParams(centroidal_iters=args.iters, rel_tol=0.0)
    on_card = args.device == "cuda"
    job = Job(mesh, params, args.iters, device=args.device,
              backend="nccl" if on_card else "gloo", decomposition=kind)
    ranks = run_ranks(job, world, workdir, cs.NCCL_TIMEOUT_S)
    setup = sum(r["setup_times"][k] for r in ranks
                for k in ("shard build", "union", "upload"))
    return dict(ms_ranks=ranks[0]["results"][-1][3],
                ms_ranks_first=ranks[0]["results"][0][3],
                setup_s_ranks_summed=setup,
                host_peak_rss_gib_ranks_summed=sum(
                    r["host_peak_rss_kib"] for r in ranks) / 2**20), ranks[0]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, nargs="*", default=[2])
    ap.add_argument("--side", type=int, default=cs.MAIN_SIDE)
    ap.add_argument("--iters", type=int, default=cs.MAIN_ITERS)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--big-side", type=int, default=None)
    ap.add_argument("--big-iters", type=int, default=8)
    ap.add_argument("--dtype", default="float64")
    ap.add_argument("--group", nargs=2, default=None,
                    help=argparse.SUPPRESS)   # KIND WORLD: a child run
    ap.add_argument("--out", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.group is not None:
        print(json.dumps(group_run(args)))
        return 0

    if args.device == "cuda":
        n_cards = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
        peers = {f"{a}->{b}": torch.cuda.can_device_access_peer(a, b)
                 for a in range(n_cards) for b in range(n_cards) if a != b}
        print(f"{n_cards} card(s), peer access {peers}:\n{smi}", flush=True)
        smi = smi.splitlines()[0]
        if max(args.worlds, default=0) > n_cards:
            print(f"--worlds {args.worlds}: this machine has {n_cards} "
                  "card(s)", file=sys.stderr)
            return 1
    else:
        smi = "the CPU"
    figures = {}
    with tempfile.TemporaryDirectory(prefix="cards_") as tmp:
        for world in args.worlds:
            for kind in KINDS:
                name = f"{kind} {args.side}^3, world {world}"
                cs.wall_clock(f"{name}: the card group")
                out = os.path.join(tmp, f"{kind}{world}.npy")
                proc = subprocess.run(
                    [sys.executable, os.path.abspath(__file__), "--group",
                     kind, str(world), "--out", out, "--side",
                     str(args.side), "--iters", str(args.iters),
                     "--device", args.device], capture_output=True,
                    text=True, cwd=ROOT, timeout=1800)
                if proc.returncode != 0:
                    print(proc.stdout[-3000:], proc.stderr[-3000:],
                          file=sys.stderr)
                    return 1
                fig = json.loads(proc.stdout.strip().splitlines()[-1])
                cs.wall_clock(f"{name}: the ranks")
                rfig, rank0 = ranks_run(args, kind, world,
                                        os.path.join(tmp, f"r{kind}{world}"))
                cs.require([tuple(x[:3] + x[4:]) for x in rank0["results"]]
                           == [tuple(x) for x in fig.pop("results")],
                           f"{name}: the ranks' results differ from the "
                           "group's")
                cs.require(np.array_equal(rank0["denormalized"],
                                          np.load(out)),
                           f"{name}: the ranks' points differ from the "
                           "group's")
                fig.update(rfig)
                figures[name] = fig
                print(f"{name} on {smi}: the group bit-equal to the union "
                      "on one card and to the NCCL ranks; ms/iteration "
                      f"(last batch) group {fig['ms_group']:.4f}, ranks "
                      f"{fig['ms_ranks']:.4f}, union {fig['ms_union']:.4f};"
                      f" host set-up s group {fig['setup_s_group']:.2f}, "
                      f"ranks summed {fig['setup_s_ranks_summed']:.2f}; "
                      "host peak RSS GiB group "
                      f"{fig['host_peak_rss_gib_group']:.2f}, ranks summed "
                      f"{fig['host_peak_rss_gib_ranks_summed']:.2f}",
                      flush=True)
    if args.big_side:
        world = torch.cuda.device_count() if args.device == "cuda" else 2
        cs.wall_clock(f"disjoint {args.big_side}^3 {args.dtype}, world "
                      f"{world}")
        fig = big_run(args, world)
        figures[f"disjoint {args.big_side}^3 {args.dtype}, world {world}"] \
            = fig
        print(f"disjoint {args.big_side}^3 in {args.dtype} on {world} "
              f"cards ({fig['cells']} cells) on {smi}: set-up "
              f"{fig['setup_s_group']:.1f} s, {fig['ms_group']:.2f} "
              f"ms/iteration, peak GB per card {fig['peak_gb_per_card']}, "
              f"host peak RSS {fig['host_peak_rss_gib']:.1f} GiB",
              flush=True)
    print(json.dumps({"cards_in_process": figures, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
