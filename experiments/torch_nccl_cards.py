#!/usr/bin/env python3
"""Both domain decompositions one rank a card over NCCL, on several
cards, held bit for bit against the same decomposition with all its
shards in one process on one card (``UnionSync`` / ``UnionPointSync``).

For each world size W of ``--worlds`` (each at most the card count):
``run_ranks`` starts W NCCL ranks, rank r on cuda:r, each running its
shard of bench.py's mesh (``--side``^3, the default parameters) for
``--iters`` steps; the same class with W shards runs them in this
process on cuda:0.  Required, as ``chip_smoke.py`` phase 12 requires
them: each rank under NCCL on its own card, the results, each rank's
union rows and ``denormalize()`` bit-equal, ``quality()`` within 1e-12
relative, K1-K7 launched in rank 0.  Prints a line per run with both
forms' ms/iteration, then one JSON line of the figures.

    python3 experiments/torch_nccl_cards.py --worlds 2 4
    python3 experiments/torch_nccl_cards.py --device cpu --side 12 \\
        --iters 4 --worlds 2 4        # rehearsal: gloo ranks on the CPU
"""

from __future__ import annotations

import argparse
import concurrent.futures
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worlds", type=int, nargs="+", default=[2])
    ap.add_argument("--side", type=int, default=cs.MAIN_SIDE)
    ap.add_argument("--iters", type=int, default=cs.MAIN_ITERS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    from smoothmesh_torch.parallel.halo import HaloSmoother
    from smoothmesh_torch.parallel.sharded import ShardedSmoother
    from smoothmesh_torch.params import SmoothingParams

    if args.device == "cuda":
        n_cards = torch.cuda.device_count()
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip()
        print(f"{n_cards} card(s), NCCL "
              f"{'.'.join(map(str, torch.cuda.nccl.version()))}:\n{smi}",
              flush=True)
        smi = smi.splitlines()[0]
        if max(args.worlds) > n_cards:
            print(f"--worlds {args.worlds}: this machine has {n_cards} "
                  "card(s)", file=sys.stderr)
            return 1
    else:
        smi = "the CPU"
    mesh = cs.bench_mesh(args.side)
    params = SmoothingParams(centroidal_iters=args.iters, rel_tol=0.0)
    figures = {}
    with tempfile.TemporaryDirectory(prefix="nccl_cards_") as tmp, \
            concurrent.futures.ThreadPoolExecutor(1) as pool:
        for world in args.worlds:
            for label, cls, kw in (
                    ("halo", HaloSmoother, {}),
                    ("disjoint", ShardedSmoother,
                     dict(decomposition="disjoint"))):
                name = f"{label} {args.side}^3, world {world}"
                cs.wall_clock(name)
                fig = cs.ranks_against_union(
                    name, cls, mesh, params, args.iters, None, kw, world,
                    os.path.join(tmp, f"{label}{world}"), pool, smi,
                    args.device)
                figures[name] = {k: v for k, v in fig.items()
                                 if k != "rank0_setup_s"}
    print(json.dumps({"nccl_cards": figures, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
