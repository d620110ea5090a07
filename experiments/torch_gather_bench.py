#!/usr/bin/env python3
"""Why PyTorch's gathers are slow on the quality report's face rows.

On the 128^3 bench mesh, `chip_smoke.py` times K7 (the table gather)
beside `torch.index_select` + the mask's `where`: 0.39 ms on the
`point_cells` table (C = 3) but 7.8 ms on `cell_faces` (C = 4), where
K7 takes ~0.15 ms on both.  This script times the variants that tell
the candidate causes apart, on the same tables (CUDA events, median of
20 launches):

- the index's type (int32 as the topology stores it, or int64);
- the row width (C = 3 and C = 4, and C = 4 moved as two float64);
- the size of the source (all F face rows, or indices folded into the
  first 2^21 rows, which fit the 50 MB L2 cache);
- the access pattern (the topology's table, or the same number of
  indices drawn at random);
- the source's row count alone (the folded index into a source cut
  to 2^21 rows; the `point_cells` index into a source padded to the
  face count);
- the index's length: random indices into the source, 12,582,912
  (= 3 * 2^22, the `cell_faces` slot count) and one more and one less.

Run on the card from the repository root:
    python3 experiments/torch_gather_bench.py [--side 128]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from smoothmesh_torch import kernels  # noqa: E402
from smoothmesh_torch.device import to_device  # noqa: E402
from smoothmesh_torch.mesh.blockmesh import hex_block, perturb  # noqa: E402
from smoothmesh_torch.mesh.tiling import permute_mesh  # noqa: E402
from smoothmesh_torch.mesh.topology import compile_topology  # noqa: E402
from smoothmesh_torch.ops.gather import table_gather  # noqa: E402


def device_ms(fn, reps: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(reps):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in pairs]))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--side", type=int, default=128)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    kernels.build_all()
    n = args.side
    base = hex_block(n=(n, n, n), grading=(2.0, 1.0, 0.5))
    spacing = min(np.diff(np.unique(base.points[:, a])).min()
                  for a in range(3))
    t0 = time.perf_counter()
    topo = compile_topology(permute_mesh(
        perturb(base, amplitude=0.25 * spacing, seed=3))[0])
    print(f"{n}^3 topology in {time.perf_counter() - t0:.1f} s", flush=True)
    td = to_device(topo, "cuda", keys=["cell_faces", "cell_faces_mask",
                                       "point_cells", "point_cells_mask"])
    gen = torch.Generator(device="cuda").manual_seed(0)
    for name, n_src, c in (("cell_faces", topo.n_faces, 4),
                           ("point_cells", topo.n_cells, 3)):
        table, mask = td[name], td[f"{name}_mask"]
        m, w = table.shape
        x = torch.rand((n_src, c), generator=gen, device="cuda")
        flat32 = table.flatten()
        flat64 = flat32.long()
        rand64 = torch.randint(0, n_src, flat64.shape, generator=gen,
                               device="cuda")
        fold64 = flat64 % min(n_src, 1 << 21)
        gathered = torch.index_select(x, 0, flat32).view(m, w, c)
        cases = [
            ("K7 table_gather", lambda: table_gather(x, table, mask)),
            ("index_select, int32 index",
             lambda: torch.index_select(x, 0, flat32)),
            ("index_select, int64 index",
             lambda: torch.index_select(x, 0, flat64)),
            ("advanced indexing x[int64]", lambda: x[flat64]),
            ("where over the gathered rows alone",
             lambda: torch.where(mask[..., None], gathered, 0.0)),
            ("index_select, random int64 index",
             lambda: torch.index_select(x, 0, rand64)),
            ("index_select, index folded into 2^21 rows",
             lambda: torch.index_select(x, 0, fold64)),
        ]
        small = x[:1 << 21].contiguous()
        big = torch.rand((topo.n_faces, c), generator=gen, device="cuda")
        cases += [
            ("index_select, folded index, source cut to 2^21 rows",
             lambda: torch.index_select(small, 0, fold64)),
            (f"index_select, source of {topo.n_faces} rows",
             lambda: torch.index_select(big, 0, flat64)),
        ]
        for k in (3 << 22, (3 << 22) + 1, (3 << 22) - 1):
            idx = torch.randint(0, n_src, (k,), generator=gen, device="cuda")
            cases.append((f"index_select, {k} random indices",
                          lambda idx=idx: torch.index_select(x, 0, idx)))
        if c == 4:
            x2 = x.view(torch.float64)
            cases.append(("index_select of C = 4 as two float64",
                          lambda: torch.index_select(x2, 0, flat64)))
        for label, fn in cases:
            ms = device_ms(fn)
            print(f"{name} ({m} x {w}, C = {c}, {n_src} source rows): "
                  f"{label}: {ms:.4f} ms on {smi}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
