"""The readings that the limits of ``run.py``'s check are set from.

For each seed: the cell's program at its own size runs one whole job
from the start state (the mix's longest), then the checked segments
exactly as ``run.py`` reads them; the plain reference (float64)
follows each.  With ``--control``, the control runs in the program's
place on the same segments: the reference itself in bfloat16, the
precision below the configuration's float32.  Prints one JSON line a
seed: ``program`` is the sound reading of each number, ``control``
the control's.  ``--traffic FILE`` reads another mix file in place of
the cell's, so that a mix's limits can be set before a cell runs it.

    python benchmark/calibrate.py --workload hex128.default \\
        --seeds 11 12 13 --control
"""

import argparse
import json
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(1, str(HERE.parent))

import torch  # noqa: E402

from harness import check, reftopo  # noqa: E402
from harness.cells import Cell  # noqa: E402
from harness.program import Program  # noqa: E402


def readings(cell: Cell, seed: int, control: bool, device="cuda",
             config=None) -> dict:
    mix = cell.mix
    t0 = time.perf_counter()
    prog = Program(cell.config if config is None else config, mix, seed,
                   device)
    prog.setup()
    n_iters = len(prog.job())
    segs, _ = check.read_program(prog, mix, n_iters, seed)
    mesh = prog.mesh
    prog.close()
    dev = torch.device(device)
    T = reftopo.build(mesh, dev)
    config = prog.config
    out = dict(seed=seed, job_iterations=n_iters,
               program=check.judge(mesh, config, mix, segs, T, dev))
    if control:
        ctl = check.control_segments(mesh, config, mix, segs, T, dev)
        out["control"] = check.judge(mesh, config, mix, ctl, T, dev)
    out["seconds"] = time.perf_counter() - t0
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--traffic", type=Path,
                    help="a mix file in place of the cell's")
    args = ap.parse_args()
    cell = Cell(args.workload)
    if args.traffic is not None:
        cell.mix = json.loads(args.traffic.read_text())
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, args.control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
