"""Profile K4 (the freezes) and K5 (the edge face angles) on one CUDA
card (H100) at the first iteration's inputs of the 128^3 default cell.

Sets up the 128^3 bench mesh (graded, perturbed, its "top"/"rest"
patches) with the default parameters (face angle on, boundary points
fixed), records the inputs of K4 and K5 on the first iteration, and
reports for each kernel:

- its registers, shared memory and spills (``-Xptxas -v``), the
  theoretical occupancy they allow, its SASS instruction mix and the
  static instruction count of each loop (a backward branch and its
  target; ``cuobjdump -sass``, written to ``--out``, by default the
  git-ignored build directory);
- its median device time (CUDA events, ``--reps`` launches), and K4
  with its edge-angle loop off (``edge_angle_on = 0``);
- each kernel against its plain version on these inputs (K4: mask
  mismatches at the main thresholds and at tight ones, 3 x the minimum
  edge length and 60 degrees; K5: values not bit-equal);
- with ``--variants``, timed variants built from the checkout's own
  sources with textual edits (each only where its text is found): K4
  with its divisions replaced by multiplications and K4 with its
  neighbour gathers replaced by reads of a few hot rows (both timing
  only, wrong values); K5 with one face projection per cell slot and
  K5 with its gathers of face means replaced by hot rows; both kernels
  at 64 and 128 threads a block.

Is a kernel bound by its issue rate (the divisions, the loop off), by
its scattered gathers (the hot rows) or by latency (the block sizes)?

``--root`` is the checkout whose ``smoothmesh_torch`` is profiled
(default: this repository); ``--topo`` names a pickle of the compiled
topology (written when missing, read otherwise), so that two checkouts
profiled in one call share one compile.  Every time is printed with the
card's name and power limit.

Run from the repository root on a machine with a CUDA card:
    python experiments/torch_k4_k5_profile.py [--root DIR] [--topo FILE]
        [--reps 50] [--variants] [--out DIR]
"""

import argparse
import collections
import json
import math
import os
import pickle
import re
import subprocess
import sys
import time

import numpy as np

from torch_k8_k3_profile import (TOP_PATCHES, build_variant, device_ms,
                                 occupancy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: the tables of the plain versions of K4 and K5
PLAIN_KEYS = {"point_points", "point_points_mask", "point_faces_mask",
              "wedge_prev", "wedge_next", "edges", "edge_faces",
              "edge_faces_mask", "edge_cells", "edge_cells_mask",
              "edge_cell_f0", "edge_cell_f1"}


def sass(cuobjdump, lib, path):
    """Dump the SASS of ``lib`` to ``path`` -> {function: (Counter of
    opcodes, [(loop start, loop end, instructions, Counter)])}: a loop
    is a backward branch and the instructions from its target to it."""
    txt = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120).stdout
    with open(path, "w") as f:
        f.write(txt)
    funcs, fn = {}, None
    for line in txt.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            fn = m.group(1)
            funcs[fn] = []
            continue
        m = re.match(r"\s+/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)(.*)", line)
        if m and fn:
            funcs[fn].append((int(m.group(1), 16),
                              m.group(3).split(".")[0], m.group(4)))
    out = {}
    for fn, ins in funcs.items():
        mix = collections.Counter(op for _, op, _ in ins)
        loops = []
        for addr, op, rest in ins:
            t = re.search(r"0x([0-9a-f]+)", rest)
            if op == "BRA" and t and int(t.group(1), 16) < addr:
                lo = int(t.group(1), 16)
                body = [o for a, o, _ in ins if lo <= a <= addr]
                loops.append((lo, addr, len(body),
                              collections.Counter(body)))
        out[fn] = (mix, loops)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--topo")
    ap.add_argument("--side", type=int, default=128)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "smoothmesh_torch", "build", "k4k5_profile"))
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.makedirs(args.out, exist_ok=True)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from smoothmesh_torch import kernels
    from smoothmesh_torch.device import to_device
    from smoothmesh_torch.driver import (KERNEL_STAGES, Smoother, Stages,
                                         iteration_body)
    from smoothmesh_torch.mesh.blockmesh import hex_block, perturb
    from smoothmesh_torch.mesh.tiling import permute_mesh
    from smoothmesh_torch.mesh.topology import compile_topology
    from smoothmesh_torch.ops import constraints as con
    from smoothmesh_torch.params import SmoothingParams

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"{smi}; torch {torch.__version__}; profiling {root}", flush=True)
    kernels.build_all()
    tag = os.path.basename(root.rstrip("/")) or "root"
    record = {"card": smi, "root": root}
    ks = {"K4": kernels.FREEZE, "K5": kernels.FACE_ANGLES}
    cuobjdump = os.path.join(os.path.dirname(kernels.nvcc_path()),
                             "cuobjdump")
    for name, k in ks.items():
        for fn, regs, smem, spill in k.resources():
            occ = {b: occupancy(regs, smem, b) for b in (64, 128, 256)}
            print(f"{name} {fn[:60]}: {regs} registers, {smem} bytes "
                  f"shared (static), {spill} bytes spilled; theoretical "
                  f"(blocks, warps) per SM at 64 / 128 / 256 threads a "
                  f"block: {occ}", flush=True)
            record.setdefault(name, {})["ptxas"] = [fn, regs, smem, spill]
        if os.path.exists(cuobjdump):
            for fn, (mix, loops) in sass(
                    cuobjdump, k.library_path(),
                    os.path.join(args.out, f"{name}-{tag}.sass")).items():
                print(f"{name} SASS {fn[:60]}: {sum(mix.values())} "
                      f"instructions; {dict(mix.most_common(16))}",
                      flush=True)
                for lo, hi, n, c in loops:
                    print(f"  loop 0x{lo:x}-0x{hi:x}: {n} instructions; "
                          f"{dict(c.most_common(12))}", flush=True)
                record.setdefault(name, {})["sass"] = [
                    sum(mix.values()), [n for _, _, n, _ in loops]]

    base = hex_block(n=(args.side,) * 3, grading=(2.0, 1.0, 0.5),
                     patches=TOP_PATCHES)
    min_spacing = min(np.diff(np.unique(base.points[:, a])).min()
                      for a in range(3))
    mesh, _ = permute_mesh(perturb(base, amplitude=0.25 * min_spacing,
                                   seed=3))
    t0 = time.perf_counter()
    if args.topo and os.path.exists(args.topo):
        with open(args.topo, "rb") as f:
            topo = pickle.load(f)
    else:
        topo = compile_topology(mesh)
        if args.topo:
            with open(args.topo, "wb") as f:
                pickle.dump(topo, f, protocol=pickle.HIGHEST_PROTOCOL)
    sm = Smoother(mesh, SmoothingParams(rel_tol=0.0), topo=topo,
                  device="cuda")
    print(f"set-up {time.perf_counter() - t0:.1f} s", flush=True)
    rec = {}

    def recording(name, fn):
        def call(*a):
            rec[name] = a
            return fn(*a)
        return call

    stages = Stages(*(recording(n, f) for n, f in
                      zip(Stages._fields, KERNEL_STAGES)))
    iteration_body(sm.points, sm.td, sm.params, sm._scale, stages)
    torch.cuda.synchronize()
    td = dict(sm.td)
    td.update(to_device(topo, "cuda", PLAIN_KEYS - set(td)))
    k4 = rec["freeze_constraints"][:2] + (td,) \
        + rec["freeze_constraints"][3:]
    pts, means, cc = rec["face_angles_per_point"][:3]
    k5 = (pts, means, cc, td)
    n_pts, wp = td["point_points"].shape
    wf = td["point_faces_mask"].shape[1]
    n_edges, wef = td["edge_faces"].shape
    wec = td["edge_cells"].shape[1]
    print(f"K4 inputs: {n_pts} points, point_points width {wp}, wedges "
          f"width {wf}, {int(td['point_points_mask'].sum())} neighbour and "
          f"{int(td['point_faces_mask'].sum())} wedge slots; K5 inputs: "
          f"{n_edges} edges, edge_faces width {wef}, edge_cells width "
          f"{wec}, {int(td['edge_cells_mask'].sum())} cell slots, "
          f"{int(td['edge_faces_mask'].sum())} face slots", flush=True)
    record["shapes"] = dict(points=n_pts, wp=wp, wf=wf, edges=n_edges,
                            wef=wef, wec=wec)

    min_edge = k4[3]
    tight = k4[:3] + (3.0 * min_edge, k4[4], math.radians(60.0)) + k4[6:]
    no_angle = k4[:6] + (False,) + k4[7:]

    def check(label):
        out = {}
        for name, a in (("main", k4), ("tight", tight)):
            got = con.freeze_constraints(*a)
            want = con.freeze_constraints_plain(*a)
            out[f"K4 {name} mismatches"] = int((got != want).sum())
            out[f"K4 {name} frozen"] = int(want.sum())
        got = con.edge_face_angles(*k5)
        want = con.edge_face_angles_plain(*k5)
        out["K5 values not bit-equal"] = int(
            (got.view(torch.int32) != want.view(torch.int32)).sum())
        out["K5 max abs err"] = float((got - want).abs().max())
        print(f"[{label}] against the plain versions: {out}", flush=True)
        return out

    def time_all(label):
        t = {"K4": device_ms(torch, lambda: con.freeze_constraints(*k4),
                             args.reps),
             "K4 edge angle off": device_ms(
                 torch, lambda: con.freeze_constraints(*no_angle),
                 args.reps),
             "K5": device_ms(torch, lambda: con.edge_face_angles(*k5),
                             args.reps)}
        print(f"[{label}] " + ", ".join(f"{k} {v:.4f} ms"
                                        for k, v in t.items())
              + f" on {smi}", flush=True)
        record.setdefault("times", {})[label] = t
        return t

    record["check"] = check("as built")
    time_all("as built")

    if args.variants:
        k4_src = open(kernels.FREEZE.source_path).read()
        k5_src = open(kernels.FACE_ANGLES.source_path).read()
        variants = []

        def variant(kernel, src, fname, name, subs):
            if all(old in src for old, _ in subs):
                variants.append((kernel, name, {fname: subs}))
            else:
                print(f"variant {name}: its text is not in {fname}",
                      flush=True)

        # K4: the divisions as multiplications (timing only)
        variant(kernels.FREEZE, k4_src, "freeze.cu", "k4_nodiv",
                [("smk::dot(v1, v2) /", "smk::dot(v1, v2) *")])
        variant(kernels.FREEZE, k4_src, "freeze.cu", "k4_mul",
                [("d = smk::div_seq(dc, den);", "d = dc * den;")])
        # K4: neighbour gathers from a few hot rows (timing only)
        variant(kernels.FREEZE, k4_src, "freeze.cu", "k4_hot", [
            ("smk::load3(points, __ldg(row + w))", "smk::load3(points, w)"),
            ("smk::load3(points, a)", "smk::load3(points, k)"),
            ("smk::load3(points, b)", "smk::load3(points, k + 1)"),
            ("smk::load3(proposed, a)", "smk::load3(proposed, k)"),
            ("smk::load3(proposed, b)", "smk::load3(proposed, k + 1)")])
        variant(kernels.FREEZE, k4_src, "freeze.cu", "k4_hotrows", [
            ("const int j = row[w];", "const int j = w;")])
        # K5: one face projection per cell slot (timing only)
        variant(kernels.FACE_ANGLES, k5_src, "face_angles.cu", "k5_oneproj",
                [("const V3 p1 = proj_unit(ctr, ev, smk::load3(means, "
                  "__ldg(frow + s1)));", "const V3 p1 = p0;")])
        # K5: the divisions as multiplications (timing only)
        variant(kernels.FACE_ANGLES, k5_src, "face_angles.cu", "k5_mul",
                [("return smk::div_seq(x, y);", "return x * y;")])
        # K5: the face means from a few hot rows (timing only)
        variant(kernels.FACE_ANGLES, k5_src, "face_angles.cu", "k5_hot", [
            ("smk::load3(means, __ldg(frow + s0))", "smk::load3(means, s0)"),
            ("smk::load3(means, __ldg(frow + s1))", "smk::load3(means, s1)")])
        variant(kernels.FACE_ANGLES, k5_src, "face_angles.cu",
                "k5_hotmeans", [("smk::load3(means, __ldg(frow + s))",
                                 "smk::load3(means, s)")])
        for blk in (256, 128, 64):
            for kernel, src, fname, tag_ in (
                    (kernels.FREEZE, k4_src, "freeze.cu", "k4"),
                    (kernels.FACE_ANGLES, k5_src, "face_angles.cu", "k5")):
                if "smk::kBlock" in src:
                    if blk != 256:
                        variants.append((kernel, f"{tag_}_block{blk}", {
                            "common.cuh": [(
                                "constexpr int kBlock = 256;",
                                f"constexpr int kBlock = {blk};")]}))
                    continue
                m = re.search(r"constexpr int kThreads = (\d+);", src)
                if m and int(m.group(1)) != blk:
                    variant(kernel, src, fname, f"{tag_}_block{blk}",
                            [(m.group(0), f"constexpr int kThreads = {blk};")])
        for k, name, edits in variants:
            try:
                fn, ptx = build_variant(kernels, k, name, edits, args.out)
            except RuntimeError as e:
                print(f"variant {name} not built: {e}", flush=True)
                continue
            saved = k._fn
            k._fn = fn
            try:
                time_all(f"{name} {ptx[0][1:] if ptx else ''}")
            finally:
                k._fn = saved

    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
