"""Profile K1 (face geometry) and K2 (cell centres and volumes) on one
CUDA card (H100) at the first iteration's inputs of the 128^3 default
cell.

Sets up the 128^3 bench mesh (graded, perturbed, its "top"/"rest"
patches) with the default parameters, records the inputs of K1 and K2
on the first iteration, and reports for each kernel:

- its registers, shared memory and spills (``-Xptxas -v``), the
  theoretical occupancy they allow, its SASS instruction mix and the
  static instruction count of each loop (``cuobjdump -sass``, written
  to ``--out``, by default the git-ignored build directory);
- its median device time (CUDA events, ``--reps`` launches) and its
  byte bound (each input read once, each output written once, over
  3.35 TB/s; K2 on the tables it reads, and on owner + cell_faces +
  cell_faces_mask where it reads the cell-face words);
- each kernel against its plain version on these inputs (values not
  bit-equal, max abs error);
- with ``--variants``, timed variants built from the checkout's own
  sources with textual edits (each only where its text is found, so one
  list serves the two-pass kernels, whose thread walks its row twice,
  and the register-row designs; all timing only, their values are not
  checked): hot rows (every thread reads the first row: the gathers'
  scatter and the row reads gone), stores dropped (behind a test that
  never holds), stores coalesced through shared memory (the two-pass
  kernels), divisions as multiplications, blocks of 128 in place of
  256, a minimum of 6, 8 or (at 128 threads) 12 blocks an SM (registers
  capped), for the two-pass K2 its sign taken without the owner gather,
  and for the register-row K2 the area vectors held in registers with
  the centres.

Is a kernel bound by its gathers (hot rows), its stores, its divisions
or its occupancy (the block size)?

``--root`` is the checkout whose ``smoothmesh_torch`` is profiled
(default: this repository); ``--topo`` names a pickle of the compiled
topology (written when missing, read otherwise), so that two checkouts
profiled in one call share one compile.  Every time is printed with the
card's name and power limit.

Run from the repository root on a machine with a CUDA card:
    python experiments/torch_k1_k2_profile.py [--root DIR] [--topo FILE]
        [--reps 50] [--variants] [--out DIR]
"""

import argparse
import json
import os
import pickle
import subprocess
import sys
import time

import numpy as np

from torch_k4_k5_profile import sass
from torch_k8_k3_profile import (TOP_PATCHES, build_variant, device_ms,
                                 occupancy)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12
#: the tables of K2's plain version
PLAIN_KEYS = {"owner", "cell_faces", "cell_faces_mask"}
#: a test that never holds: the stores stay in the code, never run
NEVER = "if (fc.x == 1.2345e-37f)"
NEVER2 = "if (cc.x == 1.2345e-37f)"
NEVER3 = "if (vol3 == 1.2345e-37f)"
#: the two-pass kernels' stores coalesced through shared memory,
#: inlined (common.cuh has no staging helpers)
STAGE_DECL = ("  __shared__ __align__(16) float buf[3][3 * smk::kBlock];\n"
              "  const int row0 = blockIdx.x * smk::kBlock;\n")
STAGE_FLUSH = """
  {
    float* out[3] = {%s};
    const V3 val[3] = {%s};
    for (int o = 0; o < %d; ++o) {
      buf[o][3 * threadIdx.x] = val[o].x;
      buf[o][3 * threadIdx.x + 1] = val[o].y;
      buf[o][3 * threadIdx.x + 2] = val[o].z;
    }
    __syncthreads();
    const int n_rows = min(smk::kBlock, %s - row0);
    for (int o = 0; o < %d; ++o) {
      float* dst = out[o] + 3 * static_cast<int64_t>(row0);
      if (n_rows == smk::kBlock) {
        for (int i = threadIdx.x; i < 3 * smk::kBlock / 4; i += smk::kBlock)
          reinterpret_cast<float4*>(dst)[i] =
              reinterpret_cast<const float4*>(buf[o])[i];
      } else {
        for (int i = threadIdx.x; i < 3 * n_rows; i += smk::kBlock)
          dst[i] = buf[o][i];
      }
    }
  }
"""


def variants_of(kernels, k1_src, k2_src):
    """[(kernel, name, {file: [(old, new)]})] for the sources' texts."""
    out = []

    def variant(kernel, src, fname, name, subs):
        if all(old in src for old, _ in subs):
            out.append((kernel, name, {fname: subs}))
        else:
            print(f"variant {name}: its text is not in {fname}", flush=True)

    k1, k2 = kernels.FACE_GEOMETRY, kernels.CELL_CENTRES
    f1, f2 = "face_geometry.cu", "cell_centres.cu"
    # hot rows: every thread reads the first row
    variant(k1, k1_src, f1, "k1_hot", [(
        "const int* row = face_points + static_cast<int64_t>(f) * width;",
        "const int* row = face_points;")])
    variant(k2, k2_src, f2, "k2_hot", [(
        "const int64_t base = static_cast<int64_t>(c) * width;",
        "const int64_t base = 0;")])
    variant(k2, k2_src, f2, "k2_hot", [(
        "const int* row = words + static_cast<int64_t>(c) * width;",
        "const int* row = words;")])
    # stores dropped (the two-pass kernels, then the register-row ones)
    old_k1_stores = ("  smk::store3(centres, f, fc);\n"
                     "  smk::store3(areas, f, fa);\n"
                     "  smk::store3(means, f, vm);\n")
    variant(k1, k1_src, f1, "k1_nostore", [(
        old_k1_stores, f"  {NEVER} {{\n{old_k1_stores}  }}\n")])
    old_k2_stores = ("  smk::store3(centres, c, cc);\n"
                     "  vols[c] = vol3 / 3.0f;\n")
    variant(k2, k2_src, f2, "k2_nostore", [(
        old_k2_stores, f"  {NEVER2} {{\n{old_k2_stores}  }}\n")])
    new_k2_stores = ("  smk::store3(centres, c, good ? smk::div3(num, vol3) "
                     ": ce);\n  vols[c] = smk::div1(vol3, 3.0f);\n")
    variant(k2, k2_src, f2, "k2_nostore", [(
        new_k2_stores, f"  {NEVER3} {{\n{new_k2_stores}  }}\n")])
    # the two-pass kernels: stores coalesced through shared memory
    variant(k1, k1_src, f1, "k1_staged", [
        ("  const int f = blockIdx.x * blockDim.x + threadIdx.x;\n"
         "  if (f >= n_faces) return;\n",
         STAGE_DECL + "  const int f = min(row0 + static_cast<int>("
         "threadIdx.x), n_faces - 1);\n"),
        (old_k1_stores, STAGE_FLUSH % ("centres, areas, means",
                                       "fc, fa, vm", 3, "n_faces", 3))])
    variant(k2, k2_src, f2, "k2_staged", [
        ("  const int c = blockIdx.x * blockDim.x + threadIdx.x;\n"
         "  if (c >= n_cells) return;\n",
         STAGE_DECL + "  const int c = min(row0 + static_cast<int>("
         "threadIdx.x), n_cells - 1);\n"),
        (old_k2_stores, "  vols[c] = vol3 / 3.0f;\n"
         + STAGE_FLUSH % ("centres", "cc", 1, "n_cells", 1))])
    # divisions as multiplications
    variant(k1, k1_src, f1, "k1_mul", [
        ("{s.x / cnt, s.y / cnt, s.z / cnt}",
         "{s.x * cnt, s.y * cnt, s.z * cnt}"),
        ("V3{sum_ac.x / den, sum_ac.y / den, sum_ac.z / den}",
         "V3{sum_ac.x * den, sum_ac.y * den, sum_ac.z * den}")])
    variant(k1, k1_src, f1, "k1_mul", [
        ("smk::div3(s, static_cast<float>(n))",
         "smk::scale(static_cast<float>(n), s)"),
        ("smk::div3(sum_ac, den)", "smk::scale(den, sum_ac)")])
    variant(k2, k2_src, f2, "k2_mul", [
        ("{s.x / cnt, s.y / cnt, s.z / cnt}",
         "{s.x * cnt, s.y * cnt, s.z * cnt}"),
        ("V3{num.x / vol3, num.y / vol3, num.z / vol3}",
         "V3{num.x * vol3, num.y * vol3, num.z * vol3}"),
        ("vol3 / 3.0f", "vol3 * 3.0f")])
    variant(k2, k2_src, f2, "k2_mul", [
        ("smk::div3(s, fmaxf(static_cast<float>(nf), 1.0f))",
         "smk::scale(fmaxf(static_cast<float>(nf), 1.0f), s)"),
        ("smk::div3(num, vol3)", "smk::scale(vol3, num)"),
        ("smk::div1(vol3, 3.0f)", "vol3 * 3.0f")])
    # the register-row K2 with the area vectors too in registers, loaded
    # with the centres
    variant(k2, k2_src, f2, "k2_areas_in_registers", [
        ("    V3 fc[kRowW];\n", "    V3 fc[kRowW], fa[kRowW];\n"),
        ("        fc[w] = smk::load3(face_centres, wd[w] & kFaceBits);\n",
         "        fc[w] = smk::load3(face_centres, wd[w] & kFaceBits);\n"
         "        fa[w] = smk::load3(face_areas, wd[w] & kFaceBits);\n"),
        ("        add_pyramid(fc[w], smk::load3(face_areas, wd[w] & kFaceBits),"
         " wd[w],\n", "        add_pyramid(fc[w], fa[w], wd[w],\n")])
    # the two-pass K2: the sign without the owner gather
    variant(k2, k2_src, f2, "k2_noowner", [(
        "(__ldg(owner + f) == c) ? 1.0f : -1.0f",
        "(f & 1) ? 1.0f : -1.0f")])
    # blocks of 128; blocks an SM must hold (registers capped)
    for kernel, src, fname, tag in ((k1, k1_src, f1, "k1"),
                                    (k2, k2_src, f2, "k2")):
        for blocks in (6, 8):
            variant(kernel, src, fname, f"{tag}_min{blocks}", [(
                "__launch_bounds__(kThreads)",
                f"__launch_bounds__(kThreads, {blocks})")])
        variant(kernel, src, fname, f"{tag}_block128_min12", [
            ("constexpr int kThreads = 256;",
             "constexpr int kThreads = 128;"),
            ("__launch_bounds__(kThreads)", "__launch_bounds__(kThreads, 12)")])
        if "constexpr int kThreads = 256;" in src:
            variant(kernel, src, fname, f"{tag}_block128", [(
                "constexpr int kThreads = 256;",
                "constexpr int kThreads = 128;")])
        else:
            out.append((kernel, f"{tag}_block128", {"common.cuh": [(
                "constexpr int kBlock = 256;",
                "constexpr int kBlock = 128;")]}))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--topo")
    ap.add_argument("--side", type=int, default=128)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--out", default=os.path.join(
        ROOT, "smoothmesh_torch", "build", "k1k2_profile"))
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.makedirs(args.out, exist_ok=True)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from smoothmesh_torch import geometry as geo
    from smoothmesh_torch import kernels
    from smoothmesh_torch.device import to_device
    from smoothmesh_torch.driver import (KERNEL_STAGES, Smoother, Stages,
                                         iteration_body)
    from smoothmesh_torch.mesh.blockmesh import hex_block, perturb
    from smoothmesh_torch.mesh.tiling import permute_mesh
    from smoothmesh_torch.mesh.topology import compile_topology
    from smoothmesh_torch.params import SmoothingParams

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(f"{smi}; torch {torch.__version__}; profiling {root}", flush=True)
    kernels.build_all()
    tag = os.path.basename(root.rstrip("/")) or "root"
    record = {"card": smi, "root": root}
    ks = {"K1": kernels.FACE_GEOMETRY, "K2": kernels.CELL_CENTRES}
    cuobjdump = os.path.join(os.path.dirname(kernels.nvcc_path()),
                             "cuobjdump")
    for name, k in ks.items():
        for fn, regs, smem, spill in k.resources():
            occ = {b: occupancy(regs, smem, b) for b in (128, 256)}
            print(f"{name} {fn[:70]}: {regs} registers, {smem} bytes "
                  f"shared (static), {spill} bytes spilled; theoretical "
                  f"(blocks, warps) per SM at 128 / 256 threads a block: "
                  f"{occ}", flush=True)
            record.setdefault(name, {}).setdefault("ptxas", []).append(
                [fn, regs, smem, spill])
        if os.path.exists(cuobjdump):
            for fn, (mix, loops) in sass(
                    cuobjdump, k.library_path(),
                    os.path.join(args.out, f"{name}-{tag}.sass")).items():
                print(f"{name} SASS {fn[:70]}: {sum(mix.values())} "
                      f"instructions; {dict(mix.most_common(16))}",
                      flush=True)
                for lo, hi, n, c in loops:
                    print(f"  loop 0x{lo:x}-0x{hi:x}: {n} instructions; "
                          f"{dict(c.most_common(12))}", flush=True)
                record.setdefault(name, {}).setdefault("sass", []).append(
                    [fn, sum(mix.values()), [n for _, _, n, _ in loops]])

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
    k1 = rec["face_geometry"]
    k2 = rec["cell_centres_vols"]
    td = dict(sm.td)
    td.update(to_device(topo, "cuda", PLAIN_KEYS - set(td)))
    # the plain K2 takes (fg, td) where K2 reads the cell-face words,
    # (fg, owner, cell_faces, cell_faces_mask) in a tree from before them
    k2_plain = (k2[0], td) if len(k2) == 2 else k2
    pts, fp, fm, fn = k1
    fg = k2[0]
    n_faces, wf = fp.shape
    n_cells, wc = td["cell_faces"].shape
    print(f"K1 inputs: {pts.shape[0]} points, {n_faces} faces of width "
          f"{wf} ({int(fm.sum())} face-point slots); K2 inputs: {n_cells} "
          f"cells of width {wc} ({int(td['cell_faces_mask'].sum())} "
          "cell-face slots)", flush=True)
    record["shapes"] = dict(points=pts.shape[0], faces=n_faces, wf=wf,
                            cells=n_cells, wc=wc)

    def nbytes(*ts):
        return sum(t.numel() * t.element_size() for t in ts)

    b1 = nbytes(pts, fp, fn) + 3 * nbytes(fg.centres)
    cc0 = torch.empty((n_cells, 3), device=pts.device)
    vol0 = torch.empty((n_cells,), device=pts.device)
    b2_old = nbytes(fg.centres, fg.areas, td["owner"], td["cell_faces"],
                    td["cell_faces_mask"], cc0, vol0)
    b2 = (nbytes(fg.centres, fg.areas, td["cell_face_words"], cc0, vol0)
          if "cell_face_words" in td else b2_old)
    record["bound_ms"] = {"K1": b1 / HBM_BYTES_PER_S * 1e3,
                          "K2": b2 / HBM_BYTES_PER_S * 1e3,
                          "K2 old tables": b2_old / HBM_BYTES_PER_S * 1e3}
    print("byte bounds: " + ", ".join(f"{k} {v:.4f} ms" for k, v in
                                      record["bound_ms"].items()),
          flush=True)

    def bits(got, want):
        return sum(int((g.view(torch.int32) != w.view(torch.int32)).sum())
                   for g, w in zip(got, want))

    def check(label):
        got1 = geo.face_centres_areas(*k1)
        want1 = geo.face_centres_areas_plain(*k1)
        got2 = geo.cell_centres_vols(*k2)
        want2 = geo.cell_centres_vols_plain(*k2_plain)
        out = {"K1 values not bit-equal": bits(got1, want1),
               "K1 max abs err": max(float((g - w).abs().max())
                                     for g, w in zip(got1, want1)),
               "K2 values not bit-equal": bits(got2, want2),
               "K2 max abs err": max(float((g - w).abs().max())
                                     for g, w in zip(got2, want2))}
        print(f"[{label}] against the plain versions: {out}", flush=True)
        return out

    def time_all(label):
        t = {"K1": device_ms(torch, lambda: geo.face_centres_areas(*k1),
                             args.reps),
             "K2": device_ms(torch, lambda: geo.cell_centres_vols(*k2),
                             args.reps)}
        print(f"[{label}] " + ", ".join(f"{k} {v:.4f} ms"
                                        for k, v in t.items())
              + f" on {smi}", flush=True)
        record.setdefault("times", {})[label] = t
        return t

    record["check"] = check("as built")
    time_all("as built")

    if args.variants:
        k1_src = open(kernels.FACE_GEOMETRY.source_path).read()
        k2_src = open(kernels.CELL_CENTRES.source_path).read()
        for k, name, edits in variants_of(kernels, k1_src, k2_src):
            try:
                fn_, ptx = build_variant(kernels, k, name, edits, args.out)
            except RuntimeError as e:
                print(f"variant {name} not built: {e}", flush=True)
                continue
            saved = k._fn
            k._fn = fn_
            try:
                time_all(f"{name} {[p[1:] for p in ptx]}")
            finally:
                k._fn = saved
        time_all("as built, again")

    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
