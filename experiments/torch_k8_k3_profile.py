"""Profile K8 (the ray cast) and K3 (the predictor) on one CUDA card
(H100) at the 128^3 inputs of chip_smoke.py's two cells.

Sets up the 128^3 bench mesh (graded, perturbed, its "top"/"rest"
patches) in bench.py's boundary configuration (layers + boundary
smoothing onto the k = 64 dome), records the first iteration's inputs
of K3 and K8, and reports for each kernel:

- its registers, shared memory and spills (``-Xptxas -v``), the
  theoretical occupancy they allow, and its SASS instruction mix
  (``cuobjdump -sass``, written to ``--out``);
- its median device time (CUDA events, ``--reps`` launches) at the
  default inputs (K3 with boundary points fixed) and the boundary
  inputs (K3 with them moving, K8 on the 16,129 free top points'
  rays), and K8 at half the triangles (does its time scale with the
  work?);
- with ``--variants``, timed variants built from the checkout's own
  sources with textual edits: other block sizes (does K8 fill the
  card?), and K3 without its share-a-cell test (what the test costs);
- the points where K3 runs its share-a-cell test (a positive blend
  fraction and two closest neighbours);
- each kernel against its plain version on these inputs (K8: rays
  differing in hit or miss and in t; K3: points beyond 1e-4 of the
  field and points not bit-equal);
- with ``--k8-slices`` (and ``--k8-rays``), K8's time at each of the
  given triangle-slice counts (and rays per thread), for a design that
  splits the triangle loop across blocks;
- with ``--k3-float4``, K3 reading points and cell centres as 16-byte
  records from float4 copies, alone and with the copies;
- with ``--clock``, the SM clock and power draw (nvidia-smi) sampled
  while each kernel runs back to back for about a second;
- with ``--cupti``, an attempt at CUPTI hardware metrics through
  ``torch.profiler``'s experimental metrics mode (achieved occupancy,
  issue-slot use, sectors per request, stall shares), under a watchdog.

``--root`` is the checkout whose ``smoothmesh_torch`` is profiled
(default: this repository); ``--topo`` names a pickle of the compiled
topology (written when missing, read otherwise).  Every time is printed
with the card's name and power limit.

Run from the repository root on a machine with a CUDA card:
    python experiments/torch_k8_k3_profile.py [--root DIR] [--variants]
        [--cupti] [--k8-slices 8 16 32 63] [--k8-rays 2 4] [--k3-float4]
        [--clock] [--out chiprun_out/k8k3]
"""

import argparse
import collections
import faulthandler
import json
import os
import pickle
import re
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOP_PATCHES = {"top": ["zmax"],
               "rest": ["xmin", "xmax", "ymin", "ymax", "zmin"]}
SM_REGS = 65536            # H100: 32-bit registers per SM
SM_THREADS = 2048
SM_BLOCKS = 32
SM_SMEM = 233472           # bytes of shared memory per SM (228 KB)
CUPTI_METRICS = [
    "sm__warps_active.avg.pct_of_peak_sustained_active",
    "smsp__issue_active.avg.pct_of_peak_sustained_active",
    "l1tex__t_sectors_pipe_lsu_mem_global_op_ld.sum",
    "l1tex__t_requests_pipe_lsu_mem_global_op_ld.sum",
    "smsp__warp_issue_stalled_long_scoreboard_per_warp_active.pct",
    "smsp__warp_issue_stalled_short_scoreboard_per_warp_active.pct",
    "smsp__warp_issue_stalled_wait_per_warp_active.pct",
    "smsp__warp_issue_stalled_math_pipe_throttle_per_warp_active.pct",
]


def device_ms(torch, fn, reps):
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


def occupancy(regs, smem, block):
    """Blocks and warps per SM that the resources allow."""
    regs_blk = ((regs + 7) // 8 * 8) * block     # allocation granularity
    lim = [SM_BLOCKS, SM_THREADS // block, SM_REGS // max(regs_blk, 1)]
    if smem:
        lim.append(SM_SMEM // (smem + 1024))
    blocks = min(lim)
    return blocks, blocks * block // 32


def sass_mix(cuobjdump, lib, path):
    """Dump the SASS of ``lib`` to ``path`` -> {function: Counter of
    opcodes}."""
    txt = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120).stdout
    with open(path, "w") as f:
        f.write(txt)
    mix, fn = {}, None
    for line in txt.splitlines():
        m = re.match(r"\s+Function : (\S+)", line)
        if m:
            fn = m.group(1)
            mix[fn] = collections.Counter()
            continue
        m = re.match(r"\s+/\*[0-9a-f]{4}\*/\s+(@!?U?P\w+\s+)?"
                     r"([A-Z][A-Z0-9_.]*)", line)
        if m and fn:
            mix[fn][m.group(2).split(".")[0]] += 1
    return mix


def build_variant(kernels, kernel, name, edits, out):
    """Build ``kernel``'s source with textual edits {file: [(old, new)]}
    into out/variants/<name>; -> a ctypes function with its argtypes."""
    import ctypes

    vdir = os.path.join(out, "variants", name)
    shutil.rmtree(vdir, ignore_errors=True)
    shutil.copytree(kernels.CSRC, vdir)
    for fname, subs in edits.items():
        path = os.path.join(vdir, fname)
        with open(path) as f:
            text = f.read()
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"variant {name}: {old!r} not in {fname}")
            text = text.replace(old, new)
        with open(path, "w") as f:
            f.write(text)
    lib = os.path.join(vdir, f"lib{name}.so")
    res = subprocess.run([kernels.nvcc_path(), *kernels.NVCC_FLAGS, "-I", vdir,
                          "-o", lib, os.path.join(vdir, kernel.source)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"variant {name}:\n{res.stdout}{res.stderr}")
    fn = getattr(ctypes.CDLL(lib), kernel.entry)
    fn.argtypes = kernel.argtypes
    fn.restype = ctypes.c_int
    return fn, kernels.parse_ptxas(res.stdout + res.stderr)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--topo")
    ap.add_argument("--side", type=int, default=128)
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--out", default=os.path.join(ROOT, "chiprun_out",
                                                  "k8k3"))
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--cupti", action="store_true")
    ap.add_argument("--k8-slices", type=int, nargs="*", default=[])
    ap.add_argument("--k8-rays", type=int, nargs="*", default=[2])
    ap.add_argument("--k3-float4", action="store_true")
    ap.add_argument("--clock", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    os.makedirs(args.out, exist_ok=True)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from smoothmesh_torch import kernels
    from smoothmesh_torch.driver import (KERNEL_STAGES, Smoother, Stages,
                                         iteration_body)
    from smoothmesh_torch.mesh.blockmesh import hex_block, perturb
    from smoothmesh_torch.mesh.tiling import permute_mesh
    from smoothmesh_torch.mesh.topology import compile_topology
    from smoothmesh_torch.ops import raycast
    from smoothmesh_torch.ops import smoothing as smo
    from smoothmesh_torch.params import SmoothingParams
    from smoothmesh_torch.testcases import bench_dome_geometry

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"{smi}; SM clock now, max: {clocks}; torch {torch.__version__};"
          f" profiling {root}", flush=True)
    kernels.build_all()
    record = {"card": smi, "root": root}
    ks = {"K3": kernels.PREDICTOR, "K8": kernels.RAYCAST}
    cuobjdump = os.path.join(os.path.dirname(kernels.nvcc_path()),
                             "cuobjdump")
    for tag, k in ks.items():
        for fn, regs, smem, spill in k.resources():
            occ = {b: occupancy(regs, smem, b) for b in (128, 256)}
            print(f"{tag} {fn[:60]}: {regs} registers, {smem} bytes shared, "
                  f"{spill} bytes spilled; theoretical (blocks, warps) per "
                  f"SM at 128 / 256 threads a block: {occ}", flush=True)
            record.setdefault(tag, {})["ptxas"] = [fn, regs, smem, spill]
        if os.path.exists(cuobjdump):
            mix = sass_mix(cuobjdump, k.library_path(),
                           os.path.join(args.out, f"{tag}.sass"))
            for fn, c in mix.items():
                print(f"{tag} SASS {fn[:60]}: {sum(c.values())} instructions;"
                      f" {dict(c.most_common(14))}", flush=True)

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
    params = SmoothingParams(centroidal_iters=32, rel_tol=0.0,
                             smoothing_patches=("top",),
                             layer_patches=("top",), min_angle=15.0,
                             ray_miss_fatal=False)
    sb = Smoother(mesh, params, topo=topo, device="cuda")
    sb.enable_boundary_smoothing(*bench_dome_geometry()[1:])
    print(f"set-up {time.perf_counter() - t0:.1f} s", flush=True)
    rec = {}

    def recording(name, fn):
        def call(*a):
            out = fn(*a)
            rec[name] = a
            return out
        return call

    stages = Stages(*(recording(n, f) for n, f in
                      zip(Stages._fields, KERNEL_STAGES)))
    iteration_body(sb.points, sb.td, sb.params, sb._scale, stages,
                   normals=sb.normals, smoothing_surface=sb.smoothing_surface,
                   layer=sb.layer, bnd=sb.bnd)
    torch.cuda.synchronize()
    k3_bnd = rec["predictor"]
    k3_def = k3_bnd[:5] + (False,)
    o, d, max_dist, tri = rec["ray_cast"]
    n_rays, n_tri = o.shape[0], tri.shape[1]
    pts, td = k3_bnd[0], k3_bnd[2]
    share = smo.share_test_mask(pts, td)
    n_pos = int(share.sum())
    n_pos_int = int((share & td["is_internal_point"]).sum())
    print(f"K3 inputs: {pts.shape[0]} points, point_cells width "
          f"{td['point_cells'].shape[1]}, point_points width "
          f"{td['point_points'].shape[1]}; the share test runs at {n_pos} "
          f"points ({n_pos_int} internal)", flush=True)
    record["share_test_points"] = [n_pos, n_pos_int]

    def time_all(label):
        t = {"K3 default": device_ms(torch, lambda: smo.predictor(*k3_def),
                                     args.reps),
             "K3 boundary": device_ms(torch, lambda: smo.predictor(*k3_bnd),
                                      args.reps),
             "K8": device_ms(torch, lambda: raycast.segment_triangle_hits(
                 o, d, max_dist, tri), args.reps)}
        print(f"[{label}] " + ", ".join(f"{k} {v:.4f} ms"
                                        for k, v in t.items())
              + f" on {smi}", flush=True)
        record.setdefault("times", {})[label] = t
        return t

    time_all("as built")
    if args.clock:
        # the SM clock under load: sampled once K3, then K8, have run
        # back to back for about a second
        import threading

        for tag, fn, n in (("K3", lambda: smo.predictor(*k3_def), 6000),
                           ("K8", lambda: raycast.segment_triangle_hits(
                               o, d, max_dist, tri), 3000)):
            box = {}

            def sample():
                time.sleep(0.4)
                box["clk"] = subprocess.run(
                    ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                     "--format=csv,noheader"], capture_output=True,
                    text=True, timeout=60).stdout.strip()

            th = threading.Thread(target=sample)
            torch.cuda.synchronize()
            th.start()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            th.join()
            print(f"{tag} under load ({n} launches back to back): SM clock, "
                  f"power {box.get('clk')}", flush=True)
            record.setdefault("clock under load", {})[tag] = box.get("clk")
    half = tri[:, :n_tri // 2].contiguous()
    t_half = device_ms(torch, lambda: raycast.segment_triangle_hits(
        o, d, max_dist, half), args.reps)
    print(f"K8 at {n_rays} rays x {n_tri // 2} triangles (half): "
          f"{t_half:.4f} ms", flush=True)
    record["K8 half triangles"] = t_half

    # each kernel against its plain version on these inputs
    got = raycast.segment_triangle_hits(o, d, max_dist, tri)
    want = raycast.segment_triangle_hits_plain(o, d, max_dist, tri)
    k8_differ = sum(int((torch.isfinite(g) != torch.isfinite(w)).sum())
                    for g, w in zip(got, want))
    k8_neq = sum(int(((g != w) & torch.isfinite(w)).sum())
                 for g, w in zip(got, want))
    print(f"K8 against its plain version: {k8_differ} hit/miss and "
          f"{k8_neq} t values differ", flush=True)
    for label, a in (("default", k3_def), ("boundary", k3_bnd)):
        got, want = smo.predictor(*a), smo.predictor_plain(*a)
        per_pt = torch.maximum((got[0] - want[0]).abs().amax(1),
                               (got[1] - want[1]).abs())
        beyond = int((per_pt > 1e-4 * float(want[0].abs().max())).sum())
        print(f"K3 ({label}) against its plain version: {beyond} points "
              f"beyond 1e-4 scaled, {int((per_pt > 0).sum())} not "
              "bit-equal", flush=True)
    del got, want

    if args.k8_slices and hasattr(raycast, "launch_geometry"):
        saved = (raycast.launch_geometry, raycast.RAYS_PER_THREAD,
                 kernels.RAYCAST._fn)
        for r in args.k8_rays:
            if r != saved[1]:
                # the kernel with r rays a thread: a variant of its source
                kernels.RAYCAST._fn, ptx = build_variant(
                    kernels, kernels.RAYCAST, f"k8_rays{r}", {"raycast.cu": [(
                        f"constexpr int kRays = {saved[1]};",
                        f"constexpr int kRays = {r};")]}, args.out)
                print(f"K8 with {r} rays a thread: {ptx}", flush=True)
            raycast.RAYS_PER_THREAD = r
            for s in args.k8_slices:
                def geom(nr, nt, n_sm, _s=s):
                    g = saved[0](nr, nt, n_sm)
                    tps = -(-nt // _s) if nt else 0
                    tps = -(-tps // raycast.TILE) * raycast.TILE
                    sl = -(-nt // tps) if nt else 0
                    return g._replace(slices=sl, tris_per_slice=tps)
                raycast.launch_geometry = geom
                got = raycast.segment_triangle_hits(o, d, max_dist, tri)
                want = raycast.segment_triangle_hits_plain(o, d, max_dist,
                                                           tri)
                same = all(bool(torch.equal(a, b)) for a, b in zip(got, want))
                t = device_ms(torch, lambda: raycast.segment_triangle_hits(
                    o, d, max_dist, tri), args.reps)
                g = geom(n_rays, n_tri, 132)
                nb = g.ray_blocks * g.slices
                print(f"K8 with {r} rays a thread, {g.slices} triangle "
                      f"slices of {g.tris_per_slice} ({nb} blocks): "
                      f"{t:.4f} ms; equal to the plain version: {same}",
                      flush=True)
                record.setdefault("K8 sweep", {})[f"{r}x{s}"] = t
            (raycast.launch_geometry, raycast.RAYS_PER_THREAD,
             kernels.RAYCAST._fn) = saved

    if args.k3_float4:
        # K3 reading points and cell centres as 16-byte records (float4
        # copies): the kernel alone, and with the two copies the wrapper
        # would make each iteration
        fn, ptx = build_variant(kernels, kernels.PREDICTOR, "k3_float4", {
            "predictor.cu": [
                ("using smk::V3;\n", "using smk::V3;\n"
                 "__device__ __forceinline__ V3 load3p(const float* a, "
                 "int64_t i) {\n  const float4 v = __ldg("
                 "reinterpret_cast<const float4*>(a) + i);\n"
                 "  return V3{v.x, v.y, v.z};\n}\n"),
                ("smk::load3(cell_ctrs, ", "load3p(cell_ctrs, "),
                ("smk::load3(points, j)", "load3p(points, j)"),
                ("smk::load3(points, i)", "load3p(points, i)")]},
            args.out)
        pts_, cc_ = k3_def[:2]
        pad = torch.nn.functional.pad
        f4 = {}

        def shim(_pts, _cc, *rest):
            # the wrapper's own arguments, the points and centres swapped
            # for their float4 copies
            return fn(f4["p"].data_ptr(), f4["c"].data_ptr(), *rest)

        def call(copy):
            if copy or not f4:
                f4["p"], f4["c"] = pad(pts_, (0, 1)), pad(cc_, (0, 1))
            return smo.predictor(*k3_def)

        want = smo.predictor(*k3_def)
        saved = kernels.PREDICTOR._fn
        kernels.PREDICTOR._fn = shim
        try:
            got = call(True)
            same = all(bool(torch.equal(g, w)) for g, w in zip(got, want))
            t_k = device_ms(torch, lambda: call(False), args.reps)
            t_kc = device_ms(torch, lambda: call(True), args.reps)
        finally:
            kernels.PREDICTOR._fn = saved
        print(f"K3 on float4 copies ({ptx[0][1:] if ptx else ''}): kernel "
              f"{t_k:.4f} ms, with the two copies {t_kc:.4f} ms; equal to "
              f"K3: {same}", flush=True)
        record["K3 float4"] = [t_k, t_kc]

    if args.variants:
        variants = []
        if "share_cell(point_cells, point_cells_mask, wc, p0.id, p1.id)" in \
                open(kernels.PREDICTOR.source_path).read():
            variants.append((kernels.PREDICTOR, "k3_noshare", {
                "predictor.cu": [("share_cell(point_cells, point_cells_mask, "
                                  "wc, p0.id, p1.id)", "false")]}))
        for blk in (128, 64):
            edit = {"common.cuh": [("constexpr int kBlock = 256;",
                                    f"constexpr int kBlock = {blk};")]}
            variants.append((kernels.RAYCAST, f"k8_block{blk}", edit))
            variants.append((kernels.PREDICTOR, f"k3_block{blk}", edit))
        for k, name, edits in variants:
            try:
                fn, ptx = build_variant(kernels, k, name, edits, args.out)
            except RuntimeError as e:
                print(f"variant {name} not built: {e}", flush=True)
                continue
            saved = k._fn
            k._fn = fn
            try:
                t = time_all(f"{name} {ptx[0][1:] if ptx else ''}")
            finally:
                k._fn = saved

    print(json.dumps(record), flush=True)

    if args.cupti:
        # the metrics mode of the profiler may be refused or may stall
        # where profiling is restricted: a watchdog ends the process
        # after 120 s
        faulthandler.dump_traceback_later(120, exit=True)
        from torch._C._profiler import _ExperimentalConfig
        from torch.profiler import ProfilerActivity, profile

        cfg = _ExperimentalConfig(profiler_metrics=CUPTI_METRICS,
                                  profiler_measure_per_kernel=True)
        try:
            with profile(activities=[ProfilerActivity.CUDA],
                         experimental_config=cfg) as prof:
                smo.predictor(*k3_def)
                raycast.segment_triangle_hits(o, d, max_dist, tri)
                torch.cuda.synchronize()
            path = os.path.join(args.out, "cupti_trace.json")
            prof.export_chrome_trace(path)
            with open(path) as f:
                trace = json.load(f)
            for e in trace.get("traceEvents", []):
                a = e.get("args", {})
                if any(m in a for m in CUPTI_METRICS) or \
                        "profiler_range" in str(e.get("cat", "")):
                    print(f"CUPTI {e.get('name', '')[:60]}: "
                          + json.dumps(a)[:1500], flush=True)
            print("CUPTI: trace written", flush=True)
        except Exception as e:          # noqa: BLE001 - report and go on
            print(f"CUPTI metrics not available: {e!r}", flush=True)
        faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
