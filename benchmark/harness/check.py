"""Whether the timed path's output is correct.

The window's jobs all start from one state, so the harness reads the
program's state at a few points of a job, through the same
``Smoother.steps`` calls the job makes: the first segment of
``segment`` iterations from the start state, one drawn from the seed,
and the last, which ends where the window's jobs ended (its end state
is held against theirs).  The plain reference (:mod:`reference`,
float64) follows each segment from the program's state at its start
for as many iterations as the program ran, with its own connectivity
and its own parameters derived from the start mesh.  The boundary path
(boundary smoothing, with or without layers) and the layer path (layers
without boundary smoothing) are read one ``steps(1)`` at a time, with
the normals, and held against the candidates of :mod:`refboundary`
(:func:`compare_boundary`; the layer path's set-up has no target).

A point is off where its position differs from the reference's by
more than ``tol`` of the start mesh's minimum edge length;
``points_off_ppm`` is the most over the segments, per million points.
A freeze or a blend decided on the other side of a threshold by float32
rounding moves a point and its neighbours by a fraction of a step, so
sound runs have a few; a wrong iteration moves most points.
``residual_gap`` is the widest relative gap between the residual the
program reported for an iteration (the number its relTol stop tests)
and the reference's for the same iteration.
"""

from __future__ import annotations

import numpy as np
import torch

from harness import inputs, reference, refboundary


def segment_starts(n_iters: int, length: int, seed: int) -> list:
    """Starts of the checked segments of a job of ``n_iters``
    iterations: 0, one drawn from the seed (a multiple of ``length``,
    as the job's batches start), and ``n_iters - length``."""
    last = max(n_iters - length, 0)
    starts = {0, last}
    inner = list(range(length, last - length + 1, length))
    if inner:
        rng = np.random.default_rng([seed, 7])
        starts.add(int(rng.choice(inner)))
    return sorted(starts)


def follow(x0: np.ndarray, T: dict, p: dict, n: int, dtype,
           device) -> tuple:
    """The reference's ``n`` iterations from ``x0`` -> (points, the
    residual of each iteration)."""
    x = torch.as_tensor(x0, dtype=torch.float64, device=device).to(dtype)
    res = []
    for _ in range(n):
        x, r = reference.iteration(x, T, p, dtype)
        res.append(r)
    return x.to(torch.float64).cpu().numpy(), res


def gaps(a: np.ndarray, b: np.ndarray, scale: float) -> np.ndarray:
    return np.linalg.norm(a - b, axis=1) / scale


def compare(mesh: dict, mix: dict, segments: list, T: dict, device,
            dtype=torch.float64) -> dict:
    """The reference over each program segment (on the connectivity
    ``T`` of :func:`reftopo.build`) -> the numbers compared and, per
    segment, the gaps' quantiles (for the record)."""
    chk = mix["check"]
    x_start = torch.as_tensor(mesh["points"], dtype=torch.float64,
                              device=device)
    h = reference.min_edge_length(x_start, T)
    p = reference.resolve(mix["params"], h)
    tol = float(chk["tol"])
    worst, res_gap, detail = 0, 0.0, []
    for seg in segments:
        ref, res = follow(seg["before"], T, p, seg["ran"], dtype, device)
        g = gaps(seg["after"], ref, h)
        off = int((g > tol).sum())
        worst = max(worst, off)
        res_gap = max([res_gap] + [abs(a - b) / b for a, b in
                                   zip(seg["residuals"], res)])
        detail.append(dict(start=seg["start"], ran=seg["ran"], off=off,
                           gap_max=float(g.max()),
                           gap_q=[float(v) for v in np.quantile(
                               g, [0.5, 0.99, 0.9999])],
                           off_at={f"{t:g}": int((g > t).sum())
                                   for t in (1e-3, 1e-2, 1e-1)},
                           res_prog=seg.get("residuals"), res_ref=res))
    return dict(points_off=worst,
                points_off_ppm=1e6 * worst / len(mesh["points"]),
                residual_gap=res_gap,
                segments=detail, min_edge=h)


def compare_boundary(mesh: dict, config: dict, mix: dict, segments: list,
                     T: dict, device, dtype=torch.float64) -> dict:
    """The boundary or the layer path, one iteration at a time from the
    program's points and normals (``Program.single_steps``): a point is
    off where its position after the iteration is farther than ``tol``
    from each of the reference's candidates (:mod:`refboundary`);
    ``normals_gap`` is the widest gap between the program's normals and
    the reference's, after each iteration and at the job's start (the
    normals the set-up carried inward).  ``surface_points_off_ppm`` and
    ``layer_points_off_ppm`` count the points off among the points the
    boundary path moves alone: those on a smoothing patch (the ray
    cast's and the projections') and the internal points the layer
    blend moves, per million of each set (the layer path has no
    smoothing patch)."""
    tol = float(mix["check"]["tol"])
    x_start = torch.as_tensor(mesh["points"], dtype=torch.float64,
                              device=device)
    h = reference.min_edge_length(x_start, T)
    p = reference.resolve(mix["params"], h)
    B = refboundary.setup(mesh, T, p, inputs.target(config, mix), device)
    start = segments[0]["steps"][0]["normals"]
    n_gap = float(np.abs(start - B["normals_init"].cpu().numpy()).max())
    sets = {"layer": B["layer"]}
    if B["path"] == "boundary":
        sets = {"surface": B["smoothing"], **sets}
    worst = dict.fromkeys(["all", *sets], 0)
    detail = []
    for seg in segments:
        offs = {k: [] for k in worst}
        for it in seg["steps"]:
            x = torch.as_tensor(it["before"], device=device)
            cands, revert, normals = refboundary.iteration(
                x, torch.as_tensor(it["normals"], device=device), T, B, p,
                dtype)
            after = torch.as_tensor(it["after"], device=device)
            g = reference.norm(cands.to(torch.float64) - after).amin(0)
            g = torch.where(revert, reference.norm(after - x), g) / h
            off = g > tol
            offs["all"].append(int(off.sum()))
            for k, on in sets.items():
                offs[k].append(int((off & on).sum()))
            n_after = torch.as_tensor(it["normals_after"], device=device)
            n_gap = max(n_gap, float((normals.to(torch.float64) - n_after)
                                     .abs().max()))
        worst = {k: max([v] + offs[k]) for k, v in worst.items()}
        detail.append(dict(start=seg["start"], off=offs))
    out = dict(points_off=worst["all"],
               points_off_ppm=1e6 * worst["all"] / len(mesh["points"]),
               normals_gap=n_gap, segments=detail, min_edge=h)
    for k, on in sets.items():
        out[f"{k}_points"] = int(on.sum())
        out[f"{k}_points_off_ppm"] = 1e6 * worst[k] / max(int(on.sum()), 1)
    return out


def read_program(prog, mix: dict, n_iters: int, seed: int) -> tuple:
    """The program's checked segments of a job of ``n_iters``
    iterations -> (segments, the points at the end of the last one)."""
    length = int(mix["check"]["segment"])
    starts = segment_starts(n_iters, length, seed)
    if inputs.path(mix) != "internal":
        segs = [prog.single_steps(k, min(length, n_iters - k))
                for k in starts]
        return segs, segs[-1]["steps"][-1]["after"]
    segs = [prog.segment(k, min(length, n_iters - k)) for k in starts]
    return segs, segs[-1]["after"]


def judge(mesh: dict, config: dict, mix: dict, segments: list, T: dict,
          device, dtype=torch.float64) -> dict:
    """The comparison of the mix's path (:func:`compare` or
    :func:`compare_boundary`)."""
    if inputs.path(mix) != "internal":
        return compare_boundary(mesh, config, mix, segments, T, device,
                                dtype)
    return compare(mesh, mix, segments, T, device, dtype)


def control_segments(mesh: dict, config: dict, mix: dict, segments: list,
                     T: dict, device, dtype=torch.bfloat16) -> list:
    """The segments with the reference computed in ``dtype`` put in the
    program's place, from the same states."""
    x_start = torch.as_tensor(mesh["points"], dtype=torch.float64,
                              device=device)
    p = reference.resolve(mix["params"],
                          reference.min_edge_length(x_start, T))
    if inputs.path(mix) == "internal":
        out = []
        for seg in segments:
            after, res = follow(seg["before"], T, p, seg["ran"], dtype,
                                device)
            out.append(dict(seg, after=after, residuals=res))
        return out
    B = refboundary.setup(mesh, T, p, inputs.target(config, mix), device)
    out = []
    for seg in segments:
        steps = []
        for it in seg["steps"]:
            x = torch.as_tensor(it["before"], device=device)
            cands, revert, normals = refboundary.iteration(
                x, torch.as_tensor(it["normals"], device=device), T, B, p,
                dtype)
            after = torch.where(revert[:, None], x.to(dtype), cands[0])
            steps.append(dict(it, after=after.double().cpu().numpy(),
                              normals_after=normals.double().cpu().numpy()))
        out.append(dict(seg, steps=steps))
    return out
