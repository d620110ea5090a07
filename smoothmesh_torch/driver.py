"""The smoothing driver: one iteration + the convergence loop.

Reimplements the reference's main iteration (src/smoothMesh.C:2257-2437)
for one device:

  face geometry (K1) -> [boundary point normals] -> cell centres (K2)
  -> predictor (K3: centroidal, aspect-ratio blend, step limiter)
  -> [layer blend -> step limit] -> [boundary projection, with the ray
  cast (K8) -> prismatic projection -> step limit] -> edge-shortening /
  edge-angle freezes (K4) -> current face angles per point (K5, K6) ->
  the face-angle fixed point -> revert frozen and non-smoothed boundary
  points -> residual

The bracketed stages run with boundary-layer blending (``layer_patches``)
and with boundary point smoothing (:meth:`Smoother.enable_boundary_
smoothing`), in the order of the JAX driver's tile-engine branch
(``smoothmesh_tpu/driver.py:114-249``): the normals reuse K1's face
area vectors, and the boundary pass's freeze mask goes into K4.

Coordinates are internally normalized (centred, scaled so the minimum
edge length is 1) so float32 stays accurate at any absolute mesh scale;
length-valued parameters are scaled along.

:meth:`Smoother.steps` runs ``iter_batch`` iterations a dispatch (the
JAX package's ``SMOOTHMESH_ITER_BATCH``, default 16) with one host read
a batch: each iteration writes its residual, frozen count and ray-miss
count (the information the reference prints) into a record on the
device, and an iteration after the stop passes the state through bit
for bit.  On the card the batch iteration is captured once as a CUDA
graph and replayed.  The face-angle fixed point, the one step whose
work depends on a host decision, is not run inside a batch: an
iteration that finds a point in the face-angle band is not committed,
the batch stops there, and the host runs that iteration with the fixed
point (:class:`_Batch`).  ``iter_batch`` <= 1 runs one iteration a
dispatch, reading two scalars (three with boundary smoothing) after
each.

The face-angle step is the JAX driver's tile-engine branch
(``smoothmesh_tpu/driver.py:321-327``) on every device: the fixed point
in u space, with the current angles from K5/K6 (their plain versions on
the CPU and in float64) and its 1e-5 u guard against last-bit noise.
Not its XLA branch (``:246-249``, angle space, no guard): that one
compares the current and the substituted angles from two arithmetic
paths, so where a substitution leaves an edge unchanged its decision
follows last-bit noise (see tests/test_torch_driver.py).
"""

from __future__ import annotations

import dataclasses
import inspect
import os
import time
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from smoothmesh_torch import boundary as bps
from smoothmesh_torch import geometry as geo
from smoothmesh_torch import kernels
from smoothmesh_torch import layers as lay
from smoothmesh_torch.device import resolve_device, to_device
from smoothmesh_torch.io.polymesh import PolyMesh
from smoothmesh_torch.mesh.tiling import MeshOrders, permute_mesh
from smoothmesh_torch.mesh.topology import MeshTopology, compile_topology
from smoothmesh_torch.ops import constraints, raycast, smoothing
from smoothmesh_torch.params import SmoothingParams
from smoothmesh_torch.quality import (mesh_stats, quality_report,
                                     quality_td_keys)


@dataclasses.dataclass
class StepResult:
    iteration: int
    residual: float
    n_frozen: int
    wall_ms: float = 0.0
    n_ray_miss: int = 0


RAY_MISS_MSG = (
    "Did not find surface intersection for {n} smoothing-surface "
    "point(s) within the maximum search distance — the targetSurfaces "
    "geometry likely does not cover the mesh boundary (reference "
    "bPS.C:933-940 aborts here).  Set ray_miss_fatal=False / "
    "-allowRayMiss to freeze such points in place instead."
)


class Stages(NamedTuple):
    """The per-iteration stages that hold a kernel."""

    face_geometry: Callable
    cell_centres_vols: Callable
    predictor: Callable
    freeze_constraints: Callable
    face_angles_per_point: Callable
    ray_cast: Callable


#: The wrappers: kernels on float32 CUDA tensors, plain versions on CPU
#: tensors and float64 CUDA tensors (``kernels.takes_kernel``).
KERNEL_STAGES = Stages(geo.face_centres_areas, geo.cell_centres_vols,
                       smoothing.predictor, constraints.freeze_constraints,
                       constraints.face_angles_per_point,
                       raycast.segment_triangle_hits)
#: The plain PyTorch versions on any device (the card's reference run).
PLAIN_STAGES = Stages(geo.face_centres_areas_plain,
                      geo.cell_centres_vols_plain,
                      smoothing.predictor_plain,
                      constraints.freeze_constraints_plain,
                      constraints.face_angles_per_point_plain,
                      raycast.segment_triangle_hits_plain)

#: The device-topology tables one iteration of the default configuration
#: reads (the face-angle fixed point reads point_edges_side folded into
#: pe_flat).
TD_KEYS = frozenset({
    "face_points", "face_mask", "face_npoints", "owner", "cell_faces",
    "cell_faces_mask", "point_cells", "point_cells_mask", "point_points",
    "point_points_mask", "point_faces_mask", "wedge_prev", "wedge_next",
    "is_internal_point", "point_valid",
    # the face angle
    "edges", "edge_faces", "edge_cells", "edge_cells_mask", "edge_cell_f0",
    "edge_cell_f1", "point_edges", "point_edges_mask", "pps_signed",
    "pe_flat",
})
#: What the kernels read on the card: K2 the cell-face words in place of
#: owner, cell_faces and cell_faces_mask, K4 the packed wedge words in
#: place of the plain version's wedge tables, K5 the packed cell words
#: beside the fixed point's edge_cell_f0/f1 and edge_cells_mask.
CUDA_TD_KEYS = (TD_KEYS - {"owner", "cell_faces", "cell_faces_mask",
                           "point_faces_mask", "wedge_prev", "wedge_next"}
                | {"cell_face_words", "wedge_words", "edge_cell_words"})
#: What the boundary point normals add (layers and boundary smoothing);
#: staged only when one of them is on.
NORMALS_TD_KEYS = frozenset({"point_faces", "point_faces_mask",
                             "face_is_real_boundary"})


def td_keys(device: torch.device, normals: bool = False,
            dtype: torch.dtype = torch.float32) -> frozenset:
    """The device-topology tables one iteration reads for coordinates of
    ``dtype`` on ``device`` (the kernels' where they launch, else the
    plain versions'), with or without the boundary point normals."""
    keys = (CUDA_TD_KEYS if kernels.takes_kernel(device, dtype, "td_keys")
            else TD_KEYS)
    return (keys | NORMALS_TD_KEYS) if normals else keys


class Iteration(NamedTuple):
    """What one iteration returns (scalars as 0-d tensors)."""

    points: torch.Tensor
    normals: Optional[torch.Tensor]
    residual: torch.Tensor
    n_frozen: torch.Tensor
    n_ray_miss: object          # the constant 0 without boundary smoothing
    #: the points in the face-angle band, counted (not frozen) when the
    #: fixed point was left out; None where it ran or is off
    n_active: Optional[torch.Tensor] = None


def iteration_body(points, td, params: SmoothingParams, scale: float,
                   stages: Stages = KERNEL_STAGES, normals=None,
                   smoothing_surface=None, layer=None, bnd=None,
                   fixed_point: bool = True, skip=None, sync=None,
                   owned=None) -> Iteration:
    """One smoothing iteration (reference src/smoothMesh.C:2257-2437)
    -> (new points, normals, residual, frozen count, ray-miss count,
    face-angle active count) (:class:`Iteration`), the scalars as 0-d
    tensors (the ray-miss count is the constant 0 without ``bnd``).

    ``normals``: the boundary point normals' state (read and returned
    updated when ``layer`` or ``bnd`` is given).  ``smoothing_surface``:
    (N,) bool, the boundary points that may move, or None where none
    may.  ``layer``: the layer maps (``hops_layer``, ``outer_map``) or
    None.  ``bnd``: the boundary-smoothing tables or None.  Length-valued
    parameters are pre-scaled by the driver's coordinate normalization
    factor ``scale``.  ``fixed_point=False`` leaves the face-angle fixed
    point out and counts the points in its band instead (``n_active``):
    where that count is 0 the fixed point would return its incoming
    mask, so the iteration is exact; where it is not, every point
    reverts.  ``skip``: a 0-d bool tensor; where it holds, every point
    reverts (the points pass through bit for bit).  With
    ``fixed_point=False`` no step of it reads the host.

    ``sync`` and ``owned``: a domain decomposition's exchange
    (:mod:`smoothmesh_torch.parallel.sync`) and (N,) owner mask, or
    None for one shard.  The halo gives both.  Owned points have
    complete local stencils, so the iteration is the single-device one
    plus, at the places of the JAX driver's tile branch
    (``smoothmesh_tpu/driver.py:137-263``): the predictor's proposal,
    the normals' sums and the neighbour coordinates taken from the
    owner (consensus); the ray misses, the frozen and the face-angle
    band counted on owned points; the stage-S freezes masked to owned
    points and OR-combined; the face-angle fixed point run from owned
    points only, its freezes OR-combined; the residual and the counts
    all-reduced.

    The disjoint decomposition gives ``sync`` alone (``owned`` None),
    as the JAX driver's XLA branch takes its ``PointSync``
    (``:150-263``): the shared points' partial sums (centroidal, the
    normals', the projections') summed over their holders, their
    closest points merged (:func:`smoothing.predict_shared_rows`) and
    their proposal taken from the owner; the neighbour coordinates by
    the min-magnitude combine; every shard's own freeze decisions and
    face-angle fixed point on all its points, OR-combined (the
    reference's rank-local constraints); the residual all-reduced and
    the counts summed over the shards, so a shared point counts once
    a holder.
    """
    p = params
    min_edge = p.min_edge_length * scale
    max_step = p.max_step_length * scale
    internal = td["is_internal_point"]
    frozen = torch.zeros(points.shape[0], dtype=torch.bool,
                         device=points.device)

    fg = stages.face_geometry(points, td["face_points"], td["face_mask"],
                              td["face_npoints"])
    if layer is not None or bnd is not None:
        # stateful normals (reference :2266), from K1's area vectors
        normals, is_sharp = lay.accumulate_point_normals(normals, fg.areas,
                                                         td, sync)
    cell_ctrs, _ = stages.cell_centres_vols(fg, td)
    prop, _ = stages.predictor(points, cell_ctrs, td, max_step,
                               p.rel_step_frac, bnd is not None)
    if sync is not None and owned is not None:
        # the halo: owned proposals are exact; replicas adopt them
        # before any consumer reads a neighbour's proposal
        prop = sync.consensus(prop)
    elif sync is not None:
        # disjoint: the proposal is exact off the shared points; theirs
        # combine the holders' partial sums and closest points
        prop = smoothing.predict_shared_rows(
            prop, points, cell_ctrs, td, max_step, p.rel_step_frac,
            bnd is not None, sync)

    if layer is not None:
        outer = lay.update_neigh_coords(points, layer["outer_map"], sync)
        prop = lay.blend_with_orthogonal_points(
            points, prop, td, layer["hops_layer"], normals, outer,
            p.layer_max_blending_fraction, p.layer_edge_length * scale,
            p.layer_expansion_ratio, p.min_layers, p.max_layers + 1)
        prop = smoothing.constrain_max_step_length(points, prop, max_step,
                                                   p.rel_step_frac)

    n_ray_miss = 0
    if bnd is not None:
        # boundary point smoothing (reference :2307-2356)
        inner = lay.update_neigh_coords(points, bnd["inner_map"], sync)
        prop, frozen, no_hit = bps.project_boundary_points(
            points, prop, normals, frozen, bnd, td, is_sharp, fg.centres,
            ray_cast=stages.ray_cast, sync=sync)
        miss = no_hit & td["point_valid"]
        n_ray_miss = (miss if owned is None else miss & owned).sum()
        prop = lay.project_prismatic_boundary_points(
            prop, bnd, normals, inner, is_sharp,
            p.internal_smoothing_blending_fraction)
        prop = smoothing.constrain_max_step_length(points, prop, max_step,
                                                   p.rel_step_frac)

    frozen = stages.freeze_constraints(
        points, prop, td, min_edge, p.total_min_freeze, p.min_angle_rad,
        p.edge_angle_constraint, frozen)
    if owned is not None:
        # the halo: stage-S decisions hold only where the stencil is
        # complete
        frozen = sync.or_(frozen & owned)
    n_active = None
    if p.face_angle_constraint:
        # as the JAX driver's tile branch (smoothmesh_tpu/driver.py:321-327)
        cur = stages.face_angles_per_point(points, fg.means, cell_ctrs, td)
        if fixed_point:
            frozen = constraints.restrict_face_angle_deterioration(
                points, cell_ctrs, prop, td, p.min_angle_rad,
                p.max_angle_rad, frozen, fc_base=fg.means, cur_minmax=cur,
                u_space=True, eligible=owned)
        else:
            n_active = constraints.face_angle_band(
                *cur, p.min_angle_rad, p.max_angle_rad, u_space=True,
                guarded=True, eligible=owned).active.sum()
    if sync is not None:
        # the shard-local fixed point's freezes, of replicas too
        frozen = sync.or_(frozen)
        if n_active is not None:
            n_active = sync.all_sum(n_active)
        if bnd is not None:
            n_ray_miss = sync.all_sum(n_ray_miss)

    fixed = ~internal
    if smoothing_surface is not None:
        fixed = fixed & ~smoothing_surface
    revert = frozen | fixed
    # the batch's pass-through, folded into the revert mask (no select
    # over the points of its own)
    if n_active is not None:
        skip = (n_active > 0) if skip is None else skip | (n_active > 0)
    if skip is not None:
        revert = revert | skip
    new_points = torch.where(revert[:, None], points, prop)
    counted = revert & td["point_valid"]
    n_frozen = (counted if owned is None else counted & owned).sum()
    res = smoothing.calculate_residual(points, new_points, max_step, sync)
    if sync is not None:
        n_frozen = sync.all_sum(n_frozen)
    return Iteration(new_points, normals, res, n_frozen, n_ray_miss,
                     n_active)


class _Batch:
    """Up to ``iter_batch`` iterations a dispatch with one host read.

    The batch state (points, normals, a ``done`` flag) and a record of
    one row an iteration (:data:`RECORD`) live on the device, with a slot
    counter.  Each iteration runs without the face-angle fixed point
    (``iteration_body(..., fixed_point=False)``) and is committed only
    where no point is in the face-angle band and the batch is not done;
    one that finds such points sets ``done`` uncommitted (a face-angle
    stop), and so does a committed one whose residual falls below
    ``rel_tol`` or, under ``ray_miss_fatal`` with boundary smoothing,
    whose ray cast missed.  An iteration not committed reverts every
    point, so after ``done`` the state passes through bit for bit.  On
    the card one iteration is captured as a CUDA graph
    (:class:`kernels.Graph`) on the buffers held here and replayed; on
    the CPU, and with an exchange that cannot be captured (a group's,
    ``parallel.sync.DistSync``), it runs eagerly.
    """

    #: the record's columns (float64; counts are exact)
    RECORD = ("residual", "n_frozen", "n_ray_miss", "committed",
              "face_angle_stop")

    def __init__(self, sm: "Smoother", key: tuple):
        self.key = key
        dev = sm.device
        self.points = sm.points.clone()
        self.normals = sm.normals.clone()
        self.done = torch.zeros((), dtype=torch.bool, device=dev)
        self.slot = torch.zeros(1, dtype=torch.int64, device=dev)
        self.record = torch.zeros((sm.iter_batch, len(self.RECORD)),
                                  dtype=torch.float64, device=dev)
        self._args = (sm.td, sm.params, sm._scale)
        self._kw = dict(smoothing_surface=sm.smoothing_surface,
                        layer=sm.layer, bnd=sm.bnd, sync=sm.sync,
                        owned=sm.owned)
        self._fatal = bool(sm.params.ray_miss_fatal) and sm.bnd is not None
        capturable = sm.sync is None or sm.sync.capturable
        self.graph = None
        if dev.type == "cuda" and capturable:
            if kernels.takes_kernel(dev, sm.dtype):
                kernels.build_all()     # all at once, before the warm-up
            self.graph = kernels.Graph(self._iteration, dev)

    def _iteration(self) -> None:
        done = self.done
        it = iteration_body(self.points, *self._args, normals=self.normals,
                            fixed_point=False, skip=done, **self._kw)
        fa_stop = (it.n_active > 0) if it.n_active is not None \
            else torch.zeros_like(done)
        commit = ~done & ~fa_stop
        stop = it.residual < self._args[1].rel_tol
        miss = it.n_ray_miss
        if not torch.is_tensor(miss):
            miss = it.residual.new_zeros(())
        elif self._fatal:
            stop = stop | (miss > 0)
        row = torch.stack([it.residual.double(), it.n_frozen.double(),
                           miss.double(), commit.double(),
                           (~done & fa_stop).double()])
        self.record.index_copy_(0, self.slot, row[None])
        self.slot.add_(1)
        self.points.copy_(it.points)
        if it.normals is not self.normals:
            self.normals.copy_(torch.where(commit, it.normals,
                                           self.normals))
        self.done.copy_(done | fa_stop | stop)

    def run(self, points, normals, n: int) -> list:
        """``n`` iterations from ``points``/``normals`` -> the record's
        first ``n`` rows, read to the host (the batch's one read)."""
        self.points.copy_(points)
        self.normals.copy_(normals)
        self.done.zero_()
        self.slot.zero_()
        for _ in range(n):
            if self.graph is not None:
                self.graph.replay()
            else:
                self._iteration()
        return self.record[:n].tolist()            # host sync


class _Delegating(type):
    """``Smoother(..., n_devices=N)`` with N > 1 builds a domain
    decomposition's smoother over N shards instead, as the JAX package's
    ``Smoother`` delegates (``smoothmesh_tpu/driver.py:405-427``), with
    ``n_devices`` given by keyword or by position."""

    def __call__(cls, *args, **kw):
        if cls is Smoother:
            given = inspect.signature(cls.__init__).bind(
                None, *args, **kw).arguments
            if given.get("n_devices") not in (None, 1):
                del given["self"]
                return _decomposed(**given)
        return super().__call__(*args, **kw)


def decomposition(device, dtype=None, use_tile_engine=None) -> str:
    """The decomposition ``Smoother(..., n_devices=N)`` builds for N > 1:
    ``"halo"`` where the JAX package takes its tile engine, on the
    kernels' device (``cuda``) in float32, ``"disjoint"`` everywhere
    else (float64 too, as the JAX package's tile engine is float32
    only); ``use_tile_engine`` True or False picks the halo or the
    disjoint one."""
    if use_tile_engine is None:
        use_tile_engine = (torch.device(device).type == "cuda"
                           and dtype in (None, torch.float32))
    return "halo" if use_tile_engine else "disjoint"


def _decomposed(mesh, params, dtype=None, topo=None, device=None,
                normalize=True, n_devices=None, use_tile_engine=None):
    """The smoother of ``Smoother(..., n_devices=N)`` for N > 1 (the
    halo's ``parallel.halo.HaloSmoother`` or the disjoint one's
    ``parallel.sharded.ShardedSmoother``, as :func:`decomposition`
    picks).  On ``cuda`` one shard a card, ``cuda:0`` to ``cuda:N-1``,
    in this process (``devices=``, as the JAX package takes
    ``jax.devices()[:N]``); fewer cards than N raise ``ValueError``
    before any build.  On the CPU, the one torch device there, the N
    shards run together on it.  ``topo`` is not used: each shard
    compiles its own."""
    device = resolve_device(device)
    if decomposition(device, dtype, use_tile_engine) == "halo":
        from smoothmesh_torch.parallel.halo import HaloSmoother as cls
    else:
        from smoothmesh_torch.parallel.sharded import ShardedSmoother as cls
    if device.type != "cuda":
        return cls(mesh, params, n_shards=n_devices, dtype=dtype,
                   normalize=normalize, device=device)
    n_cards = torch.cuda.device_count()
    if n_devices > n_cards:
        raise ValueError(f"n_devices={n_devices} puts one shard on each of "
                         f"{n_devices} cards, and this machine has "
                         f"{n_cards}")
    return cls(mesh, params, dtype=dtype, normalize=normalize,
               devices=[torch.device("cuda", i) for i in range(n_devices)])


class Smoother(metaclass=_Delegating):
    """Single-device smoothing engine for one mesh.

    Parameters
    ----------
    mesh: the polyMesh to smooth (topology fixed, points move).
    params: smoothing options; derived defaults are resolved here from
        the initial mesh stats (reference src/smoothMesh.C:1854-1921).
        Boundary-layer blending runs when ``layer_patches`` match a
        patch and ``layer_max_blending_fraction`` is positive.
    dtype: coordinate dtype (default float32).  On ``cuda`` float32
        launches the CUDA kernels and float64 runs their plain PyTorch
        versions on the card (no kernel, as the JAX package runs
        float64 through XLA, never through Pallas); another dtype
        raises ``TypeError`` there.  On the CPU the plain versions take
        any float dtype.
    topo: a precompiled topology of ``mesh``; without one the mesh is
        spatially reordered (``permute_mesh``) and compiled here by the
        native topology compiler (``compile_topology``, C++ built at
        first use; it raises where it cannot be built).
    device: ``"cuda"`` by default; ``"cpu"`` runs the plain versions.
    normalize: centre the points and scale them so that the minimum edge
        length is 1 (float32 stays accurate at any absolute scale);
        False keeps external coordinates.
    n_devices: None or 1 for this smoother; N > 1 (by keyword or by
        position) returns a domain decomposition's smoother over N
        shards instead, on ``cuda`` one a card on N cards in this
        process, on the CPU all on it (the halo on ``cuda`` in float32,
        else the disjoint one, :func:`decomposition`;
        ``use_tile_engine`` True or False picks the halo or the
        disjoint one, as the JAX package's argument of that name picks
        its tile engine's halo), with the same surface.

    ``iter_batch`` (from ``SMOOTHMESH_ITER_BATCH``, default 16, as the
    JAX package): the iterations :meth:`steps` runs a dispatch, with one
    host read a batch; on the card a batch replays one iteration
    captured as a CUDA graph, captured again when the tables,
    parameters or state it captured are replaced.  <= 1 runs one
    iteration a dispatch.  :meth:`step` always runs one.
    """

    def __init__(self, mesh: PolyMesh, params: SmoothingParams,
                 dtype=None, topo: Optional[MeshTopology] = None,
                 device=None, normalize: bool = True,
                 n_devices: Optional[int] = None,
                 use_tile_engine: Optional[bool] = None):
        device = resolve_device(device)
        orders = None
        mesh_int = mesh
        if topo is None:
            mesh_int, orders = permute_mesh(mesh)
            topo = compile_topology(mesh_int)
        stats = mesh_stats(mesh_int.points, topo.edges)
        if normalize:
            center = mesh_int.points.mean(axis=0)
            scale = 1.0 / max(stats.min_edge_length, 1e-300)
        else:
            center, scale = np.zeros(3), 1.0
        self.mesh = mesh
        self.mesh_internal = mesh_int
        self.stats = stats
        self._setup(topo, (mesh_int.points - center) * scale,
                    params.resolve(stats.min_edge_length), center, scale,
                    device, dtype, orders)
        if self._will_layer:
            self._setup_maps()
            self.layer = {
                k: self._tensor(getattr(self.layer_maps, k), torch.int64)
                for k in ("hops_layer", "outer_map")}

    def _setup(self, topo: MeshTopology, points: np.ndarray,
               params: SmoothingParams, center, scale: float, device,
               dtype, orders: Optional[MeshOrders]) -> None:
        """Device state from host state; ``points`` are internal
        (normalized) coordinates and ``params`` are resolved.  Layers
        and boundary smoothing start off (no maps)."""
        device = resolve_device(device)
        dtype = torch.float32 if dtype is None else dtype
        # float32 takes the kernels on the card, float64 their plain
        # versions; another dtype raises TypeError there
        kernels.takes_kernel(device, dtype, "Smoother")
        self.device = device
        self.dtype = dtype
        self.topo = topo
        self.params = params
        self._orders = orders
        self._center = np.asarray(center, dtype=np.float64)
        self._scale = float(scale)
        self._layer_ids = topo.patch_ids_matching(params.layer_patches)
        self._will_layer = bool(len(self._layer_ids)
                               and params.layer_max_blending_fraction
                               > 1e-15)
        self.td = to_device(topo, device,
                            td_keys(device, self._will_layer, dtype))
        self.points = self._tensor(points, dtype)
        # the halo exchange and owner mask (parallel.halo); none here
        self.sync = None
        self.owned = None
        # boundary point normals (state), the boundary points that may
        # move, and the layer and boundary tables: none until enabled
        self.normals = torch.zeros_like(self.points)
        self.smoothing_surface = None
        self.layer_maps = None
        self.layer = None
        self.bnd = None
        self._iteration = 0
        self.iter_batch = int(os.environ.get("SMOOTHMESH_ITER_BATCH", "16"))
        self._batch = None
        #: batches that stopped at a face-angle stop
        self.face_angle_stops = 0

    def _tensor(self, a, dtype) -> torch.Tensor:
        return torch.tensor(np.asarray(a), dtype=dtype, device=self.device)

    def _stage_normals_tables(self) -> None:
        """Add the tables the boundary point normals read to ``td``."""
        missing = NORMALS_TD_KEYS - set(self.td)
        if missing:
            self.td.update(to_device(self.topo, self.device, missing))

    def _setup_maps(self) -> None:
        """Hop counts + prismatic maps + propagated normals (reference
        src/smoothMesh.C:2215-2230), shared by layer treatment and
        boundary smoothing."""
        if self.layer_maps is not None:
            return
        self._stage_normals_tables()
        bn, sharp = geo.boundary_point_normals(self.points, self.td)
        smoothing_ids = self.topo.patch_ids_matching(
            self.params.smoothing_patches)
        self.layer_maps = lay.build_layer_maps(
            self.topo, bn.to("cpu", torch.float64).numpy(),
            sharp.cpu().numpy(), self._layer_ids, smoothing_ids,
            self.params.max_layers)
        self.normals = self._tensor(self.layer_maps.normals_init, self.dtype)

    def transform(self, pts: np.ndarray) -> np.ndarray:
        """External coordinates -> internal normalized coordinates."""
        return (np.asarray(pts, dtype=np.float64) - self._center) * \
            self._scale

    def enable_boundary_smoothing(
        self, surf_vertices, surf_tris,
        init_edge_points, init_edges,
        target_edge_points=None, target_edges=None,
        checkpoint_corner=None, checkpoint_feature=None,
    ) -> bps.BoundarySetup:
        """Enable boundary point smoothing (reference
        src/smoothMesh.C:2079-2212): classify boundary points against
        the edge meshes, pack the target-surface triangle soup, resolve
        edge strings, and let smoothing-surface points move.  Returns
        the classification (for checkpointing; its arrays are in the
        internal point order, see :meth:`to_external_point_field`).
        """
        if self.mesh_internal is None:
            raise RuntimeError(
                "enable_boundary_smoothing needs the mesh: a smoother "
                "carried across with convert.state_from_jax takes its "
                "boundary tables as state_from_jax(..., bnd=...)")
        if target_edge_points is None:
            target_edge_points, target_edges = init_edge_points, init_edges
        if self._orders is not None:
            if checkpoint_corner is not None:
                checkpoint_corner = np.asarray(
                    checkpoint_corner)[self._orders.point_old]
            if checkpoint_feature is not None:
                checkpoint_feature = np.asarray(
                    checkpoint_feature)[self._orders.point_old]

        for pts, edges in ((init_edge_points, init_edges),
                           (target_edge_points, target_edges)):
            bps.check_edge_mesh_sanity(pts, edges,
                                       self.stats.min_edge_length,
                                       self.stats.perimeter)

        self._setup_maps()
        smoothing_ids = self.topo.patch_ids_matching(
            self.params.smoothing_patches)
        setup = bps.classify_boundary_points(
            self.topo, init_edge_points, init_edges,
            target_edge_points, target_edges,
            surf_vertices, surf_tris,
            self._layer_ids, smoothing_ids,
            self.mesh_internal.points, self.params.distance_tolerance,
            checkpoint_corner=checkpoint_corner,
            checkpoint_feature=checkpoint_feature,
        )
        self.boundary_setup = setup
        t = self.transform
        internal = self.topo.is_internal_point
        tep, te = setup.target_edge_points, setup.target_edges
        self.bnd = self._bnd_tables(dict(
            is_corner=setup.is_corner,
            is_feature_edge=setup.is_feature_edge,
            is_smoothing_surface=setup.is_smoothing_surface,
            is_connected=setup.is_connected,
            smoothing_surface=setup.is_smoothing_surface,
            corner_targets=t(setup.corner_targets),
            point_strings=setup.point_strings,
            feat_neigh=setup.feat_neigh,
            feat_neigh_mask=setup.feat_neigh_mask,
            edge_a=t(tep[te[:, 0]]),
            edge_b=t(tep[te[:, 1]]),
            edge_strings=setup.target_edge_strings,
            tri_a=t(setup.surf_tri_a),
            tri_b=t(setup.surf_tri_b),
            tri_c=t(setup.surf_tri_c),
            distance_tolerance=setup.distance_tolerance * self._scale,
            inner_map=self.layer_maps.inner_map,
            # static compaction sets (the classification is fixed after
            # set-up): feature points with projection neighbours, and
            # the free smoothing-surface ray-cast candidates
            feat_rows=np.where(setup.feat_neigh_mask.any(axis=1))[0],
            surf_rows=np.where(setup.is_smoothing_surface & ~internal
                               & ~setup.is_corner
                               & ~setup.is_feature_edge)[0],
        ))
        self.smoothing_surface = self.bnd["smoothing_surface"]
        return setup

    def _bnd_tables(self, host: dict) -> dict:
        """The boundary-smoothing tables on the device from host arrays
        (the JAX package's ``bnd`` dict, with the triangles packed for
        the ray cast, the compaction rows unpadded, and the rows of the
        smoothing-surface boundary points, ``smooth_rows``)."""
        np_dtype = np.float64 if self.dtype == torch.float64 else np.float32
        host = dict(host, smooth_rows=np.where(
            np.asarray(host["is_smoothing_surface"])
            & ~self.topo.is_internal_point)[0])
        out = {"distance_tolerance": float(host["distance_tolerance"]),
               "tri_packed": self._tensor(raycast.pack_triangles(
                   host["tri_a"], host["tri_b"], host["tri_c"], np_dtype),
                   self.dtype)}
        for k in ("is_corner", "is_feature_edge", "is_smoothing_surface",
                  "is_connected", "smoothing_surface", "feat_neigh_mask"):
            out[k] = self._tensor(host[k], torch.bool)
        for k in ("corner_targets", "edge_a", "edge_b"):
            out[k] = self._tensor(host[k], self.dtype)
        for k in ("point_strings", "feat_neigh", "edge_strings",
                  "inner_map", "feat_rows", "surf_rows", "smooth_rows"):
            out[k] = self._tensor(host[k], torch.int64)
        return out

    @property
    def n_points(self) -> int:
        """The mesh's point count."""
        return self.topo.n_points

    # -- coordinate transforms ---------------------------------------------
    def denormalize(self, pts=None) -> np.ndarray:
        """Internal points -> external coordinates, original point order."""
        q = (self.points if pts is None else torch.as_tensor(pts))
        q = q.detach().to("cpu", torch.float64).numpy()
        q = q / self._scale + self._center
        return self.to_external_point_field(q)

    def to_external_point_field(self, arr) -> np.ndarray:
        """A per-point array from the internal (reordered) point order to
        the original mesh's."""
        arr = np.asarray(arr)
        if self._orders is None:
            return arr
        return arr[self._orders.point_new]

    # -- the iteration loop ------------------------------------------------
    def _iterate(self):
        """One iteration, counted -> (its StepResult, the new points and
        normals, uncommitted), with one host read."""
        t0 = time.perf_counter()
        new_points, normals, res, n_frozen, n_miss, _ = iteration_body(
            self.points, self.td, self.params, self._scale,
            normals=self.normals, smoothing_surface=self.smoothing_surface,
            layer=self.layer, bnd=self.bnd, sync=self.sync, owned=self.owned)
        scalars = [res.double(), n_frozen.double()]
        if self.bnd is not None:
            scalars.append(n_miss.double())
        res, n_frozen, *miss = torch.stack(scalars).tolist()  # host sync
        self._iteration += 1
        wall = (time.perf_counter() - t0) * 1e3
        return (StepResult(self._iteration, res, int(n_frozen), wall,
                           int(miss[0]) if miss else 0),
                new_points, normals)

    def _check_miss(self, r: StepResult) -> None:
        if r.n_ray_miss and self.params.ray_miss_fatal:
            raise RuntimeError(RAY_MISS_MSG.format(n=r.n_ray_miss))

    def step(self) -> StepResult:
        """One iteration.  When a ray cast misses under
        ``ray_miss_fatal`` it raises ``RuntimeError`` and keeps the points
        and normals, but counts the iteration (as the JAX ``step``)."""
        r, new_points, normals = self._iterate()
        self._check_miss(r)
        self.points = new_points
        self.normals = normals
        return r

    def steps(self, n: int) -> "list[StepResult]":
        """Run up to ``n`` iterations, ``iter_batch`` a dispatch,
        stopping after the first one whose residual is below
        ``rel_tol``; one StepResult per iteration that ran, each with
        its batch's wall time over the iterations that ran in it.  When
        a ray cast misses under ``ray_miss_fatal`` the offending
        iteration is committed (points, normals and the count) and then
        ``RuntimeError`` is raised, as the JAX ``steps`` (and so ``run``
        and the CLI) does.

        A batch stops at an iteration that finds points in the
        face-angle band (:class:`_Batch`); the host runs that iteration
        with the fixed point, and the rest of this call one iteration a
        dispatch."""
        if self.iter_batch <= 1:
            return self._steps_one_by_one(n)
        out = []
        while n > 0:
            t0 = time.perf_counter()
            batch = self._ensure_batch()
            m = min(n, self.iter_batch)
            rows = batch.run(self.points, self.normals, m)
            wall = (time.perf_counter() - t0) * 1e3
            ran = [r for r in rows if r[3]]
            if ran:
                self.points = batch.points.clone()
                self.normals = batch.normals.clone()
            for res, n_frozen, n_miss, _, _ in ran:
                self._iteration += 1
                out.append(StepResult(self._iteration, res, int(n_frozen),
                                      wall / len(ran), int(n_miss)))
            if ran:
                self._check_miss(out[-1])
                if out[-1].residual < self.params.rel_tol:
                    break
            n -= len(ran)
            if len(ran) < m:        # a face-angle stop
                self.face_angle_stops += 1
                out += self._steps_one_by_one(n)
                break
        return out

    def _steps_one_by_one(self, n: int) -> "list[StepResult]":
        out = []
        for _ in range(n):
            r, self.points, self.normals = self._iterate()
            self._check_miss(r)
            out.append(r)
            if r.residual < self.params.rel_tol:
                break
        return out

    def _ensure_batch(self) -> _Batch:
        """The batch of the current tables, parameters and state
        tensors; built (and on the card captured) anew when one of them
        was replaced.  The batch holds them, so their ids stay theirs."""
        key = (id(self.td), id(self.bnd), id(self.layer),
               id(self.smoothing_surface), id(self.sync), id(self.owned),
               repr(self.params), self._scale,
               self.dtype, self.device, self.iter_batch)
        if self._batch is None or self._batch.key != key:
            self._batch = None          # free the old graph's pool first
            self._batch = _Batch(self, key)
        return self._batch

    def prepare_batch(self) -> float:
        """Build (on the card: warm up and capture) the batch that
        :meth:`steps` will run, ahead of it -> the seconds it took."""
        t0 = time.perf_counter()
        self._ensure_batch()
        return time.perf_counter() - t0

    def run(self, log: Optional[Callable[[str], None]] = print,
            on_write: Optional[Callable[[int, np.ndarray], None]] = None,
            profile_dir: Optional[str] = None) -> StepResult:
        """The full iteration loop with convergence + periodic writes
        (reference src/smoothMesh.C:2257-2437).

        ``profile_dir`` captures a ``torch.profiler`` trace of the loop
        (host and, on the card, CUDA activity) into that directory as a
        Chrome trace (view in Perfetto or chrome://tracing); the
        reference only prints a wall clock (:2439).
        """
        t0 = time.time()
        iter_ms = []
        if profile_dir:
            from torch.profiler import (ProfilerActivity, profile,
                                        tensorboard_trace_handler)

            acts = [ProfilerActivity.CPU]
            if self.device.type == "cuda":
                acts.append(ProfilerActivity.CUDA)
            trace = tensorboard_trace_handler(profile_dir)
            with profile(activities=acts, on_trace_ready=trace):
                result = self._run_loop(log, on_write, iter_ms)
        else:
            result = self._run_loop(log, on_write, iter_ms)
        if log:
            # the first batch (or iteration) carries the kernels'
            # first-use build and the graph capture
            steady = iter_ms[max(self.iter_batch, 1):] or iter_ms
            if steady:
                mean_ms = sum(steady) / len(steady)
                rate = self.n_points / (mean_ms / 1e3)
                log(f"Performance: {mean_ms:.3f} ms/iteration, "
                    f"{rate:,.0f} point-updates/s on {self.device}")
            log(f"ClockTime = {time.time() - t0:.1f} s.")
        return result

    def _run_loop(self, log, on_write, iter_ms) -> StepResult:
        p = self.params
        result = StepResult(0, float("inf"), 0)
        total = p.centroidal_iters
        done = 0
        while done < total:
            # stop each window at the next write boundary so on_write
            # observes the exact intermediate state
            n = total - done
            if on_write and p.write_interval > 0:
                boundary = ((done // p.write_interval) + 1) \
                    * p.write_interval
                n = min(n, boundary - done)
            rs = self.steps(n)
            for r in rs:
                iter_ms.append(r.wall_ms)
                if log:
                    miss = (f" nRayMisses={r.n_ray_miss} (frozen)"
                            if r.n_ray_miss else "")
                    log(f"Smoothing iteration={r.iteration} "
                        f"nFrozenPoints={r.n_frozen} "
                        f"residual={r.residual:.6g}{miss}")
            if rs:
                result = rs[-1]
            done += len(rs)
            stop = result.residual < p.rel_tol
            if stop and log:
                log("Residual reached relTol, stopping.")
            if done >= total and not stop and log:
                log("Maximum centroidalIters reached, stopping.")
            if on_write and (stop or done >= total
                             or (p.write_interval > 0
                                 and done % p.write_interval == 0
                                 and done > 1)):
                on_write(result.iteration, self.denormalize())
            if stop or not rs:
                break
        return result

    # -- reporting -----------------------------------------------------------
    def quality(self) -> dict:
        """The checkMesh-style report (``quality.quality_report``) of the
        current points, with length- and volume-valued metrics in
        external units."""
        missing = quality_td_keys(self.device, self.dtype) - set(self.td)
        if missing:
            self.td.update(to_device(self.topo, self.device, missing))
        rep = quality_report(self.points, self.td)
        # undo normalization on length/volume-valued metrics
        s = self._scale
        for k in ("min_edge_length", "max_edge_length"):
            rep[k] /= s
        for k in ("min_volume", "max_volume", "total_volume",
                  "min_pyramid_volume"):
            rep[k] /= s ** 3
        return rep
