"""The ranks' backend and card rule (``parallel.ranks.join``), the
kernels' launches on the card of their tensors, an NCCL rank's device
rule in ``UnionSmoother``, and the exchanges of a world of one (no
shared point) against the union at one shard.

No test here needs a card: ``torch.cuda`` and
``torch.distributed.init_process_group`` are patched where a rule is
checked, and the world of one is a gloo group of this process on the
CPU.
"""

import dataclasses
from contextlib import contextmanager

import numpy as np
import pytest
import torch
import torch.distributed as dist

from smoothmesh_torch import geometry as geo
from smoothmesh_torch import kernels
from smoothmesh_torch import layers as lay
from smoothmesh_torch.device import to_device
from smoothmesh_torch.driver import CUDA_TD_KEYS, NORMALS_TD_KEYS
from smoothmesh_torch.mesh.blockmesh import hex_block, perturb
from smoothmesh_torch.mesh.topology import compile_topology
from smoothmesh_torch.ops import constraints as con
from smoothmesh_torch.ops import gather, raycast
from smoothmesh_torch.ops import smoothing as smo
from smoothmesh_torch.parallel import ranks, union
from smoothmesh_torch.parallel.halo import HaloSmoother
from smoothmesh_torch.parallel.sharded import ShardedSmoother
from smoothmesh_torch.parallel.sync import DistSync, UnionSync
from smoothmesh_torch.params import SmoothingParams

torch.set_num_threads(1)

ITERS = 4


class _Cards:
    """``torch.cuda`` and the process group's entry, patched: ``n``
    cards, ``current`` the current one; ``events`` records the calls in
    order."""

    def __init__(self, monkeypatch, n=2, current=0, nccl=True):
        self.events = []
        self.current = current
        mp = monkeypatch
        mp.setattr(torch.cuda, "device_count", lambda: n)
        mp.setattr(torch.cuda, "set_device", self._set_device)
        mp.setattr(torch.cuda, "current_device", lambda: self.current)
        mp.setattr(dist, "is_nccl_available", lambda: nccl)
        mp.setattr(dist, "init_process_group", self._init)
        for k in ("LOCAL_RANK", "LOCAL_WORLD_SIZE"):
            mp.delenv(k, raising=False)

    def _set_device(self, device):
        self.current = torch.device(device).index
        self.events.append(("set_device", torch.device(device)))

    def _init(self, backend, **kw):
        self.events.append(("init", backend, kw["rank"], kw["world_size"]))


def test_join_cpu_takes_gloo(monkeypatch):
    cards = _Cards(monkeypatch)
    assert ranks.join("cpu", 1, 3) == torch.device("cpu")
    assert cards.events == [("init", "gloo", 1, 3)]


def test_join_cuda_takes_nccl_on_the_local_card(monkeypatch):
    cards = _Cards(monkeypatch, n=2)
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    dev = ranks.join(torch.device("cuda"), 3, 4)
    assert dev == torch.device("cuda", 1)
    # the card is made current before the group is joined
    assert cards.events == [("set_device", torch.device("cuda", 1)),
                            ("init", "nccl", 3, 4)]
    # without torchrun's variables the card is the rank's
    monkeypatch.delenv("LOCAL_RANK")
    monkeypatch.delenv("LOCAL_WORLD_SIZE")
    cards.events.clear()
    assert ranks.join("cuda", 0, 2) == torch.device("cuda", 0)
    assert cards.events[-1] == ("init", "nccl", 0, 2)


@pytest.mark.parametrize("rank", [0, 1])
def test_join_refuses_more_ranks_than_cards(monkeypatch, rank):
    cards = _Cards(monkeypatch, n=1)
    with pytest.raises(RuntimeError, match=r"2 NCCL ranks .* 1 card"):
        ranks.join("cuda", rank, 2)
    assert cards.events == []          # no set_device, no join


def test_join_gloo_on_cuda_when_named(monkeypatch):
    cards = _Cards(monkeypatch, n=1)
    assert ranks.join("cuda", 1, 2, backend="gloo") == torch.device("cuda")
    assert cards.events == [("init", "gloo", 1, 2)]


def test_join_without_nccl_raises(monkeypatch):
    cards = _Cards(monkeypatch, nccl=False)
    with pytest.raises(RuntimeError, match="no NCCL"):
        ranks.join("cuda", 0, 1)
    assert cards.events == []


def test_join_refuses_another_card_under_nccl(monkeypatch):
    cards = _Cards(monkeypatch, n=2)
    with pytest.raises(ValueError, match="runs on cuda:1, not on cuda:0"):
        ranks.join("cuda:0", 1, 2)
    assert cards.events == []


def test_run_ranks_reports_the_rank_that_failed(tmp_path):
    """A rank that cannot join (NCCL on the CPU) ends the run with its
    log, before any collective; every process has ended."""
    mesh = hex_block(n=(2, 2, 2))
    job = ranks.Job(mesh, SmoothingParams(centroidal_iters=1), 1,
                    device="cpu", backend="nccl")
    with pytest.raises(RuntimeError, match="NCCL runs on cuda, not on cpu"):
        ranks.run_ranks(job, 2, tmp_path, timeout_s=120)


# -- the launch on the tensors' card ------------------------------------------

class _Streams:
    """``torch.cuda``'s device guard and streams, patched: the current
    device is ``current``; a stream of device i has handle 100 + i."""

    def __init__(self, monkeypatch, current=0):
        self.current = current
        self.asked = []
        mp = monkeypatch
        mp.setattr(torch.cuda, "device", self._guard)
        mp.setattr(torch.cuda, "current_stream", self._stream)
        mp.setattr(torch.cuda, "is_current_stream_capturing", lambda: False)

    @contextmanager
    def _guard(self, device):
        saved, self.current = self.current, torch.device(device).index
        try:
            yield
        finally:
            self.current = saved

    def _stream(self, device=None):
        index = self.current if device is None else \
            torch.device(device).index
        self.asked.append(index)

        class S:
            cuda_stream = 100 + index
        return S()


def test_launch_takes_the_stream_of_its_tensors_card(monkeypatch):
    streams = _Streams(monkeypatch, current=0)
    seen = []

    def fn(*args):
        seen.append((args, streams.current))
        return 0

    k = kernels.FACE_GEOMETRY
    monkeypatch.setattr(k, "_fn", fn)
    monkeypatch.setattr(k, "launches", 0)
    k.launch(11, 12, device=torch.device("cuda", 1))
    # cuda:1's stream, launched with cuda:1 current; cuda:0 current after
    assert seen == [((11, 12, 101), 1)]
    assert streams.asked == [1] and streams.current == 0
    assert k.launches == 1


def _wrapper_inputs():
    """A 3^3 hex's float32 inputs on the CPU, in the kernels' tables."""
    mesh = perturb(hex_block(n=(3, 3, 3)), amplitude=0.05, seed=1)
    topo = compile_topology(mesh)
    td = to_device(topo, "cpu", CUDA_TD_KEYS | NORMALS_TD_KEYS)
    pts = torch.tensor(mesh.points, dtype=torch.float32)
    fg = geo.face_centres_areas_plain(pts, td["face_points"],
                                      td["face_mask"], td["face_npoints"])
    cc = torch.zeros((topo.n_cells, 3), dtype=torch.float32)
    frozen = torch.zeros(topo.n_points, dtype=torch.bool)
    ue = torch.zeros((td["edges"].shape[0], 2), dtype=torch.float32)
    tri = torch.zeros((9, 5), dtype=torch.float32)
    return {
        "K1": lambda: geo.face_centres_areas(
            pts, td["face_points"], td["face_mask"], td["face_npoints"]),
        "K2": lambda: geo.cell_centres_vols(fg, td),
        "K3": lambda: smo.predictor(pts, cc, td, 0.1, 0.5, False),
        "K4": lambda: con.freeze_constraints(pts, pts, td, 0.01, False, 0.5,
                                             True, frozen),
        "K5": lambda: con.edge_face_angles(pts, fg.means, cc, td),
        "K6": lambda: con.point_face_angles(ue, td),
        "K7": lambda: gather.table_gather(cc, td["point_cells"],
                                          td["point_cells_mask"]),
        "K8": lambda: raycast.segment_triangle_hits(pts, pts, 1.0, tri),
        "K9": lambda: lay.accumulate_point_normals(pts, fg.areas, td),
    }


@pytest.mark.parametrize("kernel", [k.name for k in kernels.ALL])
def test_each_wrapper_launches_on_its_outputs_device(monkeypatch, kernel):
    """Each wrapper hands its launch the device of the tensor it writes
    (here the CPU, with the kernel route forced and the launch
    recorded)."""
    asked = []

    def launch(self, *args, device):
        asked.append((self.name, device))

    monkeypatch.setattr(kernels, "takes_kernel", lambda *a: True)
    monkeypatch.setattr(kernels.Kernel, "launch", launch)
    monkeypatch.setattr(raycast, "_sm_count", lambda index: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    out = _wrapper_inputs()[kernel.split()[0]]()
    first = out if torch.is_tensor(out) else out[0]
    assert asked == [(kernel, first.device)]


# -- an NCCL rank's device ----------------------------------------------------

@pytest.mark.parametrize("device,ok", [("cuda", True), ("cuda:0", True),
                                       ("cuda:1", False), ("cpu", False)])
def test_union_smoother_takes_only_the_ranks_card_under_nccl(
        monkeypatch, device, ok):
    monkeypatch.setattr(dist, "get_backend", lambda: "nccl")
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    dev = torch.device(device)
    if ok:
        assert union._rank_device(dev) == torch.device("cuda", 0)
        return
    monkeypatch.setattr(union, "resolve_device", torch.device)
    with pytest.raises(ValueError, match="NCCL rank's shard runs on its "
                       "card, cuda:0"):
        HaloSmoother(hex_block(n=(2, 2, 2)), SmoothingParams(),
                     device=device, distributed=True)


# -- a world of one -----------------------------------------------------------

@pytest.fixture
def world_of_one(tmp_path):
    """This process as the one rank of a gloo group, joined by
    ``join``; left when the test ends."""
    store = dist.FileStore(str(tmp_path / "store"), 1)
    assert ranks.join("cpu", 0, 1, store=store) == torch.device("cpu")
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_dist_sync_with_no_shared_point(world_of_one):
    """S = 0: the exchanges reduce nothing and return the union's."""
    empty = torch.zeros(0, dtype=torch.int64)
    dsync = DistSync(empty, empty, empty.bool(), 0)
    usync = UnionSync(empty, empty, empty, 0)
    gen = torch.Generator().manual_seed(5)
    field = torch.randn((7, 3), generator=gen, dtype=torch.float64)
    mask = torch.rand(7, generator=gen) > 0.5
    for op, x in (("consensus", field), ("or_", mask), ("sum", field)):
        assert torch.equal(getattr(dsync, op)(x), getattr(usync, op)(x)), op
    assert float(dsync.all_max(field.max())) == float(field.max())


@pytest.mark.parametrize("cls", [HaloSmoother, ShardedSmoother])
def test_world_of_one_matches_the_union_at_one_shard(world_of_one, cls):
    mesh = perturb(hex_block(n=(6, 5, 4)), amplitude=0.06, seed=7)
    params = SmoothingParams(centroidal_iters=ITERS, rel_tol=0.0,
                             min_angle=60.0, max_angle=120.0)
    got = cls(mesh, params, device="cpu", dtype=torch.float64,
              distributed=True)
    want = cls(mesh, params, n_shards=1, device="cpu", dtype=torch.float64)
    assert len(got.union.pair_rows) == 0 and not got.sync.capturable
    row = lambda r: dataclasses.astuple(r)[:3] + dataclasses.astuple(r)[4:]
    assert [row(r) for r in got.steps(ITERS)] == \
        [row(r) for r in want.steps(ITERS)]
    assert torch.equal(got.points, want.points)
    np.testing.assert_array_equal(got.denormalize(), want.denormalize())
    rep = got.quality()
    for k, v in want.quality().items():
        assert rep[k] == pytest.approx(v, rel=1e-12), k
