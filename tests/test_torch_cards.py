"""The decompositions over several devices in one process, one host
thread a device (smoothmesh_torch.parallel.cards), on the CPU.

- ``HaloSmoother`` and ``ShardedSmoother`` with ``devices=["cpu"] * 3``
  (three members, three threads) against the same class's union of 3
  shards on one device: the results, the points, ``denormalize()`` and
  the shard blocks bit-equal; ``quality()`` equal (the halo's parts
  are summed a member at a time, as the ranks sum them: within 1e-12
  relative); on the 10x8x8 hex under 60/120 (the face angle bites,
  so the batches stop and the host reruns, in every member alike) and
  on tc5 with layers and boundary smoothing.
- (The port's ``ShardedSmoother(devices=["cpu"] * 3)`` against the JAX
  ``ShardedSmoother(devices=jax.devices()[:3])`` is
  tests/test_torch_sharded.py's ``test_sharded_members_match_jax_f64``,
  beside the JAX run that file builds once a process.)
- The group's collectives: folds in rank order, -0.0 arriving as +0.0,
  the objects gathered; a member that raises at its second exchange
  makes the call raise at once and leaves no thread behind; a member
  that never arrives makes the others raise at the timeout.
- ``Smoother(n_devices=2)`` on one card refused before any build; the
  CLI's ``-parallel`` on four cards puts one shard on each in this
  process; one kernel build for two threads that load it together; no
  launch count lost under many threads.
"""

import contextlib
import dataclasses
import io
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from smoothmesh_torch import cli, kernels
from smoothmesh_torch import testcases as ttc
from smoothmesh_torch.driver import Smoother
from smoothmesh_torch.io.polymesh import write_polymesh
from smoothmesh_torch.mesh.blockmesh import hex_block, perturb
from smoothmesh_torch.parallel import cards, halo, sharded
from smoothmesh_torch.parallel.cards import CardGroup, CardSmoother
from smoothmesh_torch.parallel.halo import HaloSmoother
from smoothmesh_torch.parallel.sharded import ShardedSmoother
from smoothmesh_torch.params import SmoothingParams

torch.set_num_threads(1)

ITERS = 4
WORLD = 3
#: tc5's max step, above its raw steps (tests/test_torch_sharded.py)
BND_MAX_STEP = 0.25
CLASSES = {"halo": HaloSmoother, "disjoint": ShardedSmoother}
#: the halo's report sums its members' parts, the union's is one part
HALO_QUALITY_REL = 1e-12


def _hex(name):
    if name == "hex":
        return (perturb(hex_block(n=(10, 8, 8)), amplitude=0.06, seed=7),
                SmoothingParams(centroidal_iters=ITERS, rel_tol=0.0,
                                min_angle=60.0, max_angle=120.0), None)
    tc = ttc.ALL[name]()
    return tc.mesh, dataclasses.replace(
        tc.params, centroidal_iters=ITERS, rel_tol=0.0,
        max_step_length=BND_MAX_STEP), tc.geometry


def _row(r):
    return dataclasses.astuple(r)[:3] + dataclasses.astuple(r)[4:]


@pytest.mark.parametrize("case", ["hex", "tc5"])
@pytest.mark.parametrize("kind", list(CLASSES))
def test_members_match_the_union(kind, case):
    mesh, params, geometry = _hex(case)
    cls = CLASSES[kind]
    start = threading.active_count()
    got = cls(mesh, params, devices=["cpu"] * WORLD, dtype=torch.float64)
    want = cls(mesh, params, n_shards=WORLD, device="cpu",
               dtype=torch.float64)
    assert type(got) is CardSmoother and len(got.members) == WORLD
    assert all(not m.sync.capturable for m in got.members)
    if geometry is not None:
        setup = got.enable_boundary_smoothing(*geometry)
        want.enable_boundary_smoothing(*geometry)
        assert got.layer is not None and got.bnd is not None
        np.testing.assert_array_equal(setup.is_corner,
                                      want.boundary_setup.is_corner)
    results = got.steps(ITERS)
    assert [_row(r) for r in results] == \
        [_row(r) for r in want.steps(ITERS)]
    if case == "hex":       # the band stops the batches and bites
        assert min(m.face_angle_stops for m in got.members) > 0
        assert max(r.n_frozen for r in results) > 0
    assert torch.equal(got.points, want.points)
    np.testing.assert_array_equal(got.shard_points(), want.shard_points())
    np.testing.assert_array_equal(got.denormalize(), want.denormalize())
    q, q0 = got.quality(), want.quality()
    assert set(q) == set(q0)
    for k, v in q0.items():
        if kind == "disjoint" or isinstance(v, int):
            assert q[k] == v, k
        else:
            assert q[k] == pytest.approx(v, rel=HALO_QUALITY_REL), k
    assert threading.active_count() == start


# -- the group's collectives -------------------------------------------

def test_collectives_fold_in_rank_order():
    g = CardGroup(["cpu"] * WORLD)
    vals = [torch.tensor([0.1, -0.0, 1.0, 3.0], dtype=torch.float64),
            torch.tensor([0.2, 0.0, -5.0, 2.0], dtype=torch.float64),
            torch.tensor([0.3, -0.0, 4.0, 7.0], dtype=torch.float64)]

    def member(m):
        out = {op: m.all_reduce(vals[m.rank].clone(), op)
               for op in ("SUM", "MAX", "MIN")}
        out["objects"] = m.all_gather_object({"rank": m.rank})
        return out

    for out in g.run(member):
        assert torch.equal(out["SUM"], (vals[0] + vals[1]) + vals[2])
        assert not torch.signbit(out["SUM"][1])
        assert torch.equal(out["MAX"], torch.maximum(
            torch.maximum(vals[0], vals[1]), vals[2]))
        assert torch.equal(out["MIN"], torch.minimum(
            torch.minimum(vals[0], vals[1]), vals[2]))
        assert out["objects"] == [{"rank": r} for r in range(WORLD)]


def test_a_failing_member_raises_and_leaves_no_thread(monkeypatch):
    mesh, params, _ = _hex("hex")
    start = threading.active_count()
    hs = HaloSmoother(mesh, params, devices=["cpu"] * WORLD,
                      dtype=torch.float64)
    calls = {}
    reduce = CardGroup._all_reduce

    def failing(self, rank, buf, op):
        calls[rank] = calls.get(rank, 0) + 1
        if rank == 1 and calls[rank] == 2:
            raise OSError("member 1 lost its card")
        return reduce(self, rank, buf, op)

    monkeypatch.setattr(CardGroup, "_all_reduce", failing)
    t0 = time.perf_counter()
    with pytest.raises(OSError, match="member 1 lost its card"):
        hs.steps(ITERS)
    assert time.perf_counter() - t0 < 5.0
    assert threading.active_count() == start
    # the group is whole again: the next call runs
    monkeypatch.setattr(CardGroup, "_all_reduce", reduce)
    assert hs.step().iteration == 1


def test_a_member_that_never_arrives_times_out():
    g = CardGroup(["cpu"] * 2, timeout_s=0.5)
    buf = torch.zeros(3)
    t0 = time.perf_counter()
    with pytest.raises(cards.GroupBroken, match="within 0.5 s"):
        g.run(lambda m: m.all_reduce(buf.clone(), "SUM") if m.rank == 0
              else None)
    assert time.perf_counter() - t0 < 5.0


# -- the placement rules ------------------------------------------------------

def test_n_devices_beyond_the_cards_is_refused_before_any_build(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)

    def no_build(*a, **k):
        raise AssertionError("a shard build started")

    monkeypatch.setattr(halo, "build_halo_shards", no_build)
    monkeypatch.setattr(sharded, "build_shards", no_build)
    mesh, params, _ = _hex("hex")
    for kw in ({}, {"use_tile_engine": False}):
        with pytest.raises(ValueError, match="n_devices=2 puts one shard on "
                           "each of 2 cards, and this machine has 1"):
            Smoother(mesh, params, n_devices=2, device="cuda", **kw)


class _Stop(Exception):
    pass


def test_cli_parallel_takes_every_card_in_this_process(monkeypatch,
                                                       tmp_path):
    root = str(tmp_path / "case")
    os.makedirs(os.path.join(root, "system"))
    with open(os.path.join(root, "system", "controlDict"), "w") as f:
        f.write("deltaT 1;\n")
    write_polymesh(os.path.join(root, "constant", "polyMesh"),
                   hex_block(n=(2, 2, 2)))
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    cuda = torch.device("cuda")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(cli, "resolve_device", lambda d: cuda)
    assert cli.parallel_shards(cuda) == (4, False, cuda)
    made = []

    def fake(*a, **kw):
        made.append(kw)
        raise _Stop

    monkeypatch.setattr("smoothmesh_torch.parallel.sharded.ShardedSmoother",
                        fake)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), pytest.raises(_Stop):
        cli.main(["-case", root, "-parallel"])
    assert "Running sharded over 4 shards (4 cards in this process)" in \
        out.getvalue()
    assert made == [dict(dtype=None, devices=[torch.device("cuda", i)
                                              for i in range(4)])]


# -- the kernels under several threads ---------------------------------

def test_two_threads_loading_one_kernel_start_one_build(monkeypatch):
    k = kernels.Kernel("T test", "gather.cu", "smk_test", [], "nowhere")
    starts = []

    def start_build(self):
        starts.append(threading.get_ident())
        time.sleep(0.2)

    monkeypatch.setattr(kernels.Kernel, "_start_build", start_build)
    monkeypatch.setattr(kernels.Kernel, "_open", lambda self: "entry")
    got = []
    threads = [threading.Thread(target=lambda: got.append(k.load()))
               for _ in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads)
    assert len(starts) == 1 and got == ["entry", "entry"]


def test_launch_counts_lose_nothing_under_many_threads():
    k = kernels.Kernel("T test", "gather.cu", "smk_test", [], "nowhere")
    n_threads, n = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def count(member):
            kernels.count_as(member)
            for _ in range(n):
                k._count(1)

        threads = [threading.Thread(target=count, args=(i % 4,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert k.launches == n_threads * n
    assert k.member_launches == {m: n_threads // 4 * n for m in range(4)}
