"""A decomposition's shards on several devices of one process, one host
thread a device.

The counterpart of the JAX package's single controller over several
devices: ``HaloSmoother(devices=)`` and ``ShardedSmoother(devices=)``
build a ``Mesh(np.array(devices), ("shard",))`` and run one shard a
device under ``shard_map``, their exchanges XLA collectives
(``smoothmesh_tpu/parallel/halo.py:584-631``,
``smoothmesh_tpu/parallel/sharded.py:34-65``,
``smoothmesh_tpu/parallel/sync.py:95-209``).  Here:

  - :class:`CardGroup` holds D members, each with its device and, on
    ``cuda``, a stream of its own; :meth:`CardGroup.run` calls a
    function once in each member's host thread, all at once (the
    ``torch.nn.parallel.parallel_apply`` pattern), the thread's current
    card and stream the member's;
  - a :class:`Member` is the group interface of
    ``parallel.sync.ProcessGroup`` (``rank``, ``world``,
    ``all_reduce``, ``all_gather_object``, ``reports``, ``once``), so
    the exchanges (``DistSync``, ``DistPointSync``) and
    ``UnionSmoother`` run on it as they run on the ranks.  An
    ``all_reduce`` meets the other members at a barrier, copies their
    buffers to its own device and reduces them in shard order 0..D-1;
    the reductions the exchanges make are exact in any order (one
    value plus zeros, max, min), so the members' results are bit-equal
    to the union's of all shards on one device (``UnionSync``,
    ``UnionPointSync``);
  - :class:`CardSmoother` is a decomposition's smoother over a group:
    the decomposition's ``UnionSmoother`` of one shard on each device,
    from shards built once on the host, driven together with the
    classes' surface.

A member that raises aborts the barrier, so no other member is left
waiting, and :meth:`CardGroup.run` raises the first member's exception
in the caller; a collective that waits longer than
``ranks.COLLECTIVE_TIMEOUT_S`` raises too.  Nothing falls back to
fewer devices or to another form.  The exchanges are eager: the
batched driver captures none of them into a CUDA graph.
"""

from __future__ import annotations

import threading
from typing import Callable, List, Sequence

import numpy as np
import torch

from smoothmesh_torch import kernels
from smoothmesh_torch.device import resolve_device
from smoothmesh_torch.parallel.ranks import COLLECTIVE_TIMEOUT_S

#: the element-wise reductions of ``all_reduce``
_FOLDS = {"SUM": torch.add, "MAX": torch.maximum, "MIN": torch.minimum}


class GroupBroken(RuntimeError):
    """A member's collective could not complete: another member failed,
    or the members did not all arrive within the timeout."""


class CardGroup:
    """D members, one a device of ``devices`` (all ``cuda`` or all the
    CPU; a device may be listed more than once, then its members share
    it, each on its own stream)."""

    def __init__(self, devices: Sequence, timeout_s: float =
                 COLLECTIVE_TIMEOUT_S):
        devs = [torch.device(d) for d in devices]
        kinds = {d.type for d in devs}
        if not devs or len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
            raise ValueError(f"a card group runs on cuda devices or on the "
                             f"CPU, one kind: not {devices}")
        self.on_cuda = "cuda" in kinds
        if self.on_cuda:
            devs = [torch.device("cuda", torch.cuda.current_device()
                                 if d.index is None else d.index)
                    for d in devs]
        self.devices = devs
        self.world = len(devs)
        self.timeout_s = float(timeout_s)
        self.members = [Member(self, r) for r in range(self.world)]
        self.streams = ([torch.cuda.Stream(d) for d in devs]
                        if self.on_cuda else [None] * self.world)
        self._barrier = threading.Barrier(self.world, timeout=timeout_s)
        self._lock = threading.Lock()
        # what the members hand each other inside one collective
        self._board = [None] * self.world
        self._done = [None] * self.world
        # ``once`` results, kept for one ``run``
        self._once = {}

    # -- the runner -----------------------------------------------------------
    def run(self, fn: Callable[["Member"], object]) -> list:
        """``fn(member)`` in each member's thread, all at once -> the
        results in rank order.  On ``cuda`` each thread runs with its
        member's card current and its stream as the current stream,
        which first waits for the caller's current stream on that card;
        the thread synchronizes its stream before it returns, so the
        results are ready for the caller.  On the CPU torch runs one
        intra-op thread while the members run (the caller's count comes
        back after).  Raises the first exception a member raised (a
        member left without its peers raises :class:`GroupBroken`,
        reported only where no other exception is) once every thread
        has ended."""
        errors: List[BaseException] = []
        results = [None] * self.world
        callers = ([torch.cuda.current_stream(d) for d in self.devices]
                   if self.on_cuda else None)

        def main(m: Member) -> None:
            kernels.count_as(m.rank)
            try:
                if self.on_cuda:
                    torch.cuda.set_device(m.device)
                    stream = self.streams[m.rank]
                    stream.wait_stream(callers[m.rank])
                    with torch.cuda.stream(stream):
                        results[m.rank] = fn(m)
                    stream.synchronize()
                else:
                    torch.set_num_threads(1)
                    results[m.rank] = fn(m)
            except BaseException as e:  # noqa: BLE001 -- raised in run()
                with self._lock:
                    errors.append(e)
                self._barrier.abort()

        threads = [threading.Thread(target=main, args=(m,), daemon=True,
                                    name=f"card-member-{m.rank}")
                   for m in self.members]
        n_threads = torch.get_num_threads()
        try:
            for t in threads:
                t.start()
            for t in threads:
                t.join()
        finally:
            torch.set_num_threads(n_threads)
        self._once.clear()
        self._board = [None] * self.world
        if errors:
            self._barrier.reset()
            raise next((e for e in errors if not isinstance(e, GroupBroken)),
                       errors[0])
        return results

    # -- the collectives ----------------------------------------------------
    def _wait(self) -> None:
        try:
            self._barrier.wait()
        except threading.BrokenBarrierError as e:
            raise GroupBroken(
                "a card-group collective was left: another member failed, "
                f"or the members did not all arrive within {self.timeout_s}"
                " s") from e

    def _all_reduce(self, rank: int, buf: torch.Tensor, op: str):
        fold = _FOLDS[op]
        dev = self.devices[rank]
        event = None
        if self.on_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(dev))
        self._board[rank] = (buf, event)
        self._wait()
        acc = None
        for j, (src, ev) in enumerate(self._board):
            if ev is not None and j != rank:
                # the copy runs on this thread's current stream of the
                # source's card (its own stream where the card is
                # shared), and this member's stream waits for it
                torch.cuda.current_stream(src.device).wait_event(ev)
            x = src.to(dev)
            acc = x if acc is None else fold(acc, x)
        if self.on_cuda:
            # every read of the others' buffers is ordered before this
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(dev))
            self._done[rank] = done
        self._wait()
        if self.on_cuda:
            # no write of this buffer before the others have read it
            stream = torch.cuda.current_stream(dev)
            for j, done in enumerate(self._done):
                if j != rank:
                    stream.wait_event(done)
        if acc is not buf:
            buf.copy_(acc)
        return buf

    def _all_gather_object(self, rank: int, x) -> list:
        self._board[rank] = x
        self._wait()
        out = list(self._board)
        self._wait()
        return out

    def _once_get(self, key, fn):
        with self._lock:
            slot = self._once.setdefault(key, [threading.Lock(), None])
        with slot[0]:
            if slot[1] is None:
                try:
                    slot[1] = (fn(), None)
                except BaseException as e:  # noqa: BLE001 -- re-raised
                    slot[1] = (None, e)
        value, err = slot[1]
        if err is not None:
            raise err
        return value


class Member:
    """One member of a :class:`CardGroup`: the group interface of
    ``parallel.sync.ProcessGroup`` for the member's thread."""

    def __init__(self, group: CardGroup, rank: int):
        self.group = group
        self.rank = rank

    @property
    def world(self) -> int:
        return self.group.world

    @property
    def device(self) -> torch.device:
        return self.group.devices[self.rank]

    @property
    def reports(self) -> bool:
        """One member (rank 0) returns a report that one member computes
        alone."""
        return self.rank == 0

    def all_reduce(self, buf: torch.Tensor, op: str) -> torch.Tensor:
        """``buf`` reduced in place with ``op`` ("SUM", "MAX" or "MIN")
        over the members' buffers, folded in rank order -> ``buf``."""
        return self.group._all_reduce(self.rank, buf, op)

    def all_gather_object(self, x) -> list:
        """Every member's ``x``, in rank order (the objects themselves)."""
        return self.group._all_gather_object(self.rank, x)

    def once(self, key, fn):
        """``fn()``, computed by the first member that asks for ``key``
        in this :meth:`CardGroup.run` and handed to the others (the host
        build and set-up that every member would repeat)."""
        return self.group._once_get(key, fn)


class CardSmoother:
    """A decomposition's smoother over ``devices``, one shard a device,
    in this process: what ``HaloSmoother(mesh, params, devices=[...])``
    and ``ShardedSmoother(..., devices=[...])`` return for more than one
    device.

    Each member of a :class:`CardGroup` is ``cls`` (the decomposition's
    ``UnionSmoother``) of one shard on its device, the shards built
    once on the host.  The surface is the classes': :meth:`steps`,
    :meth:`step`, :meth:`run`, :meth:`enable_boundary_smoothing`,
    :meth:`time_stages`, :meth:`quality`, :meth:`denormalize`,
    :meth:`shard_points`, :attr:`points` and :attr:`setup_times`;
    each call runs in every member at once and returns rank 0's result
    (the residuals and the counts are all-reduced, so every member's
    record is equal).  ``params``, ``stats``, ``mesh``, ``shards``,
    ``topo`` (rank 0's union; its patches are the mesh's), ``dtype``,
    ``n_points``, ``iter_batch``, ``boundary_setup``, ``layer``, ``bnd``
    and ``trace`` are rank 0's.  On ``cuda`` float32 every kernel is
    built before the members start.
    """

    _SHARED = ("params", "stats", "mesh", "shards", "topo", "dtype",
               "n_points", "iter_batch", "boundary_setup", "layer", "bnd",
               "trace")

    def __init__(self, cls, devices: Sequence, mesh, params, n_shards=None,
                 dtype=None, normalize: bool = True, device=None,
                 distributed: bool = False):
        if device is not None or distributed:
            raise ValueError("devices= puts one shard on each device in "
                             "this process: give no device= and no "
                             "distributed=")
        devices = [resolve_device(d) for d in devices]
        if n_shards not in (None, len(devices)):
            raise ValueError(f"n_shards {n_shards} != {len(devices)} "
                             "devices")
        self.cls = cls
        self.group = CardGroup(devices)
        self.devices = self.group.devices
        if self.group.on_cuda and kernels.takes_kernel(
                self.devices[0], torch.float32 if dtype is None else dtype,
                cls.__name__):
            kernels.build_all()
        self.members = self.group.run(
            lambda m: cls(mesh, params, dtype=dtype, normalize=normalize,
                          group=m))

    def __getattr__(self, name):
        if name in CardSmoother._SHARED and "members" in self.__dict__:
            return getattr(self.members[0], name)
        raise AttributeError(f"{type(self).__name__} has no {name!r}")

    def _each(self, fn) -> list:
        """``fn(member smoother)`` in every member's thread -> the
        results in rank order."""
        return self.group.run(lambda m: fn(self.members[m.rank]))

    # -- the iteration --------------------------------------------------------
    def steps(self, n: int) -> list:
        return self._each(lambda sm: sm.steps(n))[0]

    def step(self):
        return self._each(lambda sm: sm.step())[0]

    def run(self, log=print, on_write=None, profile_dir=None):
        """``Smoother.run``'s loop in every member; rank 0 logs, writes and
        (with ``profile_dir``) traces, the others run the same loop,
        collectives included (each write's ``denormalize``), printing
        and writing nothing."""
        def member_run(sm):
            if sm is self.members[0]:
                return sm.run(log, on_write, profile_dir)
            return sm.run(None, (lambda it, pts: None) if on_write else None)

        return self._each(member_run)[0]

    def enable_boundary_smoothing(self, *args, **kw):
        return self._each(
            lambda sm: sm.enable_boundary_smoothing(*args, **kw))[0]

    def time_stages(self, on: bool) -> None:
        for sm in self.members:
            sm.time_stages(on)

    # -- results -----------------------------------------------------------
    def quality(self) -> dict:
        return self._each(lambda sm: sm.quality())[0]

    def denormalize(self, pts=None) -> np.ndarray:
        """The global mesh's points in external units, each from its
        owner; ``pts``: internal points in the layout of :attr:`points`
        (default the current ones)."""
        if pts is None:
            return self._each(lambda sm: sm.denormalize())[0]
        pts = torch.as_tensor(pts)
        ends = np.cumsum([0] + [sm.points.shape[0] for sm in self.members])
        return self._each(lambda sm: sm.denormalize(
            pts[ends[sm.group.rank]:ends[sm.group.rank + 1]]))[0]

    @property
    def points(self) -> torch.Tensor:
        """The members' internal points one after another on the host:
        the layout of the union of all shards on one device."""
        return torch.cat([sm.points.cpu() for sm in self.members])

    def shard_points(self) -> np.ndarray:
        """(D, Npad, 3) internal points of the shards, padded rows 0."""
        return np.concatenate([sm.shard_points() for sm in self.members])

    @property
    def setup_times(self) -> dict:
        """Rank 0's set-up seconds (the shard build is its wait for the
        build, which one member runs for all)."""
        return self.members[0].setup_times
