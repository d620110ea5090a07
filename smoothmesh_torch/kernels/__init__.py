"""Build, load and launch the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` into
its own shared library with a plain C interface, at first use, into
``smoothmesh_torch/build/`` (named by a hash of the sources and flags,
so an edited source is rebuilt), and loaded with ``ctypes``.  Nothing is
compiled or loaded at import time: the CPU tests import every module on
machines with no ``nvcc`` and no card.

Each C entry point launches on the stream it is given, allocates
nothing, and returns ``cudaGetLastError()``.  :meth:`Kernel.launch`
takes the device of the wrapper's tensors and launches under that
device on its current stream (not on the current device's: with several
cards a wrapper's tensors may lie on another); it raises if the entry
point returned an error and otherwise adds one to the kernel's launch
count.  A launch made while the stream is being captured into a CUDA
graph (:class:`Graph`) runs nothing then: it is counted as captured,
and each replay of the graph adds the launches it captured to the
counts.

Several host threads may launch at once (the members of a
``parallel.cards.CardGroup``, one a card): a kernel is built and loaded
once, under a lock, and the counts are kept under another, in total
and for each member (:func:`count_as`).

Arithmetic: ``--fmad=false`` keeps ``a*b+c`` as two rounded operations,
as the plain PyTorch versions compute it, so the kernels agree with
them to the last bits where the sums run in the same order; K1, K2, K4,
K5, K6, K7, K8 and K9 equal theirs bit for bit (the plain K1, K2 and K9
sum their slots in slot order, as the kernels do).  K1-K3, K6, K7 and
K9 are bound by memory traffic (K7 only copies).  K4 and K5 are not:
the latency of their scattered gathers sets their pace, and before
their redesign each IEEE division's range check and slow-path branch
did too, so both now divide with the compiler's own fast-path sequence
and check the operands once per point or edge (``csrc/freeze.cu``); K1
and K2 divide so too, with one check for each three quotients
(``smk::div3``).  K8 (the ray cast) is bound by its operations.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Sequence

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC",
)

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float

#: held while a kernel is built and loaded (builds of one process name
#: their temporary files after the process, so two threads would collide)
_BUILD_LOCK = threading.RLock()
#: held while a count changes (``+=`` from several threads loses counts)
_COUNT_LOCK = threading.Lock()
#: ``member``: the card-group member whose launches this thread counts
_THREAD = threading.local()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    return os.path.join(home, "bin", "nvcc")


def parse_ptxas(log: str) -> list:
    """[(entry function, registers, shared bytes, spilled bytes)] from
    an nvcc log with ``-Xptxas=-v``."""
    out, spills, fn = [], {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and fn:            # ptxas prints it before the registers
            spills[fn] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            smem = re.search(r"(\d+) bytes smem", line)
            out.append((fn, int(m.group(1)),
                        int(smem.group(1)) if smem else 0,
                        spills.get(fn, 0)))
    return out


class Kernel:
    """One CUDA source, its C entry point and its launch count."""

    def __init__(self, name: str, source: str, entry: str,
                 argtypes: Sequence, replaces: str):
        self.name = name
        self.source = source          # file name under csrc/
        self.entry = entry
        self.argtypes = list(argtypes) + [P]   # + the stream
        self.replaces = replaces      # the TPU kernel it ports
        self.launches = 0
        self.captured = 0             # launches recorded by a capture
        #: launches by card-group member (:func:`count_as`)
        self.member_launches = {}
        self.build_log = ""
        self._fn = None

    @property
    def source_path(self) -> Path:
        return CSRC / self.source

    def library_path(self) -> Path:
        h = hashlib.sha1()
        for path in sorted(CSRC.glob("*.cuh")) + [self.source_path]:
            h.update(path.name.encode())
            h.update(path.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        stem = Path(self.source).stem
        return BUILD / f"lib{stem}-{h.hexdigest()[:12]}.so"

    def _start_build(self):
        """Start nvcc unless the library and its log exist -> (process,
        tmp path)."""
        lib = self.library_path()
        if lib.exists() and self.log_path().exists():
            return None
        BUILD.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(self.source_path)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True), tmp

    def _finish_build(self, started) -> None:
        if started is None:
            return
        proc, tmp = started
        self.build_log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed for {self.source}:\n{self.build_log}")
        self.log_path().write_text(self.build_log)
        os.replace(tmp, self.library_path())

    def log_path(self) -> Path:
        """nvcc's log (``-Xptxas=-v``), kept beside the library."""
        return self.library_path().with_suffix(".log")

    def resources(self) -> list:
        """[(entry function, registers, shared bytes, spilled bytes)]
        from the build log, of this process or kept beside the library;
        empty if neither exists."""
        log = self.build_log
        if not log and self.log_path().exists():
            log = self.log_path().read_text()
        return parse_ptxas(log)

    def _open(self):
        """The C entry point of the built library."""
        fn = getattr(ctypes.CDLL(str(self.library_path())), self.entry)
        fn.argtypes = self.argtypes
        fn.restype = ctypes.c_int
        return fn

    def load(self):
        """The C entry point, built and loaded at the first call (once,
        whichever thread calls first; the others wait for it)."""
        if self._fn is None:
            with _BUILD_LOCK:
                if self._fn is None:
                    self._finish_build(self._start_build())
                    self._fn = self._open()
        return self._fn

    def _count(self, n: int) -> None:
        with _COUNT_LOCK:
            self.launches += n
            member = getattr(_THREAD, "member", None)
            if member is not None:
                self.member_launches[member] = \
                    self.member_launches.get(member, 0) + n

    def launch(self, *args, device: torch.device) -> None:
        """Launch on ``device`` (the card of the tensors whose pointers
        ``args`` holds), on its current stream; raise on a CUDA error."""
        fn = self.load()
        with torch.cuda.device(device):
            err = fn(*args, torch.cuda.current_stream(device).cuda_stream)
            capturing = torch.cuda.is_current_stream_capturing()
        if err != 0:
            raise RuntimeError(
                f"{self.name}: CUDA error {err} at launch")
        if capturing:
            with _COUNT_LOCK:
                self.captured += 1
        else:
            self._count(1)


def build_all() -> float:
    """Compile every kernel not yet built, one ``nvcc`` per source, all
    started together; load them.  Returns the seconds it took."""
    t0 = time.perf_counter()
    with _BUILD_LOCK:
        started = [k._start_build() for k in ALL]
        try:
            for k, st in zip(ALL, started):
                k._finish_build(st)
        finally:
            for st in started:
                if st is not None and st[0].poll() is None:
                    st[0].kill()
                    st[0].wait()
        for k in ALL:
            k.load()
    return time.perf_counter() - t0


class Graph:
    """``fn`` (which takes no arguments and works on tensors it holds on
    ``device``) captured once as a CUDA graph on that device, after one
    eager warm-up call on a side stream (so every kernel was built and
    loaded, and every lazy first use done, before the capture).
    :meth:`replay` launches the captured work and adds the kernel
    launches the capture recorded to their counts.  The graph reads and
    writes the tensors ``fn`` used, at their addresses: the caller keeps
    them alive and fills them in place."""

    def __init__(self, fn, device: torch.device):
        self.device = torch.device(device)
        with torch.cuda.device(self.device):
            main = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(main)
            with torch.cuda.stream(side):
                fn()
            main.wait_stream(side)
            for k in ALL:
                k.captured = 0
            self.graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self.graph):
                fn()
        self.per_replay = {k: k.captured for k in ALL if k.captured}

    def replay(self) -> None:
        with torch.cuda.device(self.device):
            self.graph.replay()
        for k, n in self.per_replay.items():
            k._count(n)


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in ALL:
            k.launches = 0
            k.member_launches = {}


def count_as(member) -> None:
    """Count this thread's launches also as those of ``member`` (a
    card-group member's rank; None: no member) in
    ``Kernel.member_launches``."""
    _THREAD.member = member


def takes_kernel(device, dtype, name: str = "kernel") -> bool:
    """Whether a wrapper named ``name`` launches its kernel for
    coordinates of ``dtype`` on ``device``, decided before any launch:
    on the CPU never (the plain version runs); on ``cuda`` for float32
    (the kernel runs, or its checks and launch raise), not for float64
    (the plain version runs on the card, as the JAX package runs
    float64 through XLA and never through Pallas); another dtype on
    ``cuda`` raises ``TypeError`` and another device ``ValueError``."""
    device = torch.device(device)
    if device.type == "cpu":
        return False
    if device.type != "cuda":
        raise ValueError(f"{name}: no kernel for {device}")
    if dtype == torch.float32:
        return True
    if dtype == torch.float64:
        return False
    raise TypeError(f"{name}: {dtype} on {device}: the CUDA kernels take "
                    "float32, their plain versions float64")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape,
          device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape``
    on ``device`` (what a kernel takes)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t)}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


FACE_GEOMETRY = Kernel(
    "K1 face_geometry", "face_geometry.cu", "smk_face_geometry",
    [P, P, P, I, I, P, P, P],
    "smoothmesh_tpu/ops/tiledstep.py:323")
CELL_CENTRES = Kernel(
    "K2 cell_centres_vols", "cell_centres.cu", "smk_cell_centres_vols",
    [P, P, P, I, I, P, P],
    "smoothmesh_tpu/ops/tiledstep.py:391")
PREDICTOR = Kernel(
    "K3 predictor", "predictor.cu", "smk_predictor",
    [P, P, P, P, P, P, P, I, I, I, F, F, I, P, P],
    "smoothmesh_tpu/ops/tiledstep.py:435")
FREEZE = Kernel(
    "K4 freeze_constraints", "freeze.cu", "smk_freeze_constraints",
    [P, P, P, P, P, P, I, I, I, F, I, F, I, P],
    "smoothmesh_tpu/ops/tiledstep.py:724")
FACE_ANGLES = Kernel(
    "K5 edge_face_angles", "face_angles.cu", "smk_face_angles",
    [P, P, P, P, P, P, P, I, I, I, P],
    "smoothmesh_tpu/ops/tiledstep.py:640")
POINT_FACE_ANGLES = Kernel(
    "K6 point_face_angles", "point_face_angles.cu", "smk_point_face_angles",
    [P, P, P, I, I, P],
    "smoothmesh_tpu/ops/tiledstep.py:710")

TABLE_GATHER = Kernel(
    "K7 table_gather", "gather.cu", "smk_table_gather",
    [P, P, P, I, I, I, P],
    "smoothmesh_tpu/ops/tiled.py:551")
RAYCAST = Kernel(
    "K8 segment_triangle_hits", "raycast.cu", "smk_raycast",
    [P, P, P, I, I, I, I, I, F, F, F, F, P, P],
    "smoothmesh_tpu/ops/raycast.py:102")
#: no TPU kernel: the JAX package computes the normals in XLA
POINT_NORMALS = Kernel(
    "K9 point_normals", "point_normals.cu", "smk_point_normals",
    [P, P, P, P, P, P, I, I, P, P],
    "smoothmesh_tpu/layers.py:216")

ALL = (FACE_GEOMETRY, CELL_CENTRES, PREDICTOR, FREEZE, FACE_ANGLES,
       POINT_FACE_ANGLES, TABLE_GATHER, RAYCAST, POINT_NORMALS)
