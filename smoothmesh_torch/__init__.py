"""smoothmesh_torch — the smoother on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``smoothmesh_tpu`` (which stays the
reference): iterative centroidal smoothing of 3D polyhedral mesh
points with aspect-ratio midpoint blending and quality-control freezes,
without changing mesh topology.  The per-iteration stages run as
hand-written CUDA kernels (``csrc/``) on a CUDA device, and as their
plain PyTorch versions on the CPU.

Layout (each module mirrors its ``smoothmesh_tpu`` counterpart):
  - ``io``        host-side OpenFOAM polyMesh reader/writer, the case
                  (time directories, checkpoints) and the OBJ readers
  - ``mesh``      block, multi-block and extruded-prism generators,
                  baffles, the topology compiler (padded int32 index
                  tables + masks) and the RCB spatial reordering
  - ``native``    the topology compiler's C++ builds
                  (``csrc/host/meshcompiler.cpp``, built at first use)
  - ``params``    smoothing options and their derived defaults
  - ``quality``   the checkMesh-style report and the mesh stats behind
                  the derived defaults
  - ``device``    topology staging as torch tensors
  - ``geometry``  face/cell geometry (K1, K2), boundary point normals
  - ``ops``       the predictor (K3), the freeze constraints (K4), the
                  face angle (K5, K6), the table gather (K7) and the ray
                  cast (K8)
  - ``layers``    boundary-layer maps (host) and blending (device)
  - ``boundary``  boundary classification (host) and boundary point
                  projection (device)
  - ``kernels``   building, loading and launching the CUDA kernels,
                  and capturing them into CUDA graphs
  - ``driver``    the iteration loop (batched: CUDA-graph replays with
                  one host read a batch), convergence and writes
  - ``parallel``  the halo and the disjoint domain decompositions: the
                  shards (host), all of them on one device as one union
                  topology, or one a rank over ``torch.distributed``
  - ``convert``   building the driver's state from the JAX package's
  - ``testcases`` the reference's eight testcases as generators
  - ``models``    the registry of the smoothing engines
  - ``utils``     debug writers (edges as STL)
  - ``cli``       the command-line interface
"""

__version__ = "0.1.0"

from smoothmesh_torch.params import SmoothingParams  # noqa: F401
