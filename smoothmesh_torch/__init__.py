"""smoothmesh_torch — the smoother on PyTorch and CUDA (NVIDIA Hopper).

A port of the JAX package ``smoothmesh_tpu`` (which stays the
reference): iterative centroidal smoothing of 3D polyhedral mesh
points with aspect-ratio midpoint blending and quality-control freezes,
without changing mesh topology.  The per-iteration stages run as
hand-written CUDA kernels (``csrc/``) on a CUDA device, and as their
plain PyTorch versions on the CPU.

Layout (each module mirrors its ``smoothmesh_tpu`` counterpart):
  - ``io``        host-side OpenFOAM polyMesh reader/writer
  - ``mesh``      hex/prism block generators, the topology compiler
                  (padded int32 index tables + masks) and the RCB
                  spatial reordering
  - ``params``    smoothing options and their derived defaults
  - ``quality``   the mesh stats behind the derived defaults
  - ``device``    topology staging as torch tensors
  - ``geometry``  face/cell geometry (K1, K2), boundary point normals
  - ``ops``       the predictor (K3), the freeze constraints (K4), the
                  face angle (K5, K6) and the ray cast (K8)
  - ``layers``    boundary-layer maps (host) and blending (device)
  - ``boundary``  boundary classification (host) and boundary point
                  projection (device)
  - ``kernels``   building, loading and launching the CUDA kernels
  - ``driver``    the iteration loop, convergence and writes
  - ``convert``   building the driver's state from the JAX package's
  - ``testcases`` the boundary testcases' meshes and target geometry
"""

__version__ = "0.1.0"

from smoothmesh_torch.params import SmoothingParams  # noqa: F401
