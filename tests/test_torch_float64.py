"""float64 on the card: what routes it, checked on the CPU (no card).

- The routing rule of every kernel wrapper (``kernels.takes_kernel``) as
  a pure function of (device, dtype): float32 on ``cuda`` launches the
  kernel, float64 there runs the plain version, another float dtype
  there raises TypeError, the CPU always runs the plain version, and
  another device raises ValueError.
- The device tables staged for each (device, dtype): the kernels'
  (``CUDA_TD_KEYS``, ``CUDA_QUALITY_TD_KEYS``) only where they launch,
  the plain versions' (``TD_KEYS``, ``QUALITY_TD_KEYS``) in float64 on
  ``cuda``.
- The decomposition ``Smoother(..., n_devices=N)`` picks: the halo on
  ``cuda`` in float32, the disjoint one in float64, ``use_tile_engine``
  either way.
- ``n_devices`` given by position delegates as by keyword (the JAX
  ``Smoother.__new__`` receives it either way).
- A float16 smoother on ``cuda`` raises TypeError before anything is
  staged.
"""

import numpy as np
import pytest
import torch

from smoothmesh_torch import kernels
from smoothmesh_torch.driver import (CUDA_TD_KEYS, NORMALS_TD_KEYS, TD_KEYS,
                                     Smoother, decomposition, td_keys)
from smoothmesh_torch.mesh.blockmesh import hex_block, perturb
from smoothmesh_torch.parallel.halo import HaloSmoother
from smoothmesh_torch.parallel.sharded import ShardedSmoother
from smoothmesh_torch.params import SmoothingParams
from smoothmesh_torch.quality import (CUDA_QUALITY_TD_KEYS, QUALITY_TD_KEYS,
                                      quality_td_keys)

torch.set_num_threads(1)

CUDA = torch.device("cuda")
CPU = torch.device("cpu")
F16, F32, F64, BF16 = (torch.float16, torch.float32, torch.float64,
                       torch.bfloat16)


def _hex6():
    """tests/test_parallel.py's mesh: the 6^3 graded block."""
    return perturb(hex_block(n=(6, 6, 6), grading=(2.0, 1.0, 0.5)), 0.03,
                   seed=5)


@pytest.mark.parametrize("device, dtype, kernel", [
    (CUDA, F32, True), (CUDA, F64, False), (CPU, F16, False),
    (CPU, F32, False), (CPU, F64, False), (CPU, BF16, False)])
def test_routing_rule(device, dtype, kernel):
    assert kernels.takes_kernel(device, dtype, "K1") is kernel


@pytest.mark.parametrize("dtype", [F16, BF16])
def test_routing_rule_refuses_other_floats_on_the_card(dtype):
    with pytest.raises(TypeError, match=f"K3: {dtype} on cuda"):
        kernels.takes_kernel(CUDA, dtype, "K3")


def test_routing_rule_refuses_other_devices():
    with pytest.raises(ValueError, match="K8: no kernel for meta"):
        kernels.takes_kernel(torch.device("meta"), F32, "K8")


@pytest.mark.parametrize("device, dtype, want, want_q", [
    (CUDA, F32, CUDA_TD_KEYS, CUDA_QUALITY_TD_KEYS),
    (CUDA, F64, TD_KEYS, QUALITY_TD_KEYS),
    (CPU, F32, TD_KEYS, QUALITY_TD_KEYS),
    (CPU, F64, TD_KEYS, QUALITY_TD_KEYS)])
def test_tables_by_dtype(device, dtype, want, want_q):
    assert td_keys(device, dtype=dtype) == want
    assert td_keys(device, True, dtype) == want | NORMALS_TD_KEYS
    assert quality_td_keys(device, dtype) == want_q
    # the words are read by the kernels only
    assert ("wedge_words" in want) is kernels.takes_kernel(device, dtype)


@pytest.mark.parametrize("device, dtype, use_tile_engine, want", [
    (CUDA, None, None, "halo"), (CUDA, F32, None, "halo"),
    (CUDA, F64, None, "disjoint"), (CPU, F32, None, "disjoint"),
    (CPU, F64, None, "disjoint"), (CUDA, F64, True, "halo"),
    (CPU, F64, True, "halo"), (CUDA, F32, False, "disjoint")])
def test_decomposition_choice(device, dtype, use_tile_engine, want):
    assert decomposition(device, dtype, use_tile_engine) == want


def test_positional_n_devices():
    mesh, params = _hex6(), SmoothingParams()
    by_pos = Smoother(mesh, params, F64, None, "cpu", True, 2)
    by_kw = Smoother(mesh, params, dtype=F64, device="cpu", n_devices=2)
    assert type(by_pos) is ShardedSmoother
    assert type(by_kw) is ShardedSmoother
    assert by_pos.shards.n_shards == by_kw.shards.n_shards == 2
    assert by_pos.dtype == by_kw.dtype == F64
    r_pos, r_kw = by_pos.steps(2), by_kw.steps(2)
    assert [(r.residual, r.n_frozen) for r in r_pos] == \
        [(r.residual, r.n_frozen) for r in r_kw]
    assert torch.equal(by_pos.points, by_kw.points)
    np.testing.assert_array_equal(by_pos.denormalize(), by_kw.denormalize())
    one = Smoother(mesh, params, F64, None, "cpu", True, 1)
    assert type(one) is Smoother
    halo = Smoother(mesh, params, F64, None, "cpu", True, 2, True)
    assert type(halo) is HaloSmoother and halo.shards.n_shards == 2


def test_float16_on_the_card_raises(monkeypatch):
    """The dtype is refused by the routing rule before any table is
    staged on the (absent) card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(TypeError, match="Smoother: torch.float16 on cuda"):
        Smoother(_hex6(), SmoothingParams(), dtype=F16, device="cuda")
