"""The port's table gather (K7's plain version, the wrapper on CPU
tensors, and ``tiled_gather``) against ``x[table]`` in numpy on the four
tables of ``tests/test_tiled_engine.py`` (20 x 18 x 16 hex), and against
the JAX package's select-engine ``tiled_gather`` (Pallas, interpret mode)
on one of them: bit-equal on the valid slots, and 0 on the masked ones
(the JAX function leaves those arbitrary).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from smoothmesh_tpu.ops import tiled
from smoothmesh_torch.device import to_device
from smoothmesh_torch.mesh.blockmesh import hex_block, perturb
from smoothmesh_torch.mesh.tiling import permute_mesh
from smoothmesh_torch.mesh.topology import compile_topology
from smoothmesh_torch.ops import gather

torch.set_num_threads(1)

#: table -> (mask, the count of the entities it indexes)
TABLES = {"point_cells": ("point_cells_mask", "n_cells"),
          "point_points": ("point_points_mask", "n_points"),
          "face_points": ("face_mask", "n_points"),
          "edge_cells": ("edge_cells_mask", "n_cells")}


@pytest.fixture(scope="module")
def topo():
    mesh = perturb(hex_block(n=(20, 18, 16)), amplitude=0.05, seed=4)
    return compile_topology(permute_mesh(mesh)[0])


def _inputs(topo, name, c=3, dtype=np.float32):
    mask_name, src = TABLES[name]
    rng = np.random.default_rng(0)
    x = rng.standard_normal((getattr(topo, src), c)).astype(dtype)
    return x, getattr(topo, name), getattr(topo, mask_name)


@pytest.mark.parametrize("name", sorted(TABLES))
def test_table_gather_plain_matches_numpy(topo, name):
    x, table, mask = _inputs(topo, name)
    want = x[np.asarray(table, np.int64)]
    args = (torch.from_numpy(x), torch.from_numpy(table.astype(np.int32)),
            torch.from_numpy(mask))
    got = gather.table_gather_plain(*args).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_array_equal(got[mask], want[mask])
    assert not got[~mask].any()
    # the wrapper runs the plain version on CPU tensors
    assert torch.equal(gather.table_gather(*args), torch.from_numpy(got))


def test_tiled_gather_matches_jax_interpret(topo):
    """One table through the JAX select engine in interpret mode."""
    x, table, mask = _inputs(topo, "point_cells")
    pool, (codes,) = tiled.build_pool(table.shape[0], [(table, mask)],
                                      topo.n_cells)
    want = np.asarray(tiled.tiled_gather(
        jnp.asarray(x), pool, codes, table.shape[0], interpret=True))
    td = to_device(topo, "cpu", keys=["point_cells", "point_cells_mask"])
    got = gather.tiled_gather(torch.from_numpy(x.astype(np.float64)),
                              td["point_cells"], td["point_cells_mask"],
                              topo.n_points).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_array_equal(got[mask], want[mask])
    assert not got[~mask].any()


@pytest.mark.parametrize("c", [1, 4, 5])
def test_masked_slots_are_zero_and_never_read(topo, c):
    """Padded slots holding -1 (the face angle's packed tables) are not
    read; any width C and float64 run on the CPU."""
    x, table, mask = _inputs(topo, "point_points", c, np.float64)
    assert (~mask).any()          # not vacuous: the table has padding
    signed = np.where(mask, table, -1).astype(np.int32)
    got = gather.table_gather(torch.from_numpy(x), torch.from_numpy(signed),
                              torch.from_numpy(mask)).numpy()
    assert got.dtype == np.float64 and got.shape == (*table.shape, c)
    np.testing.assert_array_equal(got[mask], x[table[mask]])
    assert not got[~mask].any()
    # a table over an empty prefix: only masked slots
    none = torch.zeros((3, 2), dtype=torch.bool)
    out = gather.table_gather(torch.from_numpy(x[:1]),
                              torch.full((3, 2), 7, dtype=torch.int32), none)
    assert out.shape == (3, 2, c) and not out.any()


def test_table_gather_refuses_other_devices():
    x = torch.zeros((4, 3), device="meta")
    t = torch.zeros((2, 2), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        gather.table_gather(x, t, t.bool())
