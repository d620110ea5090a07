"""The table gather (K7): ``x[table]`` over a padded table.

``table_gather(x, table, mask)`` gathers the rows of ``x`` (N, C) named
by a padded int32 ``table`` (n, W) into (n, W, C); slots whose ``mask``
is False are 0.  On float32 CUDA tensors it launches the hand-written
kernel ``csrc/gather.cu`` or raises; on CPU tensors (any float dtype)
and float64 CUDA tensors it runs its plain PyTorch version
(:func:`table_gather_plain`; ``kernels.takes_kernel``).  :func:`tiled_gather` is the counterpart of the JAX package's
standalone select-engine gather (``smoothmesh_tpu/ops/tiled.py:551``),
on the topology's padded table instead of the TPU's pools and codes.

The JAX function leaves masked slots arbitrary; both versions here
write 0 there, so the kernel and its plain version agree bit for bit
over the whole output.  Padded slots hold index 0 or -1
(``device.py``), and neither version reads through them.
"""

from __future__ import annotations

import torch

from smoothmesh_torch import kernels


def table_gather_plain(x, table, mask):
    """K7's plain version: (n, W, C), masked slots 0."""
    idx = torch.where(mask, table, 0).long()
    return torch.where(mask[..., None], x[idx], 0.0)


def table_gather(x, table, mask):
    """``x[table]`` with masked slots 0 (K7) -> (n, W, C)."""
    dev = x.device
    if not kernels.takes_kernel(dev, x.dtype, "table_gather"):
        return table_gather_plain(x, table, mask)
    n, width = table.shape
    kernels.check(x, "x", torch.float32, (x.shape[0], x.shape[-1]), dev)
    kernels.check(table, "table", torch.int32, (n, width), dev)
    kernels.check(mask, "mask", torch.bool, (n, width), dev)
    c = x.shape[1]
    out = torch.empty((n, width, c), dtype=torch.float32, device=dev)
    kernels.TABLE_GATHER.launch(x.data_ptr(), table.data_ptr(),
                                mask.data_ptr(), n, width, c,
                                out.data_ptr(), device=out.device)
    return out


def tiled_gather(x, table, mask, n_consumers: int):
    """The standalone gather of the JAX package's select engine
    (``tiled_gather``): ``x`` (N, C) as float32, gathered through the
    padded ``table`` / ``mask`` of a topology -> (n_consumers, W, C),
    masked slots 0."""
    return table_gather(x.to(torch.float32).contiguous(),
                        table[:n_consumers].contiguous(),
                        mask[:n_consumers].contiguous())
