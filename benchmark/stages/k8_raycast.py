"""The ray cast of the boundary projection: each free smoothing-surface
point's ray along its normal against every target triangle (56
operations a pair), where the cell casts rays."""

from harness.work import F32

KERNEL = "raycast_kernel"


def work(s):
    if not s["rays"]:
        return None
    reads = F32 * 6 * s["rays"] + F32 * 9 * s["tris"]
    writes = 2 * F32 * s["rays"]
    return reads + writes, 56 * s["rays"] * s["tris"]
