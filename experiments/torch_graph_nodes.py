"""The nodes of the batch's captured CUDA graph, counted by type, in a
checkout of the port: so that two checkouts, or stage timing off and
on, can be held to the same kernels, copies, fills and event nodes.

    python3 experiments/torch_graph_nodes.py [--root DIR] [--side 32]

For each of the benchmark's two cells (its harness makes the mesh at
``--side`` cells a side, and the boundary cell's dome), it builds the
smoother of the checkout at ``--root`` (default: this repository) on
the card, captures the batch (``prepare_batch``, with the graph's
``cudaGraph_t`` kept) and counts its nodes through the driver API
(``cuGraphGetNodes``, ``cuGraphNodeGetType``); where the checkout has
``time_stages``, again with stage timing on.  One JSON line.  It
imports neither JAX nor the JAX package.
"""

import argparse
import ctypes
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
#: CUgraphNodeType
NODE_TYPES = ("kernel", "memcpy", "memset", "host", "graph", "empty",
              "wait_event", "event_record", "ext_semas_signal",
              "ext_semas_wait", "mem_alloc", "mem_free", "batch_mem_op",
              "conditional")


def node_types(graph) -> dict:
    """{type name: count} of a ``torch.cuda.CUDAGraph`` made with
    ``keep_graph=True``."""
    cuda = ctypes.CDLL("libcuda.so.1")
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cuda.cuGraphGetNodes(g, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cuda.cuGraphGetNodes(g, nodes, ctypes.byref(n)) == 0
    out = {}
    kind = ctypes.c_int()
    for node in nodes:
        assert cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                       ctypes.byref(kind)) == 0
        name = NODE_TYPES[kind.value]
        out[name] = out.get(name, 0) + 1
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--side", type=int, default=32)
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    sys.path.insert(1, os.path.join(ROOT, "benchmark"))
    import torch

    from harness import inputs
    from harness.cells import Cell
    from harness.program import Program
    from smoothmesh_torch.driver import Smoother

    made = torch.cuda.CUDAGraph
    torch.cuda.CUDAGraph = lambda: made(keep_graph=True)
    dev = torch.device("cuda")
    out = {"root": os.path.abspath(args.root)}
    for name in ("hex128.default", "hex128_top.boundary"):
        cell = Cell(name)
        config = dict(cell.config, cells_per_side=args.side)
        prog = Program(config, cell.mix, 1, dev)
        sm = Smoother(prog.polymesh(), prog.params(), device=dev)
        if cell.mix.get("boundary_smoothing"):
            sm.enable_boundary_smoothing(
                *inputs.dome(**config["target"]["dome"]))
        sm.prepare_batch()
        got = {"off": node_types(sm._batch.graph.graph)}
        if hasattr(sm, "time_stages"):
            sm.time_stages(True)
            sm.prepare_batch()
            got["stages_on"] = node_types(sm._batch.graph.graph)
        out[name] = got
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
