#!/bin/sh
# The default and the boundary cells of a parent checkout (P) and of
# this one (C), C both one iteration a dispatch (SMOOTHMESH_ITER_BATCH=1)
# and in batches of 16 (the default), in the order
# P, C1, C16, C16, C1, P for each cell, on one card; then a trace of
# each cell batched and one by one (experiments/torch_profile_step.py).
# Every run prints the card's name and power limit.
#
#   sh experiments/torch_batch_pccp.sh PARENT_DIR
#
# Run from the repository root on a machine with a CUDA card; the
# traces are summarized as they are written and then deleted (a
# one-by-one boundary trace of 32 iterations is tens of MB).
set -e
parent=$1
out=chiprun_out
mkdir -p $out archive_check
topo=archive_check/pccp_topo.pkl    # git-ignored; not brought back
cell() {
    python3 experiments/torch_default_cell.py --topo $topo "$@"
}
for flag in "" --boundary; do
    cell --root "$parent" $flag
    SMOOTHMESH_ITER_BATCH=1 cell $flag
    cell $flag
    cell $flag
    SMOOTHMESH_ITER_BATCH=1 cell $flag
    cell --root "$parent" $flag
done
for flag in "" --boundary; do
    python3 experiments/torch_profile_step.py --iters 32 $flag
    SMOOTHMESH_ITER_BATCH=1 python3 experiments/torch_profile_step.py \
        --iters 32 $flag
done
rm -f $topo $out/torch_profile_step_*.json
