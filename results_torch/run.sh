#!/bin/bash
# Writes the port's results (the files under results_torch/) on a host with
# one card, from the root of a checkout:
#
#   bash results_torch/run.sh OUT
#
# OUT/sweeps/<grid>/     the ten grids of scripts/sweeps.py, the GPU halves,
#                        one directory a grid (grids that share a CSV name
#                        would skip each other's sizes in one directory)
# OUT/sweeps/hash_hit50/ config #4 at 50 % hits, 2^24 keys
# OUT/scaling/           the scaling harness on the card (2^18, 2^20 rows a
#                        rank) and on gloo CPU worlds 1-8 (2^18), the bench
#                        line, and the model built from both
# OUT/card.txt           nvidia-smi's name and power limit of the card
#
# Each step's stdout goes to OUT/run.log unless it is the result itself;
# each step's time, and its exit code if it failed, go to OUT/run.log only.
# Exits 1 if any step failed (a sweep size that failed is a FAILED line in
# its grid's .log).
set -u
out=${1:?usage: bash results_torch/run.sh OUT}
mkdir -p "$out/sweeps" "$out/scaling"
log="$out/run.log"
rc=0
step() {
    local t0=$SECONDS
    "$@" || { echo "FAILED (rc $?): $*" >> "$log"; rc=1; }
    echo "step took $((SECONDS - t0)) s: $*" >> "$log"
}
nvidia-smi --query-gpu=name,power.limit --format=csv,noheader \
    > "$out/card.txt"
for g in radix_large twopassscan dplscan_large radix_large_cuda \
         dplscan_large_cuda radix_small radix_small_cuda dplscan_small \
         dplscan_small_cuda hash_large; do
    step python -m dwarf_bench_tpu_torch.scripts.sweeps "$g" \
        --out "$out/sweeps/$g" >> "$log" 2>&1
done
step python -m dwarf_bench_tpu_torch.scripts.hash_hit50 24 \
    --out "$out/sweeps/hash_hit50" >> "$log" 2>&1
s="$out/scaling"
for lg in 18 20; do
    step python -m dwarf_bench_tpu_torch.scripts.scaling \
        --rows_per_chip $((1 << lg)) \
        --compute_json "$s/compute_gpu_2p$lg.json" \
        > "$s/scaling_gpu_2p$lg.jsonl" 2>> "$log"
done
step python -m dwarf_bench_tpu_torch.scripts.scaling --device cpu \
    --rows_per_chip $((1 << 18)) > "$s/scaling_cpu_gloo_2p18.jsonl" \
    2>> "$log"
step python -m dwarf_bench_tpu_torch.bench > "$s/bench.json" 2>> "$log"
step python -m dwarf_bench_tpu_torch.scripts.scaling_model \
    --rows-per-chip $((1 << 20)) --bench_json "$s/bench.json" \
    --compute_json "$s/compute_gpu_2p20.json" --out "$s" \
    > "$s/scaling_model.txt" 2>> "$log"
exit $rc
