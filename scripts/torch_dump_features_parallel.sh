#!/bin/sh
# Fan out training-data generation over multiple processes and concatenate,
# on the PyTorch/CUDA port (scripts/dump_features_parallel.sh with
# rnnoise_tpu_torch.tools.dump_features; xargs -P instead of GNU parallel,
# --seed per shard for reproducibility).  DEVICE (default cuda) is passed
# through as --device.
#
# usage: torch_dump_features_parallel.sh <speech> <noise> <fgnoise> <output> <count_per_shard> [rir_list] [n_jobs]

speech=$1
noise=$2
fgnoise=$3
output=$4
count=$5
rir=$6
jobs=${7:-8}
split=${SPLIT:-16}
device=${DEVICE:-cuda}

rirarg=""
if [ -n "$rir" ]; then rirarg="-rir_list $rir"; fi

seq $split | xargs -P "$jobs" -I{} \
  python -m rnnoise_tpu_torch.tools.dump_features $rirarg \
      --device "$device" --seed {} "$speech" "$noise" "$fgnoise" "$output.{}" "$count"

: > "$output"
for i in $(seq $split); do
    cat "$output.$i" >> "$output"
    rm "$output.$i"
done
