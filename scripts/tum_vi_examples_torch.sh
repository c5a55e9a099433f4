#!/usr/bin/env bash
# TUM-VI benchmark-matrix runner of the PyTorch port: tum_vi_examples.sh's
# matrix (rooms/corridors x {mono, stereo} +- IMU on the fisheye KB8 rig)
# through `python -m tpuslam_torch.run`, on the card unless DEVICE says
# otherwise (DEVICE=cpu).
#
# Usage: TUMVI_ROOT=/data/tumvi scripts/tum_vi_examples_torch.sh [TUM_512.yaml]
set -u
ROOT="${TUMVI_ROOT:?set TUMVI_ROOT to the TUM-VI dataset directory}"
SETTINGS="${1:-}"
[ -n "$SETTINGS" ] && SETTINGS_ARG="--settings $SETTINGS" || SETTINGS_ARG=""
OUT="${OUT_DIR:-results}"
mkdir -p "$OUT"

SEQS="${SEQS:-room1 room2 room3 room4 room5 room6 corridor1 corridor2}"
SENSORS="${SENSORS:-mono stereo mono_imu stereo_imu}"

for seq in $SEQS; do
  d="$ROOT/dataset-${seq}_512_16"
  [ -d "$d" ] || d="$ROOT/$seq"
  [ -d "$d" ] || { echo "skip $seq (not found)"; continue; }
  for sensor in $SENSORS; do
    echo "=== $seq $sensor ==="
    python -m tpuslam_torch.run --dataset tum_vi --path "$d" \
      --sensor "$sensor" $SETTINGS_ARG --eval \
      --output "$OUT/f_${seq}_${sensor}.txt" \
      --kf-output "$OUT/kf_${seq}_${sensor}.txt" --timing \
      --device "${DEVICE:-cuda}"
  done
done
