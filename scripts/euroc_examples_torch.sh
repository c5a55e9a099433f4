#!/usr/bin/env bash
# EuRoC benchmark-matrix runner of the PyTorch port: euroc_examples.sh's
# matrix (MH01-05, V101-203 x {mono, stereo, mono-IMU, stereo-IMU}) and its
# multi-session Atlas run MH01->MH05 through `python -m tpuslam_torch.run`,
# on the card unless DEVICE says otherwise (DEVICE=cpu). VOCAB names a
# vocabulary (ORBvoc .txt / .bin or .npz) for loop closing and the Atlas
# merge, as the reference's runs load ORBvoc; without it the sessions of the
# multi-session run stay separate maps.
#
# Usage: EUROC_ROOT=/data/euroc scripts/euroc_examples_torch.sh [settings.yaml]
set -u
ROOT="${EUROC_ROOT:?set EUROC_ROOT to the EuRoC dataset directory}"
SETTINGS="${1:-}"
[ -n "$SETTINGS" ] && SETTINGS_ARG="--settings $SETTINGS" || SETTINGS_ARG=""
VOCAB_ARG=""
[ -n "${VOCAB:-}" ] && VOCAB_ARG="--vocab $VOCAB"
OUT="${OUT_DIR:-results}"
mkdir -p "$OUT"

SEQS="${SEQS:-MH01 MH02 MH03 MH04 MH05 V101 V102 V103 V201 V202 V203}"
SENSORS="${SENSORS:-mono stereo mono_imu stereo_imu}"

for seq in $SEQS; do
  [ -d "$ROOT/$seq" ] || { echo "skip $seq (not found)"; continue; }
  for sensor in $SENSORS; do
    echo "=== $seq $sensor ==="
    python -m tpuslam_torch.run --dataset euroc --path "$ROOT/$seq" \
      --sensor "$sensor" $SETTINGS_ARG $VOCAB_ARG --eval \
      --output "$OUT/f_${seq}_${sensor}.txt" \
      --kf-output "$OUT/kf_${seq}_${sensor}.txt" --timing \
      --device "${DEVICE:-cuda}"
  done
done

# Multi-session Atlas run (ref: euroc_eval_examples.sh MH01->MH05 in one
# process with ChangeDataset between sequences)
MULTI="$ROOT/MH01,$ROOT/MH02,$ROOT/MH03,$ROOT/MH04,$ROOT/MH05"
if [ -d "$ROOT/MH01" ] && [ -d "$ROOT/MH05" ]; then
  echo "=== multi-session MH01->MH05 (Atlas) ==="
  python -m tpuslam_torch.run --dataset euroc --path "$MULTI" \
    --sensor mono $SETTINGS_ARG $VOCAB_ARG --eval \
    --output "$OUT/f_MH01_05_multi.txt" --timing \
    --device "${DEVICE:-cuda}"
fi
