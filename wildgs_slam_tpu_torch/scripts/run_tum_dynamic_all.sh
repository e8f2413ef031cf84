#!/bin/bash
# Run every TUM-dynamic scene through the port on the card, then summarize
# the ATE (from the repository root; extra flags go to the entry point,
# e.g. --pretrained DIR or --device cpu).
set -e
SCENES=(freiburg2_desk_with_person freiburg3_sitting_halfsphere
        freiburg3_sitting_rpy freiburg3_sitting_xyz
        freiburg3_walking_halfsphere freiburg3_walking_rpy
        freiburg3_walking_xyz freiburg3_sitting_halfsphere_static
        freiburg3_walking_halfsphere_static)
for s in "${SCENES[@]}"; do
  echo "=== $s ==="
  python -m wildgs_slam_tpu_torch.run "configs/Dynamic/TUM_RGBD/${s}.yaml" \
    --device cuda "$@"
done
python -m wildgs_slam_tpu_torch.scripts.summarize_pose_eval ./output/TUM_RGBD
