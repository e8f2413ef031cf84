#!/bin/bash
# Run every Bonn dynamic scene through the port on the card, then summarize
# the ATE (from the repository root; extra flags go to the entry point,
# e.g. --pretrained DIR or --device cpu).
set -e
SCENES=(bonn_balloon bonn_balloon2 bonn_crowd bonn_crowd2 bonn_crowd3
        bonn_moving_nonobstructing_box bonn_moving_nonobstructing_box2
        bonn_person_tracking bonn_person_tracking2)
for s in "${SCENES[@]}"; do
  echo "=== $s ==="
  python -m wildgs_slam_tpu_torch.run "configs/Dynamic/Bonn/${s}.yaml" \
    --device cuda "$@"
done
python -m wildgs_slam_tpu_torch.scripts.summarize_pose_eval ./output/Bonn
