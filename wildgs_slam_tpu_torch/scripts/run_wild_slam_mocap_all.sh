#!/bin/bash
# Run every Wild-SLAM mocap scene through the port on the card, then
# summarize the ATE (from the repository root; extra flags go to the entry
# point, e.g. --pretrained DIR or --device cpu).
set -e
SCENES=(ball crowd person_tracking racket stones table_tracking1
        table_tracking2 umbrella ANYmal1 ANYmal2)
for s in "${SCENES[@]}"; do
  echo "=== $s ==="
  python -m wildgs_slam_tpu_torch.run \
    "configs/Dynamic/Wild_SLAM_Mocap/${s}.yaml" --device cuda "$@"
done
python -m wildgs_slam_tpu_torch.scripts.summarize_pose_eval \
  ./output/Wild_SLAM_Mocap
