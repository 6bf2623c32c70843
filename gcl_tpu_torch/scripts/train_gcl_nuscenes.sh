#! /bin/bash
# GCL training on nuScenes-as-KITTI with gcl_tpu_torch: scripts/
# train_gcl_nuscenes.sh, through this directory's train_gcl_kitti.sh.
export PATH_POSTFIX=$1
export MISC_ARGS=$2
export NUSCENES_PATH=${NUSCENES_PATH:-/data/nuscenes_kitti}
TRAIN_DATASET=ColocationNuscenesDataset DATASET=PairComplementNuscenesDataset \
KITTI_PATH=${NUSCENES_PATH} bash "$(dirname "$0")/train_gcl_kitti.sh" "$PATH_POSTFIX" \
  "--use_old_pose true $MISC_ARGS"
