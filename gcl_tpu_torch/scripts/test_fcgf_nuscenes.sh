#! /bin/bash
# Benchmark a trained FCGF model on nuScenes with gcl_tpu_torch (scripts/
# test_fcgf_nuscenes.sh), run by python -m gcl_tpu_torch.eval_kitti.
export SAVE_DIR=$1
export MISC_ARGS=$2
export NUSCENES_PATH=${NUSCENES_PATH:-/data/nuscenes_kitti_format}
export LoNUSCENES=${LoNUSCENES:-false}
export USE_RANSAC=${USE_RANSAC:-true}
export PYTHONUNBUFFERED="True"

python -m gcl_tpu_torch.eval_kitti \
	--save_dir ${SAVE_DIR} \
	--kitti_root ${NUSCENES_PATH} \
	--LoNUSCENES ${LoNUSCENES} \
	--use_RANSAC ${USE_RANSAC} \
	$MISC_ARGS
