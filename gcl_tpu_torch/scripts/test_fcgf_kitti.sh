#! /bin/bash
# Benchmark a trained FCGF model on KITTI with gcl_tpu_torch (scripts/
# test_fcgf_kitti.sh), run by python -m gcl_tpu_torch.eval_kitti.
export SAVE_DIR=$1
export MISC_ARGS=$2
export KITTI_PATH=${KITTI_PATH:-/data/kitti}
export LoKITTI=${LoKITTI:-false}
export USE_RANSAC=${USE_RANSAC:-true}
export PYTHONUNBUFFERED="True"

python -m gcl_tpu_torch.eval_kitti \
	--save_dir ${SAVE_DIR} \
	--kitti_root ${KITTI_PATH} \
	--LoKITTI ${LoKITTI} \
	--use_RANSAC ${USE_RANSAC} \
	$MISC_ARGS
