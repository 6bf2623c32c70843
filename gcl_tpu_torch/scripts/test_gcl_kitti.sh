#! /bin/bash
# Benchmark a trained GCL model on KITTI with gcl_tpu_torch (scripts/
# test_gcl_kitti.sh), run by python -m gcl_tpu_torch.eval_kitti.
export SAVE_DIR=$1
export MISC_ARGS=$2
export KITTI_PATH=${KITTI_PATH:-/data/kitti}
export LoKITTI=${LoKITTI:-false}
export USE_RANSAC=${USE_RANSAC:-false}
export PAIR_MIN_DIST=${PAIR_MIN_DIST:-5}
export PAIR_MAX_DIST=${PAIR_MAX_DIST:-20}
export PYTHONUNBUFFERED="True"

python -m gcl_tpu_torch.eval_kitti \
	--save_dir ${SAVE_DIR} \
	--kitti_root ${KITTI_PATH} \
	--LoKITTI ${LoKITTI} \
	--use_RANSAC ${USE_RANSAC} \
	--pair_min_dist ${PAIR_MIN_DIST} \
	--pair_max_dist ${PAIR_MAX_DIST} \
	$MISC_ARGS
