#! /bin/bash
# FCGF baseline training on KITTI with gcl_tpu_torch (scripts/
# train_fcgf_kitti.sh): pair hardest-contrastive training, stride-3/k5
# backbone, run by python -m gcl_tpu_torch.train.
export PATH_POSTFIX=$1
export MISC_ARGS=$2

export KITTI_PATH=${KITTI_PATH:-/data/kitti}
export DATA_ROOT="./outputs/Experiments"
export DATASET=${DATASET:-PairComplementKittiDataset}
export TRAIN_DATASET=${TRAIN_DATASET:-PairComplementKittiDataset}
export TRAINER=${TRAINER:-HardestContrastiveLossTrainer}
export MODEL=${MODEL:-ResUNetFatBNEXP}
export MODEL_N_OUT=${MODEL_N_OUT:-32}
export LR=${LR:-1e-1}
export MAX_EPOCH=${MAX_EPOCH:-200}
export BATCH_SIZE=${BATCH_SIZE:-4}
export VOXEL_SIZE=${VOXEL_SIZE:-0.3}
export CONV1_KERNEL_SIZE=${CONV1_KERNEL_SIZE:-5}
export TIME=$(date +"%Y-%m-%d_%H-%M-%S")
export OUT_DIR=${DATA_ROOT}/${DATASET}-v${VOXEL_SIZE}/${TRAINER}/${MODEL}/SGD-lr${LR}-e${MAX_EPOCH}-b${BATCH_SIZE}-modelnout${MODEL_N_OUT}${PATH_POSTFIX}/${TIME}
export PYTHONUNBUFFERED="True"
echo $OUT_DIR
mkdir -m 755 -p $OUT_DIR
LOG=${OUT_DIR}/log_${TIME}.txt

python -m gcl_tpu_torch.train \
	--dataset ${DATASET} \
	--train_dataset ${TRAIN_DATASET} \
	--trainer ${TRAINER} \
	--model ${MODEL} \
	--model_n_out ${MODEL_N_OUT} \
	--conv1_kernel_size ${CONV1_KERNEL_SIZE} \
	--lr ${LR} \
	--batch_size ${BATCH_SIZE} \
	--max_epoch ${MAX_EPOCH} \
	--voxel_size ${VOXEL_SIZE} \
	--out_dir ${OUT_DIR} \
	--use_random_scale true \
	--use_random_rotation true \
	--weight_decay 1e-4 \
	--kitti_root ${KITTI_PATH} \
	--hit_ratio_thresh 0.3 \
	--complement_pair_dist 10 \
	--num_complement_one_side 3 \
	--use_old_pose true \
	--pair_min_dist 5 \
	--pair_max_dist 20 \
	$MISC_ARGS 2>&1 | tee -a $LOG
