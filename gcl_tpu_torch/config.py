"""Flag system (port of gcl_tpu/config.py): the reference's flag names,
so the shell wrappers pass the same flags, plus the static capacities of
the device pipeline. gcl_tpu's Pallas conv tuning knobs (--conv_tile,
--conv_win, --conv_win_down, --conv_pair, --conv_fold, --conv_stack) have
no counterpart here.

get_config() returns a Config: a dict with attribute access (the
reference wraps its flags in an easydict; some loaders probe
``config.items()``).
"""
from __future__ import annotations

import argparse

arg_lists = []
parser = argparse.ArgumentParser()


def add_argument_group(name):
    arg = parser.add_argument_group(name)
    arg_lists.append(arg)
    return arg


def str2bool(v):
    return str(v).lower() in ("true", "1")


logging_arg = add_argument_group("Logging")
logging_arg.add_argument("--out_dir", type=str, default="outputs")

trainer_arg = add_argument_group("Trainer")
trainer_arg.add_argument("--trainer", type=str,
                         default="HardestContrastiveLossTrainer")
trainer_arg.add_argument("--save_freq_epoch", type=int, default=1)
trainer_arg.add_argument("--batch_size", type=int, default=4)
trainer_arg.add_argument("--val_batch_size", type=int, default=1)

trainer_arg.add_argument("--use_hard_negative", type=str2bool, default=True)
trainer_arg.add_argument("--hard_negative_sample_ratio", type=float,
                         default=0.05)
trainer_arg.add_argument("--hard_negative_max_num", type=int, default=3000)
trainer_arg.add_argument("--num_pos_per_batch", type=int, default=1024)
trainer_arg.add_argument("--num_hn_samples_per_batch", type=int,
                         default=256)

trainer_arg.add_argument("--neg_thresh", type=float, default=1.4)
trainer_arg.add_argument("--pos_thresh", type=float, default=0.1)
trainer_arg.add_argument("--finest_thresh", type=float, default=0.2)
trainer_arg.add_argument("--pos_weight", type=float, default=1)
trainer_arg.add_argument("--neg_weight", type=float, default=1)
trainer_arg.add_argument("--finest_weight", type=float, default=1)
trainer_arg.add_argument("--block_finest_gradient", type=str2bool,
                         default=True)
trainer_arg.add_argument("--use_group_circle_loss", type=str2bool,
                         default=False)
trainer_arg.add_argument("--safe_radius", type=float, default=0.75)
trainer_arg.add_argument("--square_loss", type=str2bool, default=True)

trainer_arg.add_argument("--use_random_scale", type=str2bool, default=False)
trainer_arg.add_argument("--min_scale", type=float, default=0.8)
trainer_arg.add_argument("--max_scale", type=float, default=1.2)
trainer_arg.add_argument("--use_random_rotation", type=str2bool,
                         default=True)
trainer_arg.add_argument("--rotation_range", type=float, default=360)
trainer_arg.add_argument("--max_in_p", type=int, default=20000)

trainer_arg.add_argument("--train_phase", type=str, default="train")
trainer_arg.add_argument("--val_phase", type=str, default="val")
trainer_arg.add_argument("--test_phase", type=str, default="test")

trainer_arg.add_argument("--stat_freq", type=int, default=40)
trainer_arg.add_argument("--test_valid", type=str2bool, default=True)
trainer_arg.add_argument("--val_max_iter", type=int, default=400)
trainer_arg.add_argument("--val_epoch_freq", type=int, default=1)
trainer_arg.add_argument(
    "--positive_pair_search_voxel_size_multiplier", type=float, default=1.5)

trainer_arg.add_argument("--hit_ratio_thresh", type=float, default=0.1)
trainer_arg.add_argument("--min_sample_frame_dist", type=float, default=10.0)
trainer_arg.add_argument("--complement_pair_dist", type=float, default=10.0)
trainer_arg.add_argument("--num_complement_one_side", type=int, default=5)

trainer_arg.add_argument("--triplet_num_pos", type=int, default=256)
trainer_arg.add_argument("--triplet_num_hn", type=int, default=512)
trainer_arg.add_argument("--triplet_num_rand", type=int, default=1024)

net_arg = add_argument_group("Network")
net_arg.add_argument("--model", type=str, default="ResUNetFatBN")
net_arg.add_argument("--encoder_model", type=str, default="ResUNetFatBN")
net_arg.add_argument("--model_n_out", type=int, default=32,
                     help="Feature dimension")
net_arg.add_argument("--conv1_kernel_size", type=int, default=5)
net_arg.add_argument("--normalize_feature", type=str2bool, default=True)
net_arg.add_argument("--dist_type", type=str, default="L2")
net_arg.add_argument("--best_val_metric", type=str,
                     default="feat_match_ratio")

opt_arg = add_argument_group("Optimizer")
opt_arg.add_argument("--optimizer", type=str, default="SGD")
opt_arg.add_argument("--max_epoch", type=int, default=100)
opt_arg.add_argument("--lr", type=float, default=1e-1)
opt_arg.add_argument("--loss_ratio", type=float, default=1e-5)
opt_arg.add_argument("--momentum", type=float, default=0.8)
opt_arg.add_argument("--sgd_momentum", type=float, default=0.9)
opt_arg.add_argument("--sgd_dampening", type=float, default=0.1)
opt_arg.add_argument("--adam_beta1", type=float, default=0.9)
opt_arg.add_argument("--adam_beta2", type=float, default=0.999)
opt_arg.add_argument("--weight_decay", type=float, default=1e-4)
opt_arg.add_argument("--iter_size", type=int, default=1,
                     help="accumulate gradient")
opt_arg.add_argument("--bn_momentum", type=float, default=0.05)
opt_arg.add_argument("--exp_gamma", type=float, default=0.99)
opt_arg.add_argument("--scheduler", type=str, default="ExpLR")
opt_arg.add_argument("--icp_cache_path", type=str, default="icp")

misc_arg = add_argument_group("Misc")
misc_arg.add_argument("--use_gpu", type=str2bool, default=True)
misc_arg.add_argument("--weights", type=str, default=None)
misc_arg.add_argument("--weights_dir", type=str, default=None)
misc_arg.add_argument("--resume", type=str, default=None)
misc_arg.add_argument("--resume_dir", type=str, default=None)
misc_arg.add_argument("--train_num_thread", type=int, default=4)
misc_arg.add_argument("--val_num_thread", type=int, default=1)
misc_arg.add_argument("--test_num_thread", type=int, default=2)
misc_arg.add_argument("--fast_validation", type=str2bool, default=False)
misc_arg.add_argument("--nn_max_n", type=int, default=2000)

data_arg = add_argument_group("Data")
data_arg.add_argument("--dataset", type=str,
                      default="PairComplementKittiDataset")
data_arg.add_argument("--train_dataset", type=str,
                      default="ColocationKittiDataset")
data_arg.add_argument("--voxel_size", type=float, default=0.025)
data_arg.add_argument("--random_dist", type=str2bool, default=True)
data_arg.add_argument("--threed_match_dir", type=str, default="")
data_arg.add_argument("--kitti_root", type=str, default="")
data_arg.add_argument("--kitti_max_time_diff", type=int, default=3)
data_arg.add_argument("--kitti_date", type=str, default="2011_09_26")
data_arg.add_argument("--pair_min_dist", type=int, default=-1)
data_arg.add_argument("--pair_max_dist", type=int, default=-1)
data_arg.add_argument("--mutate_neighbour_percentage", type=float,
                      default=0.)
data_arg.add_argument("--LoKITTI", type=str2bool, default=False)
data_arg.add_argument("--min_dist", type=int, default=5)
data_arg.add_argument("--max_dist", type=int, default=60)
data_arg.add_argument("--num_neighborhood", type=int, default=6)

debug_arg = add_argument_group("Debug")
debug_arg.add_argument("--use_old_pose", type=str2bool, default=True)
debug_arg.add_argument("--debug_need_complement", type=str2bool,
                       default=True)
debug_arg.add_argument("--debug_force_icp_recalculation", type=str2bool,
                       default=False)
debug_arg.add_argument("--debug_use_old_complement", type=str2bool,
                       default=False)
debug_arg.add_argument("--debug_downsample_ratio", type=float, default=1)
debug_arg.add_argument("--debug_floating_loss_ratio", type=str2bool,
                       default=False)
debug_arg.add_argument("--debug_inverse_floating_loss_ratio", type=str2bool,
                       default=False)
debug_arg.add_argument("--debug_matching_based_weighed_chamfer",
                       type=str2bool, default=False)
debug_arg.add_argument("--finetune_restart", type=str2bool, default=False)
debug_arg.add_argument("--use_next_frame", type=str2bool, default=False)
debug_arg.add_argument("--calc_distance_err", type=str2bool, default=False)
debug_arg.add_argument("--use_pair_group_positive_loss", type=str2bool,
                       default=False)
debug_arg.add_argument("--downsample_single", type=float, default=1.0)

# --- static capacities of the device pipeline ---------------------------
cap_arg = add_argument_group("Capacities")
cap_arg.add_argument("--point_capacity", type=int, default=131072,
                     help="padded points per cloud fed to the device")
cap_arg.add_argument("--voxel_capacity", type=int, default=24576,
                     help="padded voxels per cloud after quantization")
cap_arg.add_argument("--nghb_point_capacity", type=int, default=131072)
cap_arg.add_argument("--corr_k", type=int, default=8,
                     help="max GT correspondences per source voxel")
cap_arg.add_argument("--group_k", type=int, default=5,
                     help="K nearest per cloud in colocation groups")
cap_arg.add_argument("--pos_pair_capacity", type=int, default=1 << 21,
                     help="capacity of the intra-group pair list")
cap_arg.add_argument("--level_cap_shrink", type=float, default=0.6,
                     help="per-stride-level voxel capacity decay")
cap_arg.add_argument("--knn_chunk", type=int, default=1024)
cap_arg.add_argument(
    "--search_cell", type=float, default=-1.0,
    help="hash-grid cell for radius searches; -1 = auto (2x the largest "
         "matching radius incl. scale augmentation), 0 = brute force")
cap_arg.add_argument("--search_cell_cap", type=int, default=8,
                     help="max targets visible per hash-grid cell")
cap_arg.add_argument("--member_r_cap", type=int, default=32,
                     help="reverse-membership index width (neg filter)")
cap_arg.add_argument("--neg_filter", type=str, default="spatial",
                     choices=["spatial", "membership"],
                     help="negative-mining exclusion: 'spatial' (all "
                          "negatives within 2r of an anchor, a strict "
                          "superset, the default) or 'membership' "
                          "(the reference's exact K-truncated "
                          "co-membership hash semantics, for parity "
                          "validation runs)")
cap_arg.add_argument("--profile_dir", type=str, default="",
                     help="write a profiler device trace of the first "
                          "epoch here")
cap_arg.add_argument("--compute_dtype", type=str, default="float32",
                     choices=["float32", "bfloat16"])
cap_arg.add_argument("--num_devices", type=int, default=0,
                     help="data-parallel devices (0 = all local)")
cap_arg.add_argument("--data_parallel", type=str, default="auto",
                     choices=["auto", "true", "false"],
                     help="shard the batch over the devices with "
                          "averaged gradients; 'auto' enables it "
                          "when more than one device is visible and "
                          "batch_size divides evenly")
cap_arg.add_argument("--distributed_init", type=str2bool, default=False,
                     help="initialise a multi-host process group "
                          "(each host feeds its own batch shard)")
cap_arg.add_argument("--jitter_feats", type=str2bool, default=True,
                     help="train-phase feature jitter (lib/transforms.py)")
cap_arg.add_argument("--jitter_mode", type=str, default="input",
                     choices=["input", "c1z"],
                     help="'input' = reference-exact input-feature "
                          "jitter (conv1 reads features, presence "
                          "fast path off in training); 'c1z' = "
                          "distribution-matched noise injected after "
                          "the presence-bitmask conv1 (keeps the fast "
                          "path; see sparse_conv_c1z_jittered)")


class Config(dict):
    """Namespace/dict hybrid: attribute access + .items() (the reference
    uses easydict; some loaders probe `config.items()`)."""

    def __getattr__(self, k):
        try:
            return self[k]
        except KeyError as e:
            raise AttributeError(k) from e

    def __setattr__(self, k, v):
        self[k] = v


def get_config(argv=None) -> Config:
    args = parser.parse_args(argv)
    return Config(vars(args))


def default_config(**overrides) -> Config:
    cfg = get_config([])
    cfg.update(overrides)
    return cfg
