"""Trainers (port of gcl_tpu/train/trainer.py): the reference's names and
lifecycle. The model comes from the registry with in_channels = 1
occupancy features and its parameters from the nn.Module's own init; SGD
with a per-epoch ExponentialLR (lr * exp_gamma^(epoch - 1)); config.json
dumped into the run directory; a checkpoint each epoch and the best
validation checkpoint on config.best_val_metric; ``weights`` loads either
package's checkpoint; ``resume`` restores the epoch, the best validation
value and the SGD momentum buffers from the port's own checkpoint
(``finetune_restart``: the weights only).

A trainer runs on one device, ``device`` ('cuda' by default; 'cpu' when
asked for). Built inside a process group (gcl_tpu_torch.parallel.launch:
the entry point starts one rank a card), it is one rank of a
data-parallel run, as gcl_tpu's trainer over its device mesh: its loader
feeds its slice of each global batch, capacities and the loss's sample
counts are per shard, the lifted grad_fn averages the gradients, the BN
running statistics and the metrics over the ranks, and the parameters
start as rank 0's. Every rank runs the validation (the parameters are
replicated and its draws fixed, so the ranks agree); rank 0 alone writes
config.json, the checkpoints and the scalars.
gcl_tpu's Pallas conv tuning knobs --conv_* (TPU only) have no
counterpart and raise.
"""
from __future__ import annotations

import logging
import os
import os.path as osp
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..core.kernel_maps import default_level_caps
from ..eval_kitti import device_of
from ..losses.gcl import GCLLossConfig
from ..models import load_model
from ..parallel import (broadcast_module, data_parallel_ranks,
                        make_global_grad_fn, shard_of)
from ..utils.timer import AverageMeter, Timer
from . import checkpoint as ckpt
from .steps import (AccumStepper, StepConfig, make_dist_err_step,
                    make_gcl_grad_fn, make_optimizer, make_pair_grad_fn,
                    make_train_step_from_grad, make_val_step)
from .writer import SummaryWriter

# gcl_tpu's Pallas conv tuning flags and their defaults (gcl_tpu/config.py)
_CONV_KNOBS = {"conv_tile": 256, "conv_win": 384, "conv_win_down": 768,
               "conv_pair": 1, "conv_fold": False, "conv_stack": 1}


def _refuse_unported(config) -> None:
    """Raise on the settings gcl_tpu honours and the port does not."""
    set_knobs = sorted(k for k, v in _CONV_KNOBS.items()
                       if getattr(config, k, None) not in (None, v))
    if set_knobs:
        raise NotImplementedError(
            f"{set_knobs}: gcl_tpu's Pallas conv tuning knobs have no "
            f"counterpart in gcl_tpu_torch (ROADMAP 'Not to port')")


def _search_cell(config) -> Optional[float]:
    """config.search_cell, with -1 = auto (twice the largest matching
    radius, random scale included) and 0 / None = brute force."""
    cell = getattr(config, "search_cell", -1.0)
    if cell is not None and cell < 0:
        mult = config.positive_pair_search_voxel_size_multiplier
        scale = max(1.0, getattr(config, "max_scale", 1.0) or 1.0)
        cell = 2.0 * config.voxel_size * mult * scale
    return cell or None


def step_config(config, n_flat: int) -> StepConfig:
    """The StepConfig of a run's ``config`` for steps over ``n_flat``
    stride-1 rows (clouds a step x voxel_capacity)."""
    strides = sorted({s for sp in load_model(config.model).conv_specs(
        config.conv1_kernel_size) for s in (sp.in_stride, sp.out_stride)})
    return StepConfig(
        voxel_size=config.voxel_size, nv_cap=config.voxel_capacity,
        level_caps=default_level_caps(n_flat, strides,
                                      config.level_cap_shrink),
        group_k=config.group_k, corr_k=config.corr_k,
        pos_pair_cap=config.pos_pair_capacity, knn_chunk=config.knn_chunk,
        search_cell=_search_cell(config),
        cell_cap=getattr(config, "search_cell_cap", 8),
        member_r_cap=getattr(config, "member_r_cap", 32),
        neg_filter=getattr(config, "neg_filter", "spatial"),
        momentum=config.momentum, weight_decay=config.weight_decay,
        jitter_mode=getattr(config, "jitter_mode", "input"),
        compute_dtype=(torch.bfloat16 if config.compute_dtype == "bfloat16"
                       else torch.float32))


class AlignmentTrainer:
    """The base trainer."""

    loss_kind = None  # subclasses set

    def __init__(self, config, data_loader, val_data_loader=None,
                 device="cuda"):
        model_cls = load_model(config.model)
        self.device = device_of(device)
        self.config = config
        self.max_epoch = config.max_epoch
        self.val_max_iter = config.val_max_iter
        self.val_epoch_freq = config.val_epoch_freq
        self.best_val_metric = config.best_val_metric
        self.best_val_epoch = -np.inf
        self.best_val = -np.inf
        self.start_epoch = 1
        self.checkpoint_dir = config.out_dir
        self.iter_size = config.iter_size
        self.batch_size = data_loader.batch_size
        self.data_loader = data_loader
        self.val_data_loader = val_data_loader
        self.test_valid = val_data_loader is not None
        _refuse_unported(config)
        # a trainer inside a process group is one rank of a data-parallel
        # run; static capacities below are PER SHARD
        self.data_parallel = dist.is_initialized()
        self.rank, self.n_shards, self.shard_batch = shard_of(
            self.batch_size)
        dp = str(getattr(config, "data_parallel", "false")).lower()
        if self.data_parallel and dp == "false":
            raise RuntimeError(
                "--data_parallel false inside a process group: a trainer "
                "there is one rank of a data-parallel run")
        if not self.data_parallel and data_parallel_ranks(
                config, self.device.type, self.batch_size):
            raise RuntimeError(
                "data_parallel: build the trainer inside the ranks of "
                "gcl_tpu_torch.parallel.launch (python -m "
                "gcl_tpu_torch.train starts them)")
        if self.data_parallel:
            logging.info(f"Data-parallel rank {self.rank} of "
                         f"{self.n_shards} ({self.shard_batch} samples a "
                         f"rank) on {self.device}")

        self.clouds_per_sample = self._clouds_per_sample()
        self.specs = model_cls.conv_specs(config.conv1_kernel_size)
        self.step_cfg = step_config(config, config.voxel_capacity
                                    * self.clouds_per_sample
                                    * self.shard_batch)
        # validation runs on pair batches of val_batch_size
        self.val_step_cfg = step_config(
            config, config.voxel_capacity * (val_data_loader.batch_size
                                             if val_data_loader else 1))

        self.model = model_cls(
            1, config.model_n_out, bn_momentum=config.bn_momentum,
            normalize_feature=config.normalize_feature,
            conv1_kernel_size=config.conv1_kernel_size, D=3).to(self.device)
        # the steps' random numbers (jitter, loss selections)
        self.generator = torch.Generator(device=self.device).manual_seed(0)
        self._build_steps()

        # rank 0 writes; N ranks writing one file would race
        self.writer = None
        if self.rank == 0:
            os.makedirs(self.checkpoint_dir, exist_ok=True)
            ckpt.dump_config_json(self.checkpoint_dir, config)
            self.writer = SummaryWriter(config.out_dir)

        if config.weights:
            self.model.load_state_dict(
                ckpt.load_checkpoint(config.weights)["state_dict"])
        if config.resume is not None:
            if not osp.isfile(config.resume):
                raise ValueError(
                    f"=> no checkpoint found at '{config.resume}'")
            logging.info(f"=> loading checkpoint '{config.resume}'")
            state = ckpt.load_checkpoint(config.resume)
            self.model.load_state_dict(state["state_dict"])
            if config.finetune_restart:
                logging.info("=> Finetuning, will only load model weights.")
            else:
                if not (isinstance(state["optimizer"], dict)
                        and "param_groups" in state["optimizer"]):
                    raise ValueError(
                        f"resume {config.resume}: not a gcl_tpu_torch "
                        f"checkpoint (its optimizer state is not torch's); "
                        f"load gcl_tpu's weights with --weights")
                self.start_epoch = int(state["epoch"])
                self.opt.load_state_dict(state["optimizer"])
                if "best_val" in state:
                    self.best_val = state["best_val"]
                    self.best_val_epoch = state["best_val_epoch"]
                    self.best_val_metric = state["best_val_metric"]
        if self.data_parallel:
            broadcast_module(self.model)

    # ------------------------------------------------------------------
    def _clouds_per_sample(self):
        return 1

    def _build_steps(self):
        raise NotImplementedError

    def _steps_from_grad(self, grad_fn: Callable, stage: str):
        """(optimizer, step_fn): the per-shard grad_fn lifted onto the ranks
        in a data-parallel run, then one SGD step a batch, or with
        iter_size > 1 the gradients of loss / iter_size summed over
        iter_size micro-batches and one step a window (AccumStepper)."""
        if self.data_parallel:
            grad_fn = make_global_grad_fn(grad_fn, self.model)
        opt = make_optimizer(self.model.parameters(), self.step_cfg)
        if self.iter_size > 1:
            return opt, AccumStepper(opt, grad_fn, self.iter_size, stage)
        return opt, make_train_step_from_grad(opt, grad_fn, stage)

    def _epoch_batches(self):
        """The micro-batches of one epoch: with iter_size accumulation only
        full windows run, and the accumulator is reset so that no partial
        window leaks into the next epoch."""
        limit = (len(self.data_loader) // self.iter_size) * self.iter_size
        for i, batch in enumerate(self.data_loader):
            if i >= limit:
                break
            yield i, batch
        if hasattr(self.step_fn, "reset"):
            self.step_fn.reset()

    def _feed(self, *arrays):
        """Host batch arrays -> tensors on the trainer's device."""
        return tuple(torch.from_numpy(np.asarray(a)).to(self.device)
                     for a in arrays)

    def lr_at(self, epoch):
        """ExponentialLR: lr * gamma^(epoch - 1), stepped once an epoch."""
        return self.config.lr * self.config.exp_gamma ** (epoch - 1)

    # ------------------------------------------------------------------
    def train(self):
        if self.test_valid:
            self._val_fns()  # build early so failures surface
        profile_dir = getattr(self.config, "profile_dir", "") or ""
        for epoch in range(self.start_epoch, self.max_epoch + 1):
            lr = self.lr_at(epoch)
            logging.info(f" Epoch: {epoch}, LR: {lr}")
            if profile_dir and epoch == self.start_epoch and self.rank == 0:
                self._profiled_epoch(epoch, profile_dir)
            else:
                self._train_epoch(epoch)
            self._save_checkpoint(epoch)

            if self.test_valid and epoch % self.val_epoch_freq == 0:
                # every rank validates its replica of the parameters with
                # the same draws, so no rank waits in a collective while
                # another validates; rank 0 alone writes
                val_dict = self._valid_epoch()
                if self.writer is not None:
                    for k, v in val_dict.items():
                        self.writer.add_scalar(f"val/{k}", v, epoch)
                if self.best_val < val_dict[self.best_val_metric]:
                    logging.info(
                        f"Saving the best val model with "
                        f"{self.best_val_metric}: "
                        f"{val_dict[self.best_val_metric]}")
                    self.best_val = val_dict[self.best_val_metric]
                    self.best_val_epoch = epoch
                    self._save_checkpoint(epoch, "best_val_checkpoint")
                elif self.best_val == val_dict[self.best_val_metric]:
                    # exact tie: keep the first best, also save the newest
                    logging.info(
                        f"Saving the latest best val model (not "
                        f"overriding the first) with "
                        f"{self.best_val_metric}: "
                        f"{val_dict[self.best_val_metric]}")
                    self._save_checkpoint(epoch,
                                          "best_val_newest_checkpoint")
                else:
                    logging.info(
                        f"Current best val model with "
                        f"{self.best_val_metric}: {self.best_val} at epoch "
                        f"{self.best_val_epoch}")

    def _profiled_epoch(self, epoch, profile_dir):
        """The epoch under torch.profiler (host ranges and, on a card, its
        kernels), written as a Chrome trace, trace.json, into
        profile_dir."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            self._train_epoch(epoch)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))

    def _save_checkpoint(self, epoch, filename="checkpoint"):
        if self.rank != 0:
            return
        path = os.path.join(self.checkpoint_dir, f"{filename}.pth")
        logging.info(f"Saving checkpoint: {path} ...")
        ckpt.save_checkpoint(
            path, epoch=epoch, state_dict=self.model.state_dict(),
            optimizer=self.opt.state_dict(), config=self.config,
            best_val=self.best_val, best_val_epoch=self.best_val_epoch,
            best_val_metric=self.best_val_metric)

    # ------------------------------------------------------------------
    def _val_fns(self):
        if not hasattr(self, "_val_step"):
            self._val_step = make_val_step(
                self.model, self.specs, self.val_step_cfg, subsample=5000,
                hit_ratio_thresh=self.config.hit_ratio_thresh)
        return self._val_step

    def _valid_epoch(self, draws: Optional[Callable] = None
                     ) -> Dict[str, float]:
        """Registration quality on the validation loader: feature-NN
        matches of 5000 voxels a side, the robust pose, its RTE / RRE,
        hit ratio, feature-match ratio and clamped corr_dist loss, averaged
        over at most val_max_iter pairs. ``draws``: optional callable(batch
        index) -> the val step's per-sample subsample uniforms; otherwise
        they come from a generator seeded with 0. Leaves the model in train
        mode."""
        val_step = self._val_fns()
        if hasattr(self.val_data_loader.dataset, "reset_seed"):
            self.val_data_loader.dataset.reset_seed(0)
        meters = {k: AverageMeter()
                  for k in ("loss", "rte", "rre", "hit_ratio",
                            "feat_match_ratio")}
        tot = len(self.val_data_loader.dataset)
        if self.val_max_iter > 0:
            tot = min(self.val_max_iter, tot)
        feat_timer = Timer()
        seen = 0
        gen = torch.Generator(device=self.device).manual_seed(0)
        for i, batch in enumerate(self.val_data_loader):
            if seen >= tot:
                break
            feat_timer.tic()
            out = val_step(*self._feed(batch["points0"], batch["pmask0"],
                                       batch["points1"], batch["pmask1"],
                                       batch["trans"]),
                           generator=gen,
                           draws=draws(i) if draws is not None else None)
            out = {k: v.cpu().numpy() for k, v in out.items()}
            feat_timer.toc()
            for j in range(len(out["rte"])):
                if np.isfinite(out["rre"][j]):
                    meters["rre"].update(float(out["rre"][j]))
                meters["rte"].update(float(out["rte"][j]))
                meters["loss"].update(float(out["loss"][j]))
                meters["hit_ratio"].update(float(out["hit_ratio"][j]))
                meters["feat_match_ratio"].update(
                    float(out["hit_ratio"][j] > 0.05))
                seen += 1
            if seen % 100 == 0 and seen > 0:
                logging.info(
                    f"Validation iter {seen} / {tot} : "
                    f"Feature+Match Time: {feat_timer.avg:.3f}, "
                    f"Loss: {meters['loss'].avg:.3f}, "
                    f"RTE: {meters['rte'].avg:.3f}, "
                    f"RRE: {meters['rre'].avg:.3f}, "
                    f"Hit Ratio: {meters['hit_ratio'].avg:.3f}, "
                    f"Feat Match Ratio: "
                    f"{meters['feat_match_ratio'].avg:.3f}")
        self.model.train()
        logging.info(
            f"Final Loss: {meters['loss'].avg:.3f}, "
            f"RTE: {meters['rte'].avg:.3f}, RRE: {meters['rre'].avg:.3f}, "
            f"Hit Ratio: {meters['hit_ratio'].avg:.3f}, "
            f"Feat Match Ratio: {meters['feat_match_ratio'].avg:.3f}")
        return {k: m.avg for k, m in meters.items()}

    def _run_epoch(self, epoch, fields, log_line):
        """One epoch of steps: each batch's ``fields`` onto the device, a
        step, and every stat_freq windows the writer's train/ tags and
        ``log_line(epoch, curr_iter, metrics)`` with the data and train
        times."""
        config = self.config
        lr = self.lr_at(epoch)
        data_meter, data_timer, total_timer = (AverageMeter(), Timer(),
                                               Timer())
        start_iter = (epoch - 1) * (len(self.data_loader)
                                    // self.iter_size)
        for curr_iter, batch in self._epoch_batches():
            data_timer.tic()
            args = self._feed(*(batch[f] for f in fields))
            data_time = data_timer.toc(average=False)
            total_timer.tic()
            metrics = self.step_fn(lr, *args, generator=self.generator)
            metrics = {k: float(v) for k, v in metrics.items()}
            total_timer.toc()
            data_meter.update(data_time)

            if (curr_iter % (config.stat_freq * self.iter_size) == 0
                    and self.rank == 0):
                step = start_iter + curr_iter // self.iter_size
                for tag in ("loss", "pos_loss", "neg_loss"):
                    self.writer.add_scalar(f"train/{tag}", metrics[tag],
                                           step)
                logging.info(
                    log_line(epoch, curr_iter, metrics)
                    + "\tData time: {:.4f}, Train time: {:.4f}".format(
                        data_meter.avg, total_timer.avg - data_meter.avg))
                data_meter.reset()
                total_timer.reset()


class ContrastiveLossTrainer(AlignmentTrainer):
    """The random-negative pair trainer; the pair trainers below share its
    epoch."""

    trainer_kind = "contrastive"

    def _build_steps(self):
        cfg = dict(self.config)
        # the loss's sample counts scale by the (shard's) batch
        cfg["batch_size"] = self.shard_batch
        grad_fn = make_pair_grad_fn(self.model, self.specs, self.step_cfg,
                                    self.trainer_kind, cfg)
        self.opt, self.step_fn = self._steps_from_grad(grad_fn, "fcgf")

    def _train_epoch(self, epoch):
        self._run_epoch(
            epoch, ("points0", "pmask0", "points1", "pmask1", "trans",
                    "search_radius"),
            lambda ep, it, m: (
                "Train Epoch: {} [{}/{}], Current Loss: {:.3e} "
                "Pos: {:.3f} Neg: {:.3f}".format(
                    ep, it, len(self.data_loader), m["loss"],
                    m["pos_loss"], m["neg_loss"])))


class HardestContrastiveLossTrainer(ContrastiveLossTrainer):
    """The FCGF default."""

    trainer_kind = "hardest_contrastive"


class TripletLossTrainer(ContrastiveLossTrainer):
    trainer_kind = "triplet"


class HardestTripletLossTrainer(ContrastiveLossTrainer):
    trainer_kind = "hardest_triplet"


class FinestContrastiveLossTrainer(AlignmentTrainer):
    """The GCL paper's trainer. The loss is chosen at init:
    use_group_circle_loss -> circle; finest_weight != 0 -> finest; else
    location."""

    def _clouds_per_sample(self):
        return self.config.num_neighborhood + 1

    def __init__(self, config, data_loader, val_data_loader=None,
                 device="cuda"):
        if config.use_group_circle_loss:
            self.loss_kind = "circle"
        elif config.finest_weight != 0:
            self.loss_kind = "finest"
        else:
            self.loss_kind = "location"
        self.config = config  # _clouds_per_sample reads it before super
        super().__init__(config, data_loader, val_data_loader, device)

    def _build_steps(self):
        cfg = self.config
        loss_cfg = GCLLossConfig(
            pos_thresh=cfg.pos_thresh, finest_thresh=cfg.finest_thresh,
            neg_thresh=cfg.neg_thresh, square_loss=cfg.square_loss,
            block_finest_gradient=cfg.block_finest_gradient,
            use_hard_negative=cfg.use_hard_negative,
            use_pair_group_positive_loss=cfg.use_pair_group_positive_loss,
            safe_radius=cfg.safe_radius)
        grad_fn = make_gcl_grad_fn(
            self.model, self.specs, self.step_cfg, loss_cfg, self.loss_kind,
            max_pos_cluster=cfg.num_pos_per_batch * self.shard_batch,
            max_hn_samples=cfg.num_hn_samples_per_batch * self.shard_batch,
            pos_weight=cfg.pos_weight, finest_weight=cfg.finest_weight,
            neg_weight=cfg.neg_weight, jitter=cfg.jitter_feats)
        self.opt, self.step_fn = self._steps_from_grad(grad_fn, "gcl")

    def _dist_err_epoch(self):
        """--calc_distance_err: 20 eval-mode iterations collect per-member
        (distance to the finest member's range, feature error) pairs,
        write dist_err_normal.npz into the run directory, then stop the
        run with ValueError, as the reference does."""
        from .diagnostics import DistErrCollector

        diag = make_dist_err_step(self.model, self.specs, self.step_cfg)
        coll = DistErrCollector(self.checkpoint_dir, max_iters=20)
        for batch in self.data_loader:
            out = diag(*self._feed(batch["points"], batch["pmask"],
                                   batch["transforms"],
                                   batch["search_radius"]))
            done = coll.update(*out)
            logging.info(f"dist-err iter {coll.iters}/20")
            if done:
                break
        coll.save("normal")
        raise ValueError("calc_distance_err run complete (reference "
                         "semantics: dump then abort)")

    def _train_epoch(self, epoch):
        if getattr(self.config, "calc_distance_err", False):
            return self._dist_err_epoch()
        self._run_epoch(
            epoch, ("points", "pmask", "transforms", "search_radius"),
            lambda ep, it, m: (
                "Train Epoch: {} [{}/{}], Current Loss: {:.3e} "
                "Pos: {:.3f} Neg: {:.3f} Finest: {:.3f}".format(
                    ep, it, len(self.data_loader), m["loss"],
                    m["pos_loss"], m["neg_loss"], m["finest_loss"])))


TRAINERS = {
    "ContrastiveLossTrainer": ContrastiveLossTrainer,
    "HardestContrastiveLossTrainer": HardestContrastiveLossTrainer,
    "TripletLossTrainer": TripletLossTrainer,
    "HardestTripletLossTrainer": HardestTripletLossTrainer,
    "FinestContrastiveLossTrainer": FinestContrastiveLossTrainer,
}


def get_trainer(trainer_name):
    """The trainer class registered under ``trainer_name``."""
    if trainer_name not in TRAINERS:
        raise ValueError(f"Trainer {trainer_name} not found")
    return TRAINERS[trainer_name]
