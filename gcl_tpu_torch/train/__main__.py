"""The training entry point (port of the root train.py): train and
validation loaders, the trainer chosen by name, the resume-config merge,
then .train().

    python -m gcl_tpu_torch.train --trainer HardestContrastiveLossTrainer \\
        --model ResUNetFatBNEXP --conv1_kernel_size 5 --kitti_root ROOT ...

takes the flags of gcl_tpu_torch/config.py (scripts/train_fcgf_kitti.sh's
and scripts/train_gcl_kitti.sh's among them) and ``--device {cuda,cpu}``:
the CUDA card by default, which raises without one.

Data parallelism, one process a card (gcl_tpu_torch.parallel):
``--data_parallel true`` (or ``auto`` over more than one card with a
batch that divides) starts one rank a visible card, or ``--num_devices``
of them (on the CPU, ``--num_devices`` gloo ranks); a single rank runs in
this process. Under torchrun, ``--distributed_init true`` joins the group
torchrun describes instead (every machine runs the command):

    torchrun --nnodes 2 --nproc_per_node 8 --rdzv_endpoint HOST:PORT \
        -m gcl_tpu_torch.train --distributed_init true ...
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from ..config import Config, get_config
from ..data.loader import make_data_loader
from ..eval_kitti import device_of
from ..parallel import (backend_for, build_kernels_once,
                        data_parallel_ranks, init_from_env, rank_device,
                        run_ranks, world)
from .trainer import get_trainer


def main(config, device: str = "cuda"):
    """Train ``config`` on ``device``: in this process, or on the ranks of
    a data-parallel run (gcl_tpu_torch.parallel.launch). Returns the
    trainer of this process (rank 0's for a single data-parallel rank),
    or None where spawned ranks trained."""
    dev = device_of(device)  # no card for 'cuda': raise before loading data
    if config.distributed_init:
        rank_dev = init_from_env(dev.type)
        try:
            if dev.type == "cuda":
                build_kernels_once()
            return train_on(config, rank_dev)
        finally:
            dist.destroy_process_group()
    n_ranks = data_parallel_ranks(config, dev.type, config.batch_size)
    if not n_ranks:
        return train_on(config, dev)
    return run_ranks(_train_rank, n_ranks, (config, dev.type),
                     backend_for(dev.type), dev.type)


def _train_rank(rank: int, world_size: int, config, device_type: str):
    """One data-parallel rank: cuda:rank (or the CPU), its loader slice.
    A spawned rank logs to its standard output as the entry point does."""
    if world_size > 1:
        _log_to_stdout()
    np.random.seed(0)
    torch.manual_seed(0)
    dev = rank_device(device_type, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return train_on(config, dev)


def train_on(config, dev: torch.device):
    """Build the loaders and the trainer of ``config`` on ``dev`` and
    train; returns the trainer. Inside a process group the train loader
    feeds this rank's slice of each batch."""
    train_loader = make_data_loader(
        config, config.train_phase, config.batch_size,
        num_threads=config.train_num_thread, shard=world())
    val_loader = None
    if config.test_valid:
        val_loader = make_data_loader(
            config, config.val_phase, config.val_batch_size,
            num_threads=config.val_num_thread)
    trainer = get_trainer(config.trainer)(
        config=config, data_loader=train_loader,
        val_data_loader=val_loader, device=dev)
    trainer.train()
    if trainer.writer is not None:
        trainer.writer.close()
    return trainer


def parse_config(argv=None):
    """(config, device): the flags onto the defaults; with --resume_dir
    (and no finetune_restart) the run's own config.json over them, but for
    the resume paths, and its checkpoint.pth to resume from."""
    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args, rest = ap.parse_known_args(argv)
    config = get_config(rest)
    dconfig = dict(config)
    if config.resume_dir and not config.finetune_restart:
        with open(config.resume_dir + "/config.json") as f:
            resume_config = json.load(f)
        for k in dconfig:
            if k != "resume_dir" and k in resume_config:
                dconfig[k] = resume_config[k]
        dconfig["resume"] = os.path.join(config.resume_dir,
                                         "checkpoint.pth")
    return Config(dconfig), args.device


def _log_to_stdout():
    logging.basicConfig(format="%(asctime)s %(message)s",
                        datefmt="%m/%d %H:%M:%S", level=logging.INFO,
                        handlers=[logging.StreamHandler(sys.stdout)])


if __name__ == "__main__":
    _log_to_stdout()
    np.random.seed(0)
    torch.manual_seed(0)  # the model's initial weights, as gcl_tpu's key 0
    config, device = parse_config()
    logging.info("===> Configurations")
    for k in config:
        logging.info("    {}: {}".format(k, config[k]))
    main(config, device)
