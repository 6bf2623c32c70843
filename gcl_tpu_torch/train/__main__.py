"""The training entry point (port of the root train.py): train and
validation loaders, the trainer chosen by name, the resume-config merge,
then .train().

    python -m gcl_tpu_torch.train --trainer HardestContrastiveLossTrainer \\
        --model ResUNetFatBNEXP --conv1_kernel_size 5 --kitti_root ROOT ...

takes the flags of gcl_tpu_torch/config.py (scripts/train_fcgf_kitti.sh's
and scripts/train_gcl_kitti.sh's among them) and ``--device {cuda,cpu}``:
the CUDA card by default, which raises without one.
"""
from __future__ import annotations

import argparse
import json
import logging
import os
import sys

import numpy as np
import torch

from ..config import Config, get_config
from ..data.loader import make_data_loader
from ..eval_kitti import device_of
from .trainer import get_trainer


def main(config, device: str = "cuda"):
    """Build the loaders and the trainer of ``config`` on ``device`` and
    train; returns the trainer."""
    device_of(device)  # no card for 'cuda': raise before loading data
    train_loader = make_data_loader(
        config, config.train_phase, config.batch_size,
        num_threads=config.train_num_thread)
    val_loader = None
    if config.test_valid:
        val_loader = make_data_loader(
            config, config.val_phase, config.val_batch_size,
            num_threads=config.val_num_thread)
    trainer = get_trainer(config.trainer)(
        config=config, data_loader=train_loader,
        val_data_loader=val_loader, device=device)
    trainer.train()
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


if __name__ == "__main__":
    logging.basicConfig(format="%(asctime)s %(message)s",
                        datefmt="%m/%d %H:%M:%S", level=logging.INFO,
                        handlers=[logging.StreamHandler(sys.stdout)])
    np.random.seed(0)
    torch.manual_seed(0)  # the model's initial weights, as gcl_tpu's key 0
    config, device = parse_config()
    logging.info("===> Configurations")
    for k in config:
        logging.info("    {}: {}".format(k, config[k]))
    main(config, device)
