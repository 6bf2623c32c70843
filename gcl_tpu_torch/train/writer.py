"""Metric writer (port of gcl_tpu/train/writer.py): TensorBoard scalars
under the reference's tags (train/{loss,pos_loss,neg_loss}, val/*) through
tensorboardX where it imports, and always a JSONL mirror,
``scalars.jsonl`` in the run directory, readable without any package.
"""
from __future__ import annotations

import json
import os
import time


class SummaryWriter:
    def __init__(self, logdir):
        self.logdir = logdir
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "scalars.jsonl"), "a")
        try:
            from tensorboardX import SummaryWriter as TBX
            self._tbx = TBX(logdir=logdir)
        except Exception:
            self._tbx = None

    def add_scalar(self, tag, value, step):
        value = float(value)
        self._jsonl.write(json.dumps(
            {"tag": tag, "value": value, "step": int(step),
             "ts": time.time()}) + "\n")
        self._jsonl.flush()
        if self._tbx is not None:
            self._tbx.add_scalar(tag, value, step)

    def close(self):
        self._jsonl.close()
        if self._tbx is not None:
            self._tbx.close()
