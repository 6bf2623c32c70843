"""Checkpoints with gcl_tpu's logical layout (port of
gcl_tpu/train/checkpoint.py): {epoch, state_dict, optimizer, scheduler,
config, best_val, best_val_epoch, best_val_metric}, one file per save,
saved with torch.save (extension `.pth`, as in the reference's run
directories).

``load_checkpoint`` also reads a checkpoint that gcl_tpu wrote (flax
msgpack, which the card's machine has no package for): a small decoder of
the msgpack subset flax writes (maps, arrays, strings, integers, floats,
booleans, nil, bin and flax's ndarray / numpy-scalar ext types). Either
way "state_dict" comes back as the port's model state_dict: flax's nested
{"params", "batch_stats"} trees pass through models.weights.
"""
from __future__ import annotations

import json
import os
import struct
import zipfile
from typing import Any, Dict

import numpy as np
import torch

from ..models.weights import flax_to_state_dict


def save_checkpoint(path: str, *, epoch: int,
                    state_dict: Dict[str, torch.Tensor], optimizer: Any,
                    config: Dict, best_val: float, best_val_epoch: int,
                    best_val_metric: str):
    """Write a checkpoint: the model's state_dict, the optimizer's
    state_dict (or None), the config's scalar entries."""
    state = {
        "epoch": epoch,
        "state_dict": {k: v.detach().cpu() for k, v in state_dict.items()},
        "optimizer": optimizer,
        "scheduler": {"last_epoch": epoch},
        "config": {k: v for k, v in dict(config).items()
                   if isinstance(v, (int, float, str, bool, type(None)))},
        "best_val": float(best_val),
        "best_val_epoch": (int(best_val_epoch)
                           if np.isfinite(best_val_epoch) else -(2 ** 31)),
        "best_val_metric": best_val_metric,
    }
    torch.save(state, path)


def dump_config_json(out_dir: str, config: Dict):
    """The run's config.json: the config's plain entries (numbers, strings,
    booleans, None, lists), as gcl_tpu writes it."""
    os.makedirs(out_dir, exist_ok=True)
    clean = {k: v for k, v in dict(config).items()
             if isinstance(v, (int, float, str, bool, type(None), list))}
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(clean, f, indent=4, sort_keys=False)


def load_checkpoint(path: str) -> Dict[str, Any]:
    """A checkpoint written by save_checkpoint or by gcl_tpu's; its
    "state_dict" as the port's model state_dict."""
    if zipfile.is_zipfile(path):
        return torch.load(path, map_location="cpu", weights_only=True)
    with open(path, "rb") as f:
        state = msgpack_restore(f.read())
    sd = state["state_dict"]
    state["state_dict"] = flax_to_state_dict(sd["params"],
                                             sd.get("batch_stats", {}))
    return state


# ----------------------------------------------------------------------
# flax's msgpack, decoded
# ----------------------------------------------------------------------

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """One msgpack object at a time from a bytes buffer."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def read(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self._map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.read() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return self.take(b & 0x1F).decode()
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in fixed:
            return fixed[b]
        sized = {0xC4: ("B", "bin"), 0xC5: ("H", "bin"), 0xC6: ("I", "bin"),
                 0xD9: ("B", "str"), 0xDA: ("H", "str"), 0xDB: ("I", "str"),
                 0xDC: ("H", "arr"), 0xDD: ("I", "arr"),
                 0xDE: ("H", "map"), 0xDF: ("I", "map"),
                 0xC7: ("B", "ext"), 0xC8: ("H", "ext"), 0xC9: ("I", "ext")}
        if b in sized:
            fmt, kind = sized[b]
            n = self.unpack(fmt)
            if kind == "bin":
                return self.take(n)
            if kind == "str":
                return self.take(n).decode()
            if kind == "arr":
                return [self.read() for _ in range(n)]
            if kind == "map":
                return self._map(n)
            return self._ext(self.unpack("b"), n)
        scalars = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
                   0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in scalars:
            return self.unpack(scalars[b])
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self._ext(self.unpack("b"), fixext[b])
        raise ValueError(f"msgpack: unsupported type byte 0x{b:02x}")

    def _map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def _ext(self, code: int, n: int):
        payload = self.take(n)
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            shape, dtype, buf = _Reader(payload).read()
            if dtype == "bfloat16":
                arr = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16)
                arr = arr.float().numpy().reshape(shape)
            else:
                arr = np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape)
            return arr[()] if code == _EXT_NPSCALAR else arr
        if code == _EXT_COMPLEX:
            re, im = _Reader(payload).read()
            return complex(re, im)
        raise ValueError(f"msgpack: unsupported ext type {code}")


def _unchunk(tree):
    """Rejoin arrays that flax split into chunks (leaves over 2^30 bytes)."""
    if not isinstance(tree, dict):
        return tree
    if _CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes):
    """The tree of flax.serialization.msgpack_serialize's bytes: dicts,
    lists, Python scalars and numpy arrays."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(data):
        raise ValueError("msgpack: trailing bytes after the object")
    return _unchunk(tree)
