"""Import MinkowskiEngine (.pth) checkpoints of the reference into the
port's state_dict (port of gcl_tpu/train/import_torch.py, whose flax tree
gcl_tpu then maps through models/weights.py:flax_to_state_dict; here the
two steps are one).

Reference checkpoints (lib/trainer.py:162-175) store an ME state_dict:
  convN.kernel            [K^3, Cin, Cout]  (per-offset matrices)
  convN_tr.kernel         [K^3, Cin, Cout]  (transpose convs)
  conv1_tr.kernel/final.kernel [Cin, Cout]  (1x1 convs)
  final.bias              [Cout]
  normN.bn.{weight,bias,running_mean,running_var,num_batches_tracked}
  blockN.{conv1,conv2}.kernel, blockN.{norm1,norm2}.{...}

ME enumerates a kernel's offsets with x varying fastest; the port (as
gcl_tpu) with z innermost (core/coords.py:kernel_offsets), so the K^3 axis
is permuted. Transposed convs are also index-negated: the port's decoder
gathers in[f + d] where ME scatters in[c] -> c + d. 1 x 1 convs and
ResUNet's conv1_tr (a 1 x 1 regular conv) pass through. BatchNorm is read
from ``normN.bn.*`` or ``normN.*`` into the port's scale / bias / mean /
var; instance-norm blocks carry no affine or running state.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

_BN = (("weight", "scale"), ("bias", "bias"), ("running_mean", "mean"),
       ("running_var", "var"))


def _me_offset_permutation(k: int, flip: bool) -> np.ndarray:
    """perm[i_port] = index in ME's enumeration of the port's i-th
    offset."""
    perm = np.zeros(k ** 3, np.int64)
    for ix in range(k):
        for iy in range(k):
            for iz in range(k):
                jx, jy, jz = ((k - 1 - ix, k - 1 - iy, k - 1 - iz) if flip
                              else (ix, iy, iz))
                perm[iz + k * iy + k * k * ix] = jx + k * jy + k * k * jz
    return perm


def _is_transposed(name: str) -> bool:
    return (name.endswith("_tr") and name != "conv1_tr"
            or name == "conv1_tr_extra")


def _conv(kernel: np.ndarray, transpose: bool) -> np.ndarray:
    if kernel.ndim == 2:  # 1 x 1 conv
        return kernel
    k = round(kernel.shape[0] ** (1 / 3))
    assert k ** 3 == kernel.shape[0], kernel.shape
    return kernel[_me_offset_permutation(k, transpose)]


def _bn(prefix: str, sd: Dict) -> Dict[str, np.ndarray]:
    """ME BatchNorm state under ``prefix`` -> {scale, bias, mean, var}."""
    for probe in (f"{prefix}.bn.", f"{prefix}."):
        if probe + "weight" in sd:
            return {port: sd[probe + me] for me, port in _BN}
    raise KeyError(prefix)


def import_state_dict(sd: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
    """An ME state_dict (values as numpy arrays) -> the port's
    state_dict."""
    out: Dict[str, np.ndarray] = {}
    convs = sorted({k.split(".")[0] for k in sd if ".kernel" in k
                    and not k.startswith("block")})
    for name in convs:
        out[f"{name}.kernel"] = _conv(np.asarray(sd[f"{name}.kernel"]),
                                      _is_transposed(name))
        if f"{name}.bias" in sd:
            out[f"{name}.bias"] = np.asarray(sd[f"{name}.bias"])
    norms = sorted({k.split(".")[0] for k in sd
                    if k.startswith("norm") and "weight" in k})
    for name in norms:
        out.update({f"{name}.{leaf}": np.asarray(v)
                    for leaf, v in _bn(name, sd).items()})
    blocks = sorted({k.split(".")[0] for k in sd if k.startswith("block")})
    for name in blocks:
        for i in (1, 2):
            out[f"{name}.conv{i}.kernel"] = _conv(
                np.asarray(sd[f"{name}.conv{i}.kernel"]), False)
            try:
                out.update({f"{name}.norm{i}.{leaf}": np.asarray(v)
                            for leaf, v in _bn(f"{name}.norm{i}",
                                               sd).items()})
            except KeyError:
                pass  # instance-norm blocks have no affine / running state
    return {k: torch.from_numpy(np.array(v, copy=True))
            for k, v in out.items()}


def export_state_dict(state: Dict[str, torch.Tensor]
                      ) -> Dict[str, torch.Tensor]:
    """The inverse of import_state_dict: the port's state_dict in ME's
    layout (BN under ``normN.bn.*``, with num_batches_tracked), so that a
    model's weights can be written as a reference checkpoint."""
    out = {}
    for key, val in state.items():
        *path, leaf = key.split(".")
        val = val.detach().cpu()
        if leaf == "kernel" and val.dim() == 3:
            k = round(val.shape[0] ** (1 / 3))
            me = torch.empty_like(val)
            me[torch.from_numpy(_me_offset_permutation(
                k, len(path) == 1 and _is_transposed(path[0])))] = val
            out[key] = me
        elif path and path[-1].startswith("norm"):
            me_leaf = {port: me for me, port in _BN}[leaf]
            prefix = ".".join(path) + ".bn."
            out[prefix + me_leaf] = val
            out.setdefault(prefix + "num_batches_tracked",
                           torch.tensor(0, dtype=torch.int64))
        else:
            out[key] = val
    return out


def load_torch_checkpoint(path: str):
    """Read a reference .pth; returns (the port's state_dict, meta)."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    sd = {k: v.numpy() if hasattr(v, "numpy") else v
          for k, v in ckpt["state_dict"].items()
          if "num_batches_tracked" not in k}
    meta = {k: ckpt.get(k) for k in ("epoch", "best_val", "best_val_epoch",
                                     "best_val_metric")}
    return import_state_dict(sd), meta
