"""Bridge between gcl_tpu's flax variables and the port's state_dict.

flax ``params`` and ``batch_stats`` arrive as nested dicts of numpy arrays
(``jax.tree_util.tree_map(np.asarray, ...)``). The port names its
parameters and buffers like the flax modules, and both keep conv weights
as [K, Cin, Cout] in kernel_offsets order, so the mapping is by path alone
(``conv1/kernel`` <-> ``conv1.kernel``, ``block1/norm1/mean`` <->
``block1.norm1.mean``) and an identity on values. The same paths name a
flax-shaped tree of gradients and an optax ``trace`` state (the momentum
tree), so tests compare ``p.grad`` and the optimizer's momentum buffers
with gcl_tpu's by name.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
from torch import nn

_STATS = ("mean", "var")  # batch_stats leaves; everything else is params


def flatten_tree(tree: dict, prefix: str = "") -> Dict[str, np.ndarray]:
    """A nested flax-shaped tree (params, batch_stats, gradients, an optax
    trace) -> {dotted path: array}, the port's names."""
    out = {}
    for name, val in tree.items():
        path = f"{prefix}{name}"
        if isinstance(val, dict):
            out.update(flatten_tree(val, path + "."))
        else:
            out[path] = np.asarray(val)
    return out


def flax_to_state_dict(params: dict,
                       batch_stats: dict) -> Dict[str, torch.Tensor]:
    """Nested flax params + batch_stats -> the port's state_dict."""
    flat = {**flatten_tree(params), **flatten_tree(batch_stats)}
    return {k: torch.from_numpy(np.array(v, copy=True)) for k, v in
            flat.items()}


def state_dict_to_flax(state: Dict[str, torch.Tensor]) -> Tuple[dict, dict]:
    """The port's state_dict -> (params, batch_stats) nested numpy dicts."""
    params: dict = {}
    stats: dict = {}
    for key, val in state.items():
        *path, leaf = key.split(".")
        node = stats if leaf in _STATS else params
        for p in path:
            node = node.setdefault(p, {})
        node[leaf] = val.detach().cpu().numpy()
    return params, stats


def gradients_by_name(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``p.grad`` of every parameter under its state_dict name, which is
    the flattened path of the same leaf in a flax gradient tree
    (``flatten_tree``)."""
    return {name: p.grad for name, p in model.named_parameters()}


def momentum_by_name(model: nn.Module,
                     optimizer: torch.optim.Optimizer
                     ) -> Dict[str, torch.Tensor]:
    """The optimizer's momentum buffer of every parameter under its
    state_dict name: the leaves of optax's ``trace`` state, flattened."""
    return {name: optimizer.state[p]["momentum_buffer"]
            for name, p in model.named_parameters()}


def random_state_dict(model: nn.Module,
                      seed: int) -> Dict[str, torch.Tensor]:
    """Seeded random weights in the model's (= the flax tree's) shapes:
    conv kernels uniform in +-1/sqrt(fan_in) (flax's default init),
    non-trivial BN scale / bias and running mean / var, so eval-mode BN is
    really exercised. Made with numpy, so the same seed gives the same
    weights on every device and in both packages."""
    rng = np.random.RandomState(seed)
    out = {}
    for key, val in model.state_dict().items():
        shape = tuple(val.shape)
        leaf = key.rsplit(".", 1)[-1]
        if leaf == "kernel":
            bound = 1.0 / np.sqrt(np.prod(shape[:-1]))
            v = rng.uniform(-bound, bound, shape)
        elif leaf == "scale":
            v = 1.0 + 0.2 * rng.randn(*shape)
        elif leaf == "var":
            v = rng.uniform(0.5, 1.5, shape)
        else:  # bias, mean
            v = 0.1 * rng.randn(*shape)
        out[key] = torch.from_numpy(v.astype(np.float32))
    return out
