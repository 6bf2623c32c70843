"""Model weights drawn on the device from the run's seed, in the recipe of
the port's models/weights.py:random_state_dict (conv kernels uniform in
+-1/sqrt(fan_in), BN scale 1 + 0.2 N(0, 1), running variance uniform in
[0.5, 1.5], bias and running mean 0.1 N(0, 1)), one draw per recipe for
the whole model. The same seed gives the same weights to the program and
to the reference."""
from __future__ import annotations

import math
from typing import Dict

import torch

from .traffic import generator


def random_state(shapes: Dict[str, tuple], seed: int,
                 device) -> Dict[str, torch.Tensor]:
    """{state_dict name: tensor} for the names and shapes of a model's
    state_dict (its floating leaves)."""
    gen = generator(seed, 0, device)
    kinds = {"kernel": [], "scale": [], "var": [], "other": []}
    for name, shape in shapes.items():
        leaf = name.rsplit(".", 1)[-1]
        kinds[leaf if leaf in kinds else "other"].append((name, shape))
    out = {}
    for kind, leaves in kinds.items():
        sizes = [math.prod(s) for _, s in leaves]
        total = sum(sizes)
        if kind in ("kernel", "var"):
            draw = torch.rand(total, generator=gen, device=device)
        else:
            draw = torch.randn(total, generator=gen, device=device)
        for (name, shape), part in zip(leaves, torch.split(draw, sizes)):
            part = part.reshape(shape)
            if kind == "kernel":
                bound = 1.0 / math.sqrt(math.prod(shape[:-1]))
                part = (2 * part - 1) * bound
            elif kind == "scale":
                part = 1.0 + 0.2 * part
            elif kind == "var":
                part = 0.5 + part
            else:
                part = 0.1 * part
            out[name] = part.contiguous()
    return out


def shapes_of(model: torch.nn.Module) -> Dict[str, tuple]:
    """The floating leaves of a model's state_dict and their shapes."""
    return {k: tuple(v.shape) for k, v in model.state_dict().items()
            if v.is_floating_point()}
