"""The plain versions' arithmetic, and the control's lower precision."""
from __future__ import annotations

import contextlib
from typing import Optional, Tuple

import torch

FEATURE_DTYPES = (torch.float32, torch.bfloat16)

# The types that every conv's operands and outputs are rounded to (the
# forward's, the backward's), each tensor scaled to the type's largest
# finite value as fp8 products and fp8 activations are (the program
# rounds its bf16 features at the same places); None (the reference)
# leaves them as they are. Only the control sets them.
_ROUNDING: Optional[Tuple[torch.dtype, torch.dtype]] = None


def summing(t: torch.Tensor) -> torch.Tensor:
    """t in the type that the plain versions multiply and sum in: float32
    for float32 and bf16 (a product of two bf16 is exact in float32),
    float64 for float64."""
    return t.to(torch.promote_types(t.dtype, torch.float32))


def rounded(t: torch.Tensor, backward: bool = False) -> torch.Tensor:
    """A conv operand or output as the control's precision gives it: ``t``
    scaled by its largest magnitude onto the type's range, rounded to it
    and back (the identity outside ``product_precision``). ``backward``
    takes the backward's type. Autograd passes a gradient through it
    unchanged."""
    if _ROUNDING is None:
        return t
    dtype = _ROUNDING[1] if backward else _ROUNDING[0]
    with torch.no_grad():
        scale = (t.abs().amax() / torch.finfo(dtype).max).clamp_min(1e-30)
        r = (t / scale).to(dtype).to(t.dtype) * scale
    return t + (r - t).detach() if t.requires_grad else r


@contextlib.contextmanager
def product_precision(dtypes: Optional[Tuple[torch.dtype, torch.dtype]]):
    """Within the block every conv rounds its operands and its output to
    ``dtypes`` (the forward's, the backward's; ``rounded``)."""
    global _ROUNDING
    saved, _ROUNDING = _ROUNDING, dtypes
    try:
        yield
    finally:
        _ROUNDING = saved


def tiled(v: torch.Tensor, tile: int, fill: int) -> torch.Tensor:
    """[..., N] -> [..., ceil(N / tile), tile], the ragged tail filled."""
    pad = -v.shape[-1] % tile
    if pad:
        v = torch.cat([v, v.new_full((*v.shape[:-1], pad), fill)], -1)
    return v.reshape(*v.shape[:-1], -1, tile)
