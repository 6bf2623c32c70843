"""The control's lower precision, by the name a configuration file gives:
``tf32`` (float32 products on the tensor cores' TF32, for a float32
configuration) or ``float8`` (for bf16: every conv of the reference rounds
its operands and outputs to fp8, e4m3 in the forward and e5m2 for the
gradients, each tensor scaled as fp8 training scales it)."""
from __future__ import annotations

import contextlib
from typing import Optional

import torch

CONTROLS = ("tf32", "float8")


@contextlib.contextmanager
def lower(name: Optional[str]):
    """Within the block the reference computes in ``name`` (None: as it
    is, float32 with TF32 off)."""
    from .reference.kernels.build import product_precision

    if name is not None and name not in CONTROLS:
        raise ValueError(f"no control precision {name!r}; one of {CONTROLS}")
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    dtypes = ((torch.float8_e4m3fn, torch.float8_e5m2)
              if name == "float8" else None)
    try:
        if name == "tf32":
            torch.backends.cuda.matmul.allow_tf32 = True
            torch.backends.cudnn.allow_tf32 = True
        with product_precision(dtypes):
            yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved
