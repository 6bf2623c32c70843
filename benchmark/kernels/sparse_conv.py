"""The work of the sparse convs of one forward (and backward) pass, counted
from the reference's maps at the step's inputs, so that the count is the
same whatever implements the convs.

A conv's matched pairs M are the (input row, output row, offset) triples
its map resolves over valid rows. Its forward does 2 M Cin Cout
operations, its dX and its dW as many again each. Bytes count each input
row read once and each output row written once, over valid rows: the
features, the weights, the map's query keys and the input level's sorted
keys and rows. A 1x1 same-level conv is a plain matmul outside this
family: it counts for the model's operations, not for the family's
roofline."""
from __future__ import annotations

from typing import Dict, List

import torch

from ..reference.core.coords import lookup
from ..reference.models.common import SparseConv


def _matched(graph, spec) -> int:
    cmap = graph.maps.get(spec.key)
    out_mask = graph.levels[spec.out_stride].mask
    if cmap is not None:
        lv = graph.levels[spec.in_stride]
        hit = lookup(lv.skeys, lv.srow, cmap.qkey) >= 0
    else:
        n_in = graph.levels[spec.in_stride].mask.shape[0]
        idx = graph.kmaps[spec.key]
        hit = (idx >= 0) & (idx < n_in)
    return int((hit & out_mask[None, :]).sum())


def conv_calls(model: torch.nn.Module, graph, elt: int,
               backward: bool) -> List[Dict]:
    """One entry per conv kernel call of a forward (and, with
    ``backward``, its backward) over ``graph``: {"conv", "part" ('fwd',
    'dx', 'dw'), "flops", "bytes", "family" (True where the family's
    kernels run it)}; ``elt`` the features' bytes per element."""
    calls = []
    for name, m in model.named_modules():
        if not isinstance(m, SparseConv):
            continue
        spec, cin, cout = m.spec, m.in_ch, m.out_ch
        # conv1 reads the implicit presence input and needs no dX
        is_input = name == "conv1" and cin == 1
        n_in = int(graph.levels[spec.in_stride].mask.sum())
        if spec.is_identity_map:
            mm, family, kvol = n_in, False, 1
            n_out = n_in
        else:
            mm, family = _matched(graph, spec), True
            kvol = spec.kernel_size ** 3
            n_out = int(graph.levels[spec.out_stride].mask.sum())
        flops = 2.0 * mm * cin * cout
        w_bytes = 4.0 * kvol * cin * cout
        map_bytes = 4.0 * kvol * n_out + 8.0 * n_in
        if is_input:
            fwd_bytes = w_bytes + elt * n_out * cout
        else:
            fwd_bytes = (elt * n_in * cin + w_bytes + map_bytes
                         + elt * n_out * cout)
        calls.append({"conv": name, "part": "fwd", "flops": flops,
                      "bytes": fwd_bytes, "family": family})
        if backward:
            if not is_input:
                calls.append({"conv": name, "part": "dx", "flops": flops,
                              "bytes": (elt * n_out * cout + w_bytes
                                        + map_bytes + elt * n_in * cin),
                              "family": family})
            x_bytes = 0.0 if is_input else elt * n_in * cin
            calls.append({"conv": name, "part": "dw", "flops": flops,
                          "bytes": (x_bytes + elt * n_out * cout + map_bytes
                                    + w_bytes), "family": family})
    return calls


def least_seconds(call: Dict, peak_flops: float, peak_bytes: float) -> float:
    """The least time the card could take for a call: the larger of its
    operations over the peak rate and its bytes over the peak bandwidth."""
    return max(call["flops"] / peak_flops, call["bytes"] / peak_bytes)
