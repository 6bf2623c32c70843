"""The GCL train step (port of gcl_tpu/train/steps.py: StepConfig,
make_gcl_grad_fn, make_optimizer, make_gcl_train_step).

One step spans the whole per-iteration pipeline on the device: voxelize ->
colocation groups -> stride levels and conv maps -> sparse U-Net forward
and backward -> group loss -> SGD update. The model (parameters and BN
running stats) and the optimizer (momentum buffers) hold the state, as is
PyTorch's habit; gcl_tpu threads a TrainState through instead.

Optimizer semantics = torch.optim.SGD(lr, momentum, weight_decay) with
dampening 0: grad + wd * p -> momentum buffer -> p -= lr * buf; lr is fed
in per step. Weight decay covers every parameter, BN scale and bias
included, as gcl_tpu's optax chain does.

Gradient accumulation, the pair (FCGF) step and the validation steps are
not ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

from ..core.kernel_maps import ConvSpec, build_graph
from ..data.device_pipeline import (VoxelizedClouds, batch_colocation_groups,
                                    voxelize_per_cloud)
from ..losses.gcl import (GCLLossConfig, LossDraws, SpatialNegFilter,
                          finest_contrastive_loss)


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Static settings of a train step."""

    voxel_size: float
    nv_cap: int
    level_caps: Dict[int, int]
    group_k: int = 5
    knn_chunk: int = 1024
    # Hash-grid cell of the group search. None -> brute-force O(QT)
    # search, the only route ported: a value raises NotImplementedError.
    search_cell: Any = None
    # Negative-loss intra-group filter; only 'spatial' is ported.
    neg_filter: str = "spatial"
    momentum: float = 0.8
    weight_decay: float = 1e-4
    jitter_sigma: float = 0.01
    jitter_p: float = 0.95
    # 'input': exact feature jitter of the conv1 input, split by linearity
    # into the presence conv and a scalar eps conv. 'c1z' (matched output
    # noise) is not ported.
    jitter_mode: str = "input"
    compute_dtype: torch.dtype = torch.float32


class StepDraws(NamedTuple):
    """The random numbers of one train step, already drawn (tests hand the
    same numbers to gcl_tpu): sample_gate_u f32[B] the per-sample jitter
    gates, jitter (gate_u scalar, normal f32[N, 1]) conv1's noise
    (draw_input_eps), loss the loss's uniforms. Unused fields may be
    None."""

    sample_gate_u: Optional[torch.Tensor] = None
    jitter: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    loss: Optional[LossDraws] = None


def make_optimizer(params, cfg: StepConfig) -> torch.optim.SGD:
    # lr is set per step; 1.0 is a placeholder that no update ever uses
    return torch.optim.SGD(params, lr=1.0, momentum=cfg.momentum,
                           dampening=0.0, weight_decay=cfg.weight_decay,
                           nesterov=False)


def _sample_gates(generator, p: float, n_samples: int,
                  row_to_sample: torch.Tensor,
                  u: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-sample jitter gate expanded to rows: f32[N] in {0, 1} (the
    reference draws one gate per sample, not per cloud or row)."""
    if u is None:
        u = torch.rand(n_samples, generator=generator,
                       device=row_to_sample.device)
    gates = (u < p).to(torch.float32)
    return gates[row_to_sample.long().clamp(0, n_samples - 1)]


def _check_config(step_cfg: StepConfig, loss_kind: str) -> None:
    if step_cfg.compute_dtype != torch.float32:
        raise NotImplementedError(
            f"compute_dtype {step_cfg.compute_dtype}: the port computes in "
            f"float32 only (bf16 waits for the tensor-core conv kernels)")
    if step_cfg.neg_filter != "spatial":
        raise NotImplementedError(
            f"neg_filter {step_cfg.neg_filter!r}: only 'spatial' is ported")
    if step_cfg.jitter_mode != "input":
        raise NotImplementedError(
            f"jitter_mode {step_cfg.jitter_mode!r}: only the exact 'input' "
            f"jitter is ported")
    if loss_kind != "finest":
        raise NotImplementedError(
            f"loss {loss_kind!r}: only the 'finest' loss is ported")


def make_gcl_grad_fn(model: torch.nn.Module, conv_specs: Sequence[ConvSpec],
                     step_cfg: StepConfig, loss_cfg: GCLLossConfig,
                     loss_kind: str, max_pos_cluster: int,
                     max_hn_samples: int, pos_weight: float,
                     finest_weight: float, neg_weight: float,
                     jitter: bool = True) -> Callable:
    """grad_fn(points [B, C, P, 3], pmask, transforms [B, C, 4, 4],
    radius [B], generator=None, draws=None) -> metrics.

    Runs the model in train mode (BN running stats move) and leaves
    d loss / d p in every parameter's ``.grad``, replacing what was
    there. Random numbers come from ``generator`` (a generator on the
    points' device) unless ``draws`` hands them in.
    """
    _check_config(step_cfg, loss_kind)

    def grad_fn(points, pmask, transforms, radius, generator=None,
                draws: Optional[StepDraws] = None):
        draws = draws or StepDraws()
        b, c, p, _ = points.shape
        # the record_function ranges name the step's stages in a
        # torch.profiler trace (gcl_tpu_torch.bench --profile)
        with torch.no_grad():
            with record_function("gcl/voxelize"):
                vox = voxelize_per_cloud(points.reshape(b * c, p, 3),
                                         pmask.reshape(b * c, p),
                                         step_cfg.voxel_size,
                                         step_cfg.nv_cap)
                nv = vox.xyz.shape[1]
                vox_b = VoxelizedClouds(vox.coords.reshape(b, c, nv, 4),
                                        vox.mask.reshape(b, c, nv),
                                        vox.xyz.reshape(b, c, nv, 3))
                flat = vox.flatten()
            with record_function("gcl/groups"):
                groups = batch_colocation_groups(
                    vox_b, transforms, radius, k=step_cfg.group_k,
                    chunk=step_cfg.knn_chunk, cell=step_cfg.search_cell)
            with record_function("gcl/graph"):
                graph = build_graph(flat.coords, flat.mask, conv_specs,
                                    step_cfg.level_caps, n_clouds=b * c)
            # voxel positions in their sample's centre frame
            aligned = (vox_b.xyz @ transforms[:, :, :3, :3].transpose(2, 3)
                       + transforms[:, :, None, :3, 3])
            sample_id = torch.arange(
                b, dtype=torch.int32,
                device=points.device).repeat_interleave(c * nv)
            neg_filter = SpatialNegFilter(aligned.reshape(-1, 3), sample_id,
                                          radius)
            conv1_jitter = None
            if jitter:
                # conv1 owns the jitter: centre-cloud rows only, with the
                # per-sample p-gate folded into the row mask
                cloud = flat.coords[:, 0]
                center_rows = (torch.remainder(cloud, c) == 0).to(
                    torch.float32)
                jit_rows = center_rows * _sample_gates(
                    generator, step_cfg.jitter_p, b,
                    torch.div(cloud, c, rounding_mode="floor"),
                    draws.sample_gate_u)
                conv1_jitter = (step_cfg.jitter_sigma, 1.0, jit_rows, True)

        model.train()
        with record_function("gcl/unet"):
            f_out = model(graph, flat.feats, conv1_jitter=conv1_jitter,
                          generator=generator, jitter_draws=draws.jitter)
        with record_function("gcl/loss"):
            out = finest_contrastive_loss(
                f_out, flat.mask, groups, neg_filter, generator,
                max_pos_cluster, max_hn_samples, loss_cfg, draws.loss)
            total = (pos_weight * out.pos_loss
                     + finest_weight * out.finest_loss
                     + neg_weight * out.neg_loss)
        model.zero_grad(set_to_none=True)
        with record_function("gcl/backward"):
            total.backward()
        return {"loss": total.detach(), "pos_loss": out.pos_loss.detach(),
                "finest_loss": out.finest_loss.detach(),
                "neg_loss": out.neg_loss.detach(),
                "num_valid_voxels": flat.mask.sum().to(torch.float32),
                "num_groups": groups.valid.sum().to(torch.float32)}

    return grad_fn


def make_gcl_train_step(model: torch.nn.Module,
                        conv_specs: Sequence[ConvSpec], step_cfg: StepConfig,
                        loss_cfg: GCLLossConfig, loss_kind: str,
                        max_pos_cluster: int, max_hn_samples: int,
                        pos_weight: float, finest_weight: float,
                        neg_weight: float, jitter: bool = True
                        ) -> Tuple[torch.optim.SGD, Callable]:
    """The colocation train step: (optimizer, step_fn).

    step_fn(lr, points, pmask, transforms, radius, generator=None,
    draws=None) -> metrics takes one SGD step on ``model`` in place.
    """
    opt = make_optimizer(model.parameters(), step_cfg)
    grad_fn = make_gcl_grad_fn(model, conv_specs, step_cfg, loss_cfg,
                               loss_kind, max_pos_cluster, max_hn_samples,
                               pos_weight, finest_weight, neg_weight, jitter)

    def step_fn(lr: float, points, pmask, transforms, radius,
                generator=None, draws: Optional[StepDraws] = None):
        metrics = grad_fn(points, pmask, transforms, radius, generator,
                          draws)
        for group in opt.param_groups:
            group["lr"] = lr
        with record_function("gcl/sgd"):
            opt.step()
        return metrics

    return opt, step_fn
