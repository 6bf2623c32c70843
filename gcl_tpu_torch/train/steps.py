"""The train steps (port of gcl_tpu/train/steps.py: StepConfig,
make_optimizer, make_gcl_grad_fn, make_gcl_train_step, make_pair_grad_fn,
make_pair_train_step, AccumStepper, make_dist_err_step, make_val_step).

One step spans the whole per-iteration pipeline on the device. The GCL
step: voxelize -> colocation groups -> stride levels and conv maps ->
sparse U-Net forward and backward -> group loss -> SGD update. The FCGF
pair step: each side voxelized and run through the U-Net on its own (side
0, then side 1, so BN running stats move twice) -> ground-truth
correspondences -> pair loss -> one backward -> SGD update. The model
(parameters and BN running stats) and the optimizer (momentum buffers)
hold the state, as is PyTorch's habit; gcl_tpu threads a TrainState
through instead.

Optimizer semantics = torch.optim.SGD(lr, momentum, weight_decay) with
dampening 0: grad + wd * p -> momentum buffer -> p -= lr * buf; lr is fed
in per step. Weight decay covers every parameter, BN scale and bias
included, as gcl_tpu's optax chain does.

make_val_step is the pair (FCGF) validation step.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import torch

from ..core.kernel_maps import METHODS, ConvSpec, build_graph
from ..data.device_pipeline import (VoxelizedClouds, batch_colocation_groups,
                                    build_correspondences,
                                    voxelize_per_cloud)
from ..kernels.build import summing
from ..losses.common import sample_without_replacement
from ..losses.gcl import (GCLLossConfig, LossDraws, SpatialNegFilter,
                          finest_contrastive_loss, location_circle_loss,
                          location_contrastive_loss, member_group_index)
from ..losses.pairs import (PairLossDraws, contrastive_loss,
                            hardest_contrastive_loss, hardest_triplet_loss,
                            triplet_loss)
from ..reg.matching import find_nn
from ..reg.robust import est_quad_linear_robust
from ..utils.spans import span
from .diagnostics import group_distance_errors

_GROUP_LOSSES = {"finest": finest_contrastive_loss,
                 "location": location_contrastive_loss,
                 "circle": location_circle_loss}


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """Static settings of a train step."""

    voxel_size: float
    nv_cap: int
    level_caps: Dict[int, int]
    group_k: int = 5
    corr_k: int = 8  # ground-truth correspondences per source voxel (FCGF)
    pos_pair_cap: int = 1 << 20  # gcl_tpu's field; no step reads it
    knn_chunk: int = 1024
    # Hash-grid cell of the group search (at least twice the largest search
    # radius; a larger radius is clamped to cell / 2): the S = B * C searches
    # of a batch run as one windowed_cell_topk call (K1). None ->
    # brute-force O(QT) search, knn_chunk queries at a time.
    search_cell: Optional[float] = None
    # The FCGF step's correspondence search on the grid (grid_radius_knn)
    # sees the first cell_cap targets of a cell; the group search's kernel
    # sees every target and ignores it.
    cell_cap: int = 8
    member_r_cap: int = 32  # width of the reverse membership index
    # Negative-loss intra-group filter: 'spatial' (the geometric 2r test in
    # the aligned frame, no index to build) or 'membership' (exact
    # co-membership through member_group_index).
    neg_filter: str = "spatial"
    momentum: float = 0.8
    weight_decay: float = 1e-4
    jitter_sigma: float = 0.01
    jitter_p: float = 0.95
    # 'input': exact feature jitter of the conv1 input, split by linearity
    # into the presence conv and a scalar eps conv. 'c1z':
    # distribution-matched iid noise per (output, offset) on conv1's
    # output instead (sparse_ops.sparse_conv_c1z_jittered).
    jitter_mode: str = "input"
    # The features' type through the model: float32, or bfloat16 (root
    # bench.py's; products in bf16, sums and BN statistics in float32).
    # Parameters, optimizer state and the loss stay float32.
    compute_dtype: torch.dtype = torch.float32
    # How the convs get their maps (core.kernel_maps.build_graph): 'auto'
    # is implicit maps up to 31 clouds a batch (B * C) and explicit index
    # tables above; 'explicit' asks for the tables at any batch.
    graph_method: str = "auto"


class StepDraws(NamedTuple):
    """The random numbers of one train step, already drawn (tests hand the
    same numbers to gcl_tpu): sample_gate_u f32[B] the per-sample jitter
    gates, jitter (gate_u scalar, normal) conv1's noise (normal f32[N, 1]
    for jitter_mode 'input' and on the explicit route, where conv1 reads
    its jittered input; f32[N, K] for 'c1z' on the occupancy path), loss
    the loss's uniforms. Unused fields may be None."""

    sample_gate_u: Optional[torch.Tensor] = None
    jitter: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
    loss: Optional[LossDraws] = None


class PairDraws(NamedTuple):
    """The random numbers of one FCGF pair step, already drawn (tests hand
    the same numbers to gcl_tpu): side0 / side1 each a StepDraws holding
    that side's per-sample jitter gates (sample_gate_u f32[B]) and conv1's
    noise (jitter: gate_u scalar, normal f32[N, 1]); loss the pair loss's
    PairLossDraws. Unused fields may be None."""

    side0: Optional[StepDraws] = None
    side1: Optional[StepDraws] = None
    loss: Optional[PairLossDraws] = None


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


def _check_step(step_cfg: StepConfig) -> None:
    if step_cfg.compute_dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(
            f"compute_dtype {step_cfg.compute_dtype}: the port computes in "
            f"float32 or bfloat16")
    if step_cfg.neg_filter not in ("spatial", "membership"):
        raise ValueError(f"neg_filter {step_cfg.neg_filter!r}: 'spatial' or "
                         f"'membership'")
    if step_cfg.jitter_mode not in ("input", "c1z"):
        raise ValueError(f"jitter_mode {step_cfg.jitter_mode!r}: 'input' or "
                         f"'c1z'")
    if step_cfg.graph_method not in METHODS:
        raise ValueError(f"graph_method {step_cfg.graph_method!r}: one of "
                         f"{METHODS}")


def _check_config(step_cfg: StepConfig, loss_kind: str) -> None:
    _check_step(step_cfg)
    if loss_kind not in _GROUP_LOSSES:
        raise ValueError(f"loss {loss_kind!r}: one of "
                         f"{sorted(_GROUP_LOSSES)}")


def _geometry(points, pmask, transforms, radius, conv_specs,
              step_cfg: StepConfig):
    """(flat voxels, graph, groups, vox_b) of a colocation batch, the part
    the train step and the diagnostic step share."""
    b, c, p, _ = points.shape
    # the spans name the step's stages in a torch.profiler trace
    with span("gcl/voxelize"):
        vox = voxelize_per_cloud(points.reshape(b * c, p, 3),
                                 pmask.reshape(b * c, p),
                                 step_cfg.voxel_size, step_cfg.nv_cap)
        nv = vox.xyz.shape[1]
        vox_b = VoxelizedClouds(vox.coords.reshape(b, c, nv, 4),
                                vox.mask.reshape(b, c, nv),
                                vox.xyz.reshape(b, c, nv, 3))
        flat = vox.flatten()
    with span("gcl/groups"):
        groups = batch_colocation_groups(
            vox_b, transforms, radius, k=step_cfg.group_k,
            chunk=step_cfg.knn_chunk, cell=step_cfg.search_cell)
    with span("gcl/graph"):
        graph = build_graph(flat.coords, flat.mask, conv_specs,
                            step_cfg.level_caps, n_clouds=b * c,
                            method=step_cfg.graph_method)
    return flat, graph, groups, vox_b


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
    group_loss = _GROUP_LOSSES[loss_kind]

    def grad_fn(points, pmask, transforms, radius, generator=None,
                draws: Optional[StepDraws] = None):
        draws = draws or StepDraws()
        b, c = points.shape[:2]
        with torch.no_grad():
            flat, graph, groups, vox_b = _geometry(
                points, pmask, transforms, radius, conv_specs, step_cfg)
            nv = vox_b.xyz.shape[2]
            if step_cfg.neg_filter == "spatial":
                # voxel positions in their sample's centre frame
                aligned = (vox_b.xyz
                           @ transforms[:, :, :3, :3].transpose(2, 3)
                           + transforms[:, :, None, :3, 3])
                sample_id = torch.arange(
                    b, dtype=torch.int32,
                    device=points.device).repeat_interleave(c * nv)
                neg_filter = SpatialNegFilter(aligned.reshape(-1, 3),
                                              sample_id, radius)
            else:
                neg_filter = member_group_index(groups, flat.mask.shape[0],
                                                step_cfg.member_r_cap)
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
                conv1_jitter = (step_cfg.jitter_sigma, 1.0, jit_rows,
                                step_cfg.jitter_mode != "c1z")

        model.train()
        with span("gcl/unet"):
            f_out = model(graph, flat.feats.to(step_cfg.compute_dtype),
                          conv1_jitter=conv1_jitter, generator=generator,
                          jitter_draws=draws.jitter)
        with span("gcl/loss"):
            out = group_loss(
                summing(f_out), flat.mask, groups, neg_filter, generator,
                max_pos_cluster, max_hn_samples, loss_cfg, draws.loss)
            total = (pos_weight * out.pos_loss
                     + finest_weight * out.finest_loss
                     + neg_weight * out.neg_loss)
        model.zero_grad(set_to_none=True)
        with span("gcl/backward"):
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
    return opt, make_train_step_from_grad(opt, grad_fn)


def make_train_step_from_grad(opt: torch.optim.Optimizer,
                              grad_fn: Callable,
                              stage: str = "gcl") -> Callable:
    """grad_fn(*batch, generator=None, draws=None) -> metrics, which leaves
    the gradients in ``.grad``, as a one-SGD-step-per-batch step function:
    step_fn(lr, *batch, generator=None, draws=None) -> metrics. The update
    is the span ``{stage}/sgd``."""

    def step_fn(lr: float, *batch, generator=None, draws=None):
        metrics = grad_fn(*batch, generator=generator, draws=draws)
        for group in opt.param_groups:
            group["lr"] = lr
        with span(f"{stage}/sgd"):
            opt.step()
        return metrics

    return step_fn


_PAIR_KINDS = ("hardest_contrastive", "contrastive", "triplet",
               "hardest_triplet")


def make_pair_grad_fn(model: torch.nn.Module,
                      conv_specs: Sequence[ConvSpec], step_cfg: StepConfig,
                      trainer_kind: str, cfg: Dict) -> Callable:
    """grad_fn(points0 [B, P, 3], pmask0, points1, pmask1, trans [B, 4, 4],
    radius [B], generator=None, draws=None) -> metrics, for the pair-loss
    trainers: ``trainer_kind`` 'hardest_contrastive', 'contrastive',
    'triplet' or 'hardest_triplet'; ``cfg`` the run config's loss settings
    (batch_size, num_pos_per_batch, num_hn_samples_per_batch,
    triplet_num_pos / _hn / _rand, pos_thresh, neg_thresh, neg_weight,
    jitter_feats).

    The two sides run through the model in train mode one after the other,
    each with its own per-sample jitter gates and conv1 noise; trans maps
    cloud 0 onto cloud 1. Leaves d loss / d p in every parameter's
    ``.grad``. Random numbers come from ``generator`` unless ``draws``
    (PairDraws) hands them in.
    """
    _check_step(step_cfg)
    if trainer_kind not in _PAIR_KINDS:
        raise ValueError(f"trainer kind {trainer_kind!r}: one of "
                         f"{_PAIR_KINDS}")
    jitter = bool(cfg.get("jitter_feats", True))
    b_cfg = cfg["batch_size"]
    num_pos = cfg["num_pos_per_batch"] * b_cfg
    num_hn = cfg["num_hn_samples_per_batch"] * b_cfg
    t_pos = cfg["triplet_num_pos"] * b_cfg
    t_hn = cfg["triplet_num_hn"] * b_cfg
    t_rand = cfg["triplet_num_rand"] * b_cfg
    pos_thresh, neg_thresh = cfg["pos_thresh"], cfg["neg_thresh"]
    neg_weight = cfg["neg_weight"]

    def side_forward(points, pmask, generator, draws: StepDraws):
        b = points.shape[0]
        with torch.no_grad():
            with span("fcgf/voxelize"):
                vox = voxelize_per_cloud(points, pmask, step_cfg.voxel_size,
                                         step_cfg.nv_cap)
                flat = vox.flatten()
            with span("fcgf/graph"):
                graph = build_graph(flat.coords, flat.mask, conv_specs,
                                    step_cfg.level_caps, n_clouds=b,
                                    method=step_cfg.graph_method)
            conv1_jitter = None
            if jitter:
                # one p-gate per sample and side; conv1 owns the noise:
                # 'input' is the exact feature jitter of its input, 'c1z'
                # the distribution-matched noise on its output
                jit_rows = _sample_gates(generator, step_cfg.jitter_p, b,
                                         flat.coords[:, 0],
                                         draws.sample_gate_u)
                conv1_jitter = (step_cfg.jitter_sigma, 1.0, jit_rows,
                                step_cfg.jitter_mode != "c1z")
        with span("fcgf/unet"):
            f = model(graph, flat.feats.to(step_cfg.compute_dtype),
                      conv1_jitter=conv1_jitter, generator=generator,
                      jitter_draws=draws.jitter)
        return vox, flat, summing(f)

    @torch.no_grad()
    def batch_correspondences(vox0, vox1, trans, radius):
        """Each sample's ground-truth pairs, rows offset to the flat
        [B * Nv] arrays of both sides."""
        b, nv = vox0.mask.shape
        pairs, mask = [], []
        for i in range(b):
            p, m = build_correspondences(
                vox0.xyz[i], vox0.mask[i], vox1.xyz[i], vox1.mask[i],
                trans[i], radius[i], k=step_cfg.corr_k,
                chunk=step_cfg.knn_chunk, cell=step_cfg.search_cell,
                cell_cap=step_cfg.cell_cap)
            pairs.append(p + i * nv)
            mask.append(m)
        return torch.cat(pairs), torch.cat(mask)

    def grad_fn(points0, pmask0, points1, pmask1, trans, radius,
                generator=None, draws: Optional[PairDraws] = None):
        draws = draws or PairDraws()
        model.train()
        vox0, flat0, f0 = side_forward(points0, pmask0, generator,
                                       draws.side0 or StepDraws())
        vox1, flat1, f1 = side_forward(points1, pmask1, generator,
                                       draws.side1 or StepDraws())
        with span("fcgf/correspondences"):
            radius = torch.broadcast_to(torch.as_tensor(
                radius, dtype=torch.float32, device=points0.device),
                (points0.shape[0],))
            pairs, pm = batch_correspondences(vox0, vox1, trans, radius)
        args = (f0, f1, flat0.mask, flat1.mask, pairs, pm, generator)
        with span("fcgf/loss"):
            if trainer_kind == "hardest_contrastive":
                out = hardest_contrastive_loss(
                    *args, num_pos=num_pos, num_hn_samples=num_hn,
                    pos_thresh=pos_thresh, neg_thresh=neg_thresh,
                    draws=draws.loss)
            elif trainer_kind == "contrastive":
                out = contrastive_loss(*args, neg_thresh=neg_thresh,
                                       num_neg=2 * num_pos, draws=draws.loss)
            elif trainer_kind == "triplet":
                out = triplet_loss(*args, num_pos=t_pos,
                                   num_rand_triplet=t_rand,
                                   neg_thresh=neg_thresh, draws=draws.loss)
            else:
                out = hardest_triplet_loss(
                    *args, num_pos=t_pos, num_hn_samples=t_hn,
                    num_rand_triplet=t_rand, neg_thresh=neg_thresh,
                    draws=draws.loss)
            if trainer_kind in ("hardest_contrastive", "contrastive"):
                total = out.pos_loss + neg_weight * out.neg_loss
                pos, neg = out.pos_loss, out.neg_loss
            else:
                total, pos, neg = out.loss, out.pos_dist, out.neg_dist
        model.zero_grad(set_to_none=True)
        with span("fcgf/backward"):
            total.backward()
        return {"loss": total.detach(), "pos_loss": pos.detach(),
                "neg_loss": neg.detach(),
                "num_pos_pairs": pm.sum().to(torch.float32),
                "num_valid_voxels": (flat0.mask.sum()
                                     + flat1.mask.sum()).to(torch.float32)}

    return grad_fn


def make_pair_train_step(model: torch.nn.Module,
                         conv_specs: Sequence[ConvSpec],
                         step_cfg: StepConfig, trainer_kind: str, cfg: Dict
                         ) -> Tuple[torch.optim.SGD, Callable]:
    """The FCGF pair train step: (optimizer, step_fn).

    step_fn(lr, points0, pmask0, points1, pmask1, trans, radius,
    generator=None, draws=None) -> metrics takes one SGD step on ``model``
    in place.
    """
    opt = make_optimizer(model.parameters(), step_cfg)
    grad_fn = make_pair_grad_fn(model, conv_specs, step_cfg, trainer_kind,
                                cfg)
    return opt, make_train_step_from_grad(opt, grad_fn, "fcgf")


class AccumStepper:
    """Caffe-style ``iter_size`` gradient accumulation: the gradients of
    ``loss / iter_size`` are summed over ``iter_size`` consecutive
    micro-batches and ONE SGD step is taken at the window's end. BatchNorm
    running stats move at every micro-batch, as at every forward.

    Drop-in for a step function: ``stepper(lr, *batch, generator=None,
    draws=None) -> metrics``; the optimizer steps on every ``iter_size``-th
    call. ``reset()`` discards a partial window. The accumulator is a
    float32 gradient tree by parameter, ``stepper.accumulated``.
    """

    def __init__(self, opt: torch.optim.Optimizer, grad_fn: Callable,
                 iter_size: int, stage: str = "gcl"):
        self.opt, self.grad_fn, self.stage = opt, grad_fn, stage
        self.iter_size = int(iter_size)
        self._params = [p for g in opt.param_groups for p in g["params"]]
        self.reset()

    def reset(self):
        self._acc = None
        self._count = 0

    @property
    def boundary(self) -> bool:
        """True right after an optimizer step (the window just closed)."""
        return self._count == 0

    @property
    def accumulated(self):
        """The window's summed gradients so far, in the optimizer's
        parameter order (None before the first micro-batch)."""
        return self._acc

    def __call__(self, lr: float, *batch, generator=None, draws=None):
        metrics = self.grad_fn(*batch, generator=generator, draws=draws)
        with torch.no_grad():
            if self._acc is None:
                self._acc = [torch.zeros_like(p, dtype=torch.float32)
                             for p in self._params]
            for a, p in zip(self._acc, self._params):
                if p.grad is not None:
                    a.add_(p.grad.to(a.dtype) / self.iter_size)
        self._count += 1
        if self._count == self.iter_size:
            for a, p in zip(self._acc, self._params):
                p.grad = a.to(p.dtype)
            for group in self.opt.param_groups:
                group["lr"] = lr
            with span(f"{self.stage}/sgd"):
                self.opt.step()
            self.reset()
        return metrics


def make_dist_err_step(model: torch.nn.Module,
                       conv_specs: Sequence[ConvSpec],
                       step_cfg: StepConfig) -> Callable:
    """The GCL validation (distance-error) step: eval-mode features over a
    colocation batch, then per member its distance offset to the finest
    member's own LiDAR range and its feature distance to the finest member.

    diag_step(points [B, C, P, 3], pmask, transforms, radius) ->
    (dist_err, feat_err, mask), flat [G * Kc]. It runs the train step's
    group search and leaves the model in eval mode.
    """
    _check_config(step_cfg, "finest")

    @torch.no_grad()
    def diag_step(points, pmask, transforms, radius):
        flat, graph, groups, vox_b = _geometry(
            points, pmask, transforms, radius, conv_specs, step_cfg)
        model.eval()
        f = summing(model(graph, flat.feats.to(step_cfg.compute_dtype)))
        # each member voxel's own-frame LiDAR range
        own = torch.sqrt((vox_b.xyz * vox_b.xyz).sum(dim=-1)).reshape(-1)
        central = own[groups.member_idx.long().clamp_min(0)]
        return group_distance_errors(f, groups, central)

    return diag_step


def make_val_step(model: torch.nn.Module, conv_specs: Sequence[ConvSpec],
                  step_cfg: StepConfig, subsample: int = 5000,
                  hit_ratio_thresh: float = 0.1) -> Callable:
    """The pair validation step: eval-mode features of both sides, then per
    sample ``subsample`` voxels of each side (sample_without_replacement),
    feature-NN correspondences, the robust linearised pose, and its
    metrics against the GT transform.

    val_step(points0 [B, P, 3], pmask0, points1, pmask1, trans [B, 4, 4],
    generator=None, draws=None) -> {"t_est" [B, 4, 4], "hit_ratio", "rte",
    "rre" (degrees), "loss" (the clamped corr_dist)}, each [B]. The
    subsamples' uniforms come from ``generator`` unless ``draws`` hands
    them in, a (u0, u1) pair per sample. Leaves the model in eval mode.
    """
    @torch.no_grad()
    def val_step(points0, pmask0, points1, pmask1, trans, generator=None,
                 draws=None):
        model.eval()

        def side(points, pmask):
            vox = voxelize_per_cloud(points, pmask, step_cfg.voxel_size,
                                     step_cfg.nv_cap)
            flat = vox.flatten()
            graph = build_graph(flat.coords, flat.mask, conv_specs,
                                step_cfg.level_caps,
                                n_clouds=points.shape[0],
                                method=step_cfg.graph_method)
            f = model(graph, flat.feats.to(step_cfg.compute_dtype))
            return vox, f.float().reshape(vox.mask.shape + (-1,))

        vox0, f0 = side(points0, pmask0)
        vox1, f1 = side(points1, pmask1)
        out = {k: [] for k in ("t_est", "hit_ratio", "rte", "rre", "loss")}
        for i in range(points0.shape[0]):
            u0, u1 = draws[i] if draws is not None else (None, None)
            s0, v0 = sample_without_replacement(generator, vox0.mask[i],
                                                subsample, u0)
            s1, v1 = sample_without_replacement(generator, vox1.mask[i],
                                                subsample, u1)
            nn, _ = find_nn(f0[i][s0], f1[i][s1], v1,
                            chunk=step_cfg.knn_chunk)
            xc0 = vox0.xyz[i][s0]
            xc1 = vox1.xyz[i][s1[nn]]
            t_est = est_quad_linear_robust(xc0, xc1, mask=v0)
            t_gt = trans[i]
            n_sel = v0.sum().clamp_min(1)
            aligned = xc0 @ t_gt[:3, :3].T + t_gt[:3, 3]
            d = torch.sqrt(((aligned - xc1) ** 2).sum(1) + 1e-6)
            cosv = (torch.trace(t_est[:3, :3].T @ t_gt[:3, :3]) - 1) / 2
            est0 = xc0 @ t_est[:3, :3].T + t_est[:3, 3]
            dist = torch.sqrt(((est0 - aligned) ** 2).sum(1)).clamp(max=1.0)
            out["t_est"].append(t_est)
            out["hit_ratio"].append(((d < hit_ratio_thresh) & v0).sum()
                                    / n_sel)
            out["rte"].append(torch.sqrt(
                ((t_est[:3, 3] - t_gt[:3, 3]) ** 2).sum()))
            out["rre"].append(torch.rad2deg(torch.arccos(
                cosv.clamp(-1 + 1e-7, 1 - 1e-7))))
            out["loss"].append((dist * v0).sum() / n_sel)
        return {k: torch.stack(v) for k, v in out.items()}

    return val_step
