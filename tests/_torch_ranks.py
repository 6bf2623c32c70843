"""Rank functions of tests/test_torch_parallel.py (no JAX: spawned ranks
import this module by name) and the inputs both the ranks and the test's
one-process oracles build."""
import numpy as np
import torch

from gcl_tpu_torch.core.kernel_maps import default_level_caps
from gcl_tpu_torch.losses.gcl import GCLLossConfig
from gcl_tpu_torch.models.resunet import ResUNetBN2C
from gcl_tpu_torch.models.weights import gradients_by_name
from gcl_tpu_torch.parallel import (make_global_grad_fn,
                                    make_parallel_train_step, world)
from gcl_tpu_torch.train import steps as tsteps

from _torch_parity import VOXEL, clouds, narrow_exp_classes, strides_of

RANKS = 2
MOM, WD = 0.8, 1e-4
# the GCL step: 2 samples of C clouds, one a rank
GCL_B, GCL_C, GCL_P, GCL_NV = 2, 3, 600, 320
MAX_POS, MAX_HN = 64, 96
# the pair step: 2 pairs, one a rank
PAIR_B, PAIR_P, PAIR_NV, CORR_K = 2, 1500, 448, 4
PAIR_CFG = dict(batch_size=PAIR_B // RANKS, num_pos_per_batch=48,
                num_hn_samples_per_batch=64, triplet_num_pos=16,
                triplet_num_hn=16, triplet_num_rand=16, pos_thresh=0.1,
                neg_thresh=1.4, neg_weight=1.0, jitter_feats=True)


def gcl_model():
    """ResUNetBN2C as tests/test_parallel.py builds it."""
    return ResUNetBN2C(1, 16, bn_momentum=0.05, normalize_feature=True,
                       conv1_kernel_size=3, D=3)


def gcl_setup(mod):
    """(conv specs, StepConfig) of the GCL shard step in ``mod``
    (gcl_tpu's or the port's train.steps): capacities of one shard."""
    specs = ResUNetBN2C.conv_specs(3)
    n_shard = GCL_B // RANKS * GCL_C * GCL_NV
    return specs, mod.StepConfig(
        voxel_size=VOXEL, nv_cap=GCL_NV,
        level_caps=default_level_caps(n_shard, strides_of(specs), 0.7),
        knn_chunk=128, search_cell=None, momentum=MOM, weight_decay=WD)


def gcl_batch(seed):
    """(points [B, C, P, 3], pmask, transforms, radius): each neighbour
    cloud is its sample's centre scene seen from the neighbour's pose."""
    centre, pmask = clouds(seed, GCL_B, GCL_P)
    rng = np.random.RandomState(seed + 1)
    transforms = np.broadcast_to(np.eye(4, dtype=np.float32),
                                 (GCL_B, GCL_C, 4, 4)).copy()
    pts = np.empty((GCL_B, GCL_C, GCL_P, 3), np.float32)
    for b in range(GCL_B):
        for c in range(GCL_C):
            if c:
                a = rng.uniform(-0.2, 0.2)
                transforms[b, c, :2, :2] = [[np.cos(a), -np.sin(a)],
                                            [np.sin(a), np.cos(a)]]
                transforms[b, c, :3, 3] = rng.uniform(-1.5, 1.5, 3) * [
                    1, 1, 0.1]
            world_pts = centre[b] + rng.randn(GCL_P, 3).astype(
                np.float32) * 0.05
            r, t = transforms[b, c, :3, :3], transforms[b, c, :3, 3]
            pts[b, c] = (world_pts - t) @ r
    pmask = (np.repeat(pmask[:, None], GCL_C, axis=1)
             & (rng.rand(GCL_B, GCL_C, GCL_P) > 0.1))
    return pts, pmask, transforms, np.array([0.45, 0.6], np.float32)


def pair_setup(mod):
    """(conv specs, StepConfig) of the narrow-EXP pair shard step."""
    specs = narrow_exp_classes()[1].conv_specs(5)
    n_shard = PAIR_B // RANKS * PAIR_NV
    return specs, mod.StepConfig(
        voxel_size=VOXEL, nv_cap=PAIR_NV,
        level_caps=default_level_caps(n_shard, strides_of(specs), 0.6),
        knn_chunk=128, corr_k=CORR_K, search_cell=None, momentum=MOM,
        weight_decay=WD)


def pair_model():
    return narrow_exp_classes()[1](1, 32, bn_momentum=0.05,
                                   normalize_feature=True,
                                   conv1_kernel_size=5, D=3)


def pair_batch(seed):
    """(points0, pmask0, points1, pmask1, trans [B, 4, 4], radius [B]).
    The clouds are spread three times wider than clouds() makes them, so
    that the coarse levels of one pair a rank hold enough voxels for their
    batch norms: on the narrower clouds float32 itself leaves float64 by
    up to 6e-4 of a gradient's max at some weights, above the 1e-5 the
    comparison with gcl_tpu holds."""
    pts0, pmask0 = clouds(seed, PAIR_B, PAIR_P)
    pts0 = (pts0 * np.float32(3.0)).astype(np.float32)
    rng = np.random.RandomState(seed + 1)
    trans = np.tile(np.eye(4, dtype=np.float32), (PAIR_B, 1, 1))
    pts1 = np.empty_like(pts0)
    for b in range(PAIR_B):
        a = rng.uniform(-0.3, 0.3)
        trans[b, :2, :2] = [[np.cos(a), -np.sin(a)], [np.sin(a), np.cos(a)]]
        trans[b, :3, 3] = rng.uniform(-1.0, 1.0, 3) * [1, 1, 0.2]
        moved = pts0[b] @ trans[b, :3, :3].T + trans[b, :3, 3]
        pts1[b] = moved + rng.randn(PAIR_P, 3).astype(np.float32) * 0.03
    pmask1 = pmask0 & (rng.rand(PAIR_B, PAIR_P) > 0.05)
    return (pts0, pmask0, pts1.astype(np.float32), pmask1, trans,
            np.array([0.45, 0.4], np.float32))


def shard(batch, rank, n=RANKS):
    """Rank ``rank``'s contiguous slice of a global batch, as tensors."""
    per = batch[0].shape[0] // n
    return tuple(torch.from_numpy(np.ascontiguousarray(
        a[rank * per:(rank + 1) * per])) for a in batch)


def gcl_grad_fn(model):
    specs, cfg = gcl_setup(tsteps)
    return tsteps.make_gcl_grad_fn(
        model, specs, cfg, GCLLossConfig(), "finest",
        max_pos_cluster=MAX_POS, max_hn_samples=MAX_HN, pos_weight=1.0,
        finest_weight=1.0, neg_weight=1.0, jitter=False)


def pair_grad_fn(model):
    specs, cfg = pair_setup(tsteps)
    return tsteps.make_pair_grad_fn(model, specs, cfg,
                                    "hardest_contrastive", PAIR_CFG)


def _snapshot(model):
    return {"grads": {k: g.clone() for k, g in
                      gradients_by_name(model).items()},
            "state": {k: v.clone() for k, v in model.state_dict().items()}}


def parallel_cases(rank, world_size, inputs_path, out_path):
    """This rank's part of every data-parallel case of
    tests/test_torch_parallel.py, written to ``out_path`` % rank:
    the lifted GCL and pair grad_fn once each, two SGD steps of the GCL
    step, and AccumStepper at iter_size 2 over two micro-batches."""
    torch.set_num_threads(1)
    assert world() == (rank, world_size) == (rank, RANKS)
    inp = torch.load(inputs_path, weights_only=False)
    out = {}

    model = gcl_model()
    model.load_state_dict(inp["gcl_state"])
    lifted = make_global_grad_fn(gcl_grad_fn(model), model)
    out["gcl_metrics"] = lifted(*shard(inp["gcl_batch"], rank),
                                draws=inp["gcl_draws"][rank])
    out["gcl"] = _snapshot(model)

    model = pair_model()
    model.load_state_dict(inp["pair_state"])
    lifted = make_global_grad_fn(pair_grad_fn(model), model)
    out["pair_metrics"] = lifted(*shard(inp["pair_batch"], rank),
                                 draws=inp["pair_draws"][rank])
    out["pair"] = _snapshot(model)

    model = gcl_model()
    model.load_state_dict(inp["gcl_state"])
    _, cfg = gcl_setup(tsteps)
    _, step = make_parallel_train_step(model, gcl_grad_fn(model), cfg)
    for i, lr in enumerate(inp["lrs"]):
        step(lr, *shard(inp["sgd_batches"][i], rank),
             draws=inp["sgd_draws"][i][rank])
    out["sgd"] = _snapshot(model)

    model = gcl_model()
    model.load_state_dict(inp["gcl_state"])
    opt = tsteps.make_optimizer(model.parameters(), cfg)
    stepper = tsteps.AccumStepper(
        opt, make_global_grad_fn(gcl_grad_fn(model), model), 2)
    for i in range(2):
        stepper(inp["lrs"][0], *shard(inp["sgd_batches"][i], rank),
                draws=inp["sgd_draws"][i][rank])
    out["accum"] = _snapshot(model)
    torch.save(out, out_path % rank)


def build_trainer(rank, world_size, config, out_path):
    """Build the trainer of ``config`` on this CPU rank, from initial
    weights of this rank's own seed, and record its data-parallel
    settings; then run its epoch loop for 2 epochs with validation, the
    steps replaced by one all-reduce each and the validation by a fixed
    record, with barriers made to raise: every rank validates, and no
    rank waits in a collective while another does."""
    import torch.distributed as dist

    from gcl_tpu_torch.data.loader import make_data_loader
    from gcl_tpu_torch.train.trainer import get_trainer

    torch.manual_seed(rank)
    loader = make_data_loader(config, "train", config.batch_size,
                              shard=world())
    t = get_trainer(config.trainer)(config, loader, device="cpu")
    record = {"data_parallel": t.data_parallel, "rank": t.rank,
              "n_shards": t.n_shards, "shard_batch": t.shard_batch,
              "loader_shard": (loader.shard_id, loader.num_shards),
              "level_caps": t.step_cfg.level_caps,
              "params": {k: v.clone() for k, v in
                         t.model.state_dict().items()}}

    def no_barrier(*args, **kwargs):
        raise AssertionError("a rank waited in a barrier")

    validated = []
    dist.barrier = no_barrier
    t.test_valid, t.max_epoch, t.val_epoch_freq = True, 2, 1
    t._val_fns = lambda: None
    t._train_epoch = lambda epoch: dist.all_reduce(torch.ones(1))
    t._valid_epoch = lambda: (validated.append(1)
                              or {t.best_val_metric: 0.5})
    t.train()
    record["validated"] = len(validated)
    torch.save(record, out_path % rank)


def slow_rank(rank, world_size, seconds, out_path):
    """A rank alive and slow: its pid into its file, one all-reduce, a
    sleep, then "done" after the pid."""
    import os
    import time

    import torch.distributed as dist

    with open(out_path % rank, "w") as f:
        f.write(f"{os.getpid()} ")
    dist.all_reduce(torch.ones(1))
    time.sleep(seconds)
    with open(out_path % rank, "a") as f:
        f.write("done")
