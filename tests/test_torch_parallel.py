"""Data parallelism of the port (gcl_tpu_torch.parallel: one process a
rank, gloo on the CPU) against gcl_tpu's (gcl_tpu/parallel/mesh.py: a
2-device mesh of tests/conftest.py's virtual CPU devices).

- The lifted grad_fn on 2 spawned ranks against gcl_tpu's
  make_global_grad_fn on make_mesh(2), for the GCL step (ResUNetBN2C as
  tests/test_parallel.py builds it, no jitter) and the FCGF pair step
  (the narrow ResUNetFatBNEXP, jitter on): each rank is handed the draws
  gcl_tpu's device d takes from fold_in(key, d), replayed; the averaged
  gradients, BN running statistics and metrics within 1e-5 of each
  tensor's max (the pair clouds spread out, tests/_torch_ranks.py:
  pair_batch says why).
- Port against port: two SGD steps on 2 ranks leave bit-equal parameters
  and statistics on both ranks, equal to the same steps run in one
  process on the averaged shard gradients; AccumStepper at iter_size 2
  composes (one average a micro-batch, one SGD step).
- The loader's rank slices equal gcl_tpu's shard_id slices.
- The entry point (the trainer built on 2 ranks is
  tests/test_torch_trainer.py's): ``python -m gcl_tpu_torch.train
  --device cpu --data_parallel true --num_devices 2``'s main runs an epoch
  of 2 iterations with validation on 2 spawned ranks, rank 0 alone writes
  (one train/loss line a step), and the weights after it agree with
  gcl_tpu's trainer at data_parallel=true, num_devices=2 from the same
  weights and data (no jitter, no augmentation, and loss sample counts
  equal to a shard's pair-list length and voxel capacity, so that every
  valid pair and voxel is taken and no step depends on a random number);
  the same run under torchrun (--distributed_init true) writes the same
  files and ends at the same parameters.
- run_ranks sets no deadline unless asked for one (training sets none).

Every spawn joins its ranks within JOIN_S seconds or fails the test. As
in tests/test_torch_train_step.py the seeds are ones where no ReLU input
sits within float32 rounding of zero.
"""
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gcl_tpu.train.trainer as jtrainer_mod
from gcl_tpu.config import default_config as j_default_config
from gcl_tpu.data import make_data_loader as j_make_data_loader
from gcl_tpu.data.loader import DataLoader as JLoader
from gcl_tpu.data.pairs import PairComplementKittiDataset as JPairs
from gcl_tpu.losses.gcl import GCLLossConfig as JGCLLossConfig
from gcl_tpu.models.resunet import ResUNetBN2C as JBN2C
from gcl_tpu.parallel import make_global_grad_fn as j_global_grad_fn
from gcl_tpu.parallel import make_mesh
from gcl_tpu.train import steps as jsteps
from gcl_tpu_torch.data import pairs
from gcl_tpu_torch.data.loader import DataLoader
from gcl_tpu_torch.data.synthetic import (generate_synthetic_kitti,
                                          write_split_files)
from gcl_tpu_torch.models.simpleunet import SimpleNetBNE
from gcl_tpu_torch.models.weights import (flatten_tree, random_state_dict,
                                          state_dict_to_flax)
from gcl_tpu_torch.parallel import launch, run_ranks, spawn
from gcl_tpu_torch.train import __main__ as entry
from gcl_tpu_torch.train import steps as tsteps
from gcl_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint

import _torch_ranks as R
from _torch_parity import (assert_close_to_max, jax_specs,
                           narrow_exp_classes, one_torch_thread,  # noqa: F401
                           replay_loss_draws, replay_pair_step_draws, to_np)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

JOIN_S = 120.0
LRS = (0.01, 0.02)
REL = 1e-5


def _jax_tree(t):
    return flatten_tree(jax.tree_util.tree_map(np.asarray, t))


def _gcl_draws(key):
    """The loss draws of each of the 2 shards of gcl_tpu's GCL grad_fn
    under make_global_grad_fn(key): device d folds d into the key and
    splits off k_loss."""
    n_vox = R.GCL_B // R.RANKS * R.GCL_C * R.GCL_NV
    return [tsteps.StepDraws(loss=replay_loss_draws(
        jax.random.split(jax.random.fold_in(key, d))[0],
        R.GCL_B // R.RANKS * R.GCL_NV, n_vox, R.MAX_POS, R.MAX_HN))
        for d in range(R.RANKS)]


def _pair_draws(key):
    per = R.PAIR_B // R.RANKS
    n = per * R.PAIR_NV
    return [replay_pair_step_draws(
        jax.random.fold_in(key, d), per, n, n * R.CORR_K,
        num_pos=R.PAIR_CFG["num_pos_per_batch"] * per,
        num_hn=R.PAIR_CFG["num_hn_samples_per_batch"] * per)
        for d in range(R.RANKS)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every port-side case on 2 spawned gloo ranks (one spawn), with the
    inputs and the keys of gcl_tpu's references."""
    tmp = tmp_path_factory.mktemp("ranks")
    gcl_state = random_state_dict(R.gcl_model(), seed=3)
    pair_state = random_state_dict(R.pair_model(), seed=23)
    keys = {"gcl": jax.random.PRNGKey(5), "pair": jax.random.PRNGKey(6)}
    sgd_keys = [jax.random.PRNGKey(10 + i) for i in range(2)]
    inp = {"gcl_state": gcl_state, "pair_state": pair_state,
           "gcl_batch": R.gcl_batch(41), "gcl_draws": _gcl_draws(keys["gcl"]),
           "pair_batch": R.pair_batch(5),
           "pair_draws": _pair_draws(keys["pair"]),
           "sgd_batches": [R.gcl_batch(41), R.gcl_batch(43)],
           "sgd_draws": [_gcl_draws(k) for k in sgd_keys], "lrs": LRS}
    torch.save(inp, tmp / "inputs.pt")
    spawn(R.parallel_cases, R.RANKS,
          (str(tmp / "inputs.pt"), str(tmp / "rank%d.pt")),
          join_timeout=JOIN_S)
    outs = [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(R.RANKS)]
    return inp, keys, outs


def _compare(out, grads, stats, metrics, names):
    got = out["grads"]
    want = _jax_tree(grads)
    assert got.keys() == want.keys()
    for k in want:
        assert_close_to_max(to_np(got[k]), want[k], REL, f"grad {k}")
    _, tstats = state_dict_to_flax(out["state"])
    got_s, want_s = flatten_tree(tstats), _jax_tree(stats)
    assert got_s.keys() == want_s.keys() and got_s
    for k in want_s:
        assert_close_to_max(got_s[k], want_s[k], REL, f"stat {k}")
    for k in names:
        np.testing.assert_allclose(float(out[k]), float(metrics[k]),
                                   rtol=REL, atol=REL, err_msg=k)


def _ranks_equal(outs, case):
    a, b = (o[case] for o in outs)
    for part in ("grads", "state"):
        for k in a[part]:
            assert torch.equal(a[part][k], b[part][k]), (case, part, k)


def test_gcl_global_grad_fn_matches_jax(ranks):
    inp, keys, outs = ranks
    jmodel = JBN2C(1, 16, bn_momentum=0.05, normalize_feature=True,
                   conv1_kernel_size=3, D=3)
    specs, cfg = R.gcl_setup(jsteps)
    grad_fn = jsteps.make_gcl_grad_fn(
        jmodel, jax_specs(specs), cfg, JGCLLossConfig(), "finest",
        max_pos_cluster=R.MAX_POS, max_hn_samples=R.MAX_HN, pos_weight=1.0,
        finest_weight=1.0, neg_weight=1.0, jitter=False)
    params, stats = state_dict_to_flax(inp["gcl_state"])
    grads, new_stats, metrics = jax.jit(j_global_grad_fn(
        grad_fn, make_mesh(R.RANKS)))(params, stats, keys["gcl"],
                                      *map(jnp.asarray, inp["gcl_batch"]))
    for r, out in enumerate(outs):
        m = out["gcl_metrics"]
        assert float(m["num_groups"]) > 0 and float(m["loss"]) > 1e-3
        _compare({**out["gcl"], **m}, grads, new_stats, metrics,
                 ("loss", "pos_loss", "finest_loss", "neg_loss",
                  "num_valid_voxels", "num_groups"))
    _ranks_equal(outs, "gcl")


def test_pair_global_grad_fn_matches_jax(ranks):
    inp, keys, outs = ranks
    jcls, _ = narrow_exp_classes()
    jmodel = jcls(1, 32, bn_momentum=0.05, normalize_feature=True,
                  conv1_kernel_size=5, D=3)
    specs, cfg = R.pair_setup(jsteps)
    grad_fn = jsteps.make_pair_grad_fn(jmodel, jax_specs(specs), cfg,
                                       "hardest_contrastive", R.PAIR_CFG)
    params, stats = state_dict_to_flax(inp["pair_state"])
    grads, new_stats, metrics = jax.jit(j_global_grad_fn(
        grad_fn, make_mesh(R.RANKS)))(params, stats, keys["pair"],
                                      *map(jnp.asarray, inp["pair_batch"]))
    for out in outs:
        m = out["pair_metrics"]
        assert float(m["loss"]) > 1e-3
        _compare({**out["pair"], **m}, grads, new_stats, metrics,
                 ("loss", "pos_loss", "neg_loss"))
    _ranks_equal(outs, "pair")


def _one_process(inp, n_steps, lrs, iter_size=1):
    """The data-parallel GCL steps run in this process: each rank's shard
    on a replica of its own, the shards' gradients and statistics
    averaged as the ranks average them, one SGD step a window."""
    models = [R.gcl_model() for _ in range(R.RANKS)]
    for m in models:
        m.load_state_dict(inp["gcl_state"])
    _, cfg = R.gcl_setup(tsteps)
    opts = [tsteps.make_optimizer(m.parameters(), cfg) for m in models]
    acc = None
    for i in range(n_steps):
        for r, m in enumerate(models):
            R.gcl_grad_fn(m)(*R.shard(inp["sgd_batches"][i], r),
                             draws=inp["sgd_draws"][i][r])
        with torch.no_grad():
            for ts in zip(*(list(p.grad for p in m.parameters())
                            + list(m.buffers()) for m in models)):
                mean = (ts[0] + ts[1]) / R.RANKS
                for t in ts:
                    t.copy_(mean)
        grads = [p.grad.clone() for p in models[0].parameters()]
        acc = (grads if acc is None
               else [a + g / iter_size for a, g in zip(acc, grads)])
        if iter_size > 1 and i == 0:
            acc = [g / iter_size for g in grads]
        if (i + 1) % iter_size == 0:
            for m, opt in zip(models, opts):
                for p, a in zip(m.parameters(), acc):
                    p.grad = a.clone()
                for group in opt.param_groups:
                    group["lr"] = lrs[i // iter_size]
                opt.step()
            acc = None
    return models[0].state_dict()


def test_sgd_steps_replicated_and_equal_one_process(ranks):
    """Two SGD steps on 2 ranks: parameters and running statistics bit-equal
    across the ranks, and equal to the steps in one process on the
    averaged shard gradients; AccumStepper at iter_size 2 likewise (one
    step on the mean of the two micro-batches' averaged gradients)."""
    inp, _, outs = ranks
    _ranks_equal(outs, "sgd")
    _ranks_equal(outs, "accum")
    want = _one_process(inp, 2, LRS)
    got = outs[0]["sgd"]["state"]
    moved = 0
    for k, v in want.items():
        assert_close_to_max(to_np(got[k]), to_np(v), 1e-6, k)
        moved += int(not torch.equal(v, inp["gcl_state"][k]))
    assert moved > 0.9 * len(want)
    want = _one_process(inp, 2, (LRS[0],), iter_size=2)
    for k, v in want.items():
        assert_close_to_max(to_np(outs[0]["accum"]["state"][k]), to_np(v),
                            1e-6, k)


class _Indices:
    def __len__(self):
        return 23

    def __getitem__(self, i):
        return {"i": np.int64(i)}


@pytest.mark.parametrize("batch,shards", [(4, 2), (6, 3), (8, 4)])
def test_loader_rank_slices_equal_gcl_tpu(batch, shards):
    """Every rank's batches equal gcl_tpu's shard_id slices over three
    shuffled epochs; together they partition the global batches."""
    for r in range(shards):
        ours = DataLoader(_Indices(), batch, shuffle=True, drop_last=True,
                          shard_id=r, num_shards=shards)
        ref = JLoader(_Indices(), batch, shuffle=True, drop_last=True,
                      shard_id=r, num_shards=shards)
        assert len(ours) == len(ref) == 23 // batch
        assert ours.batch_size == batch
        for _ in range(3):
            got = [b["i"].tolist() for b in ours]
            assert got == [b["i"].tolist() for b in ref]
            assert all(len(b) == batch // shards for b in got)
    whole = DataLoader(_Indices(), batch, shuffle=True, drop_last=True)
    parts = [DataLoader(_Indices(), batch, shuffle=True, drop_last=True,
                        shard_id=r, num_shards=shards) for r in range(shards)]
    for full, *sl in zip(whole, *parts):
        assert sum((s["i"].tolist() for s in sl), []) == full["i"].tolist()
    with pytest.raises(ValueError, match="divisible"):
        DataLoader(_Indices(), 5, shard_id=0, num_shards=2)


class _FastClock:
    """launch.time with a clock that runs an hour a second: a run of a few
    seconds outlives any deadline of hours."""

    @staticmethod
    def monotonic():
        return time.monotonic() * 3600.0


@pytest.mark.parametrize("join_timeout", [None, 3600.0])
def test_run_ranks_sets_no_deadline_by_default(join_timeout, tmp_path,
                                               monkeypatch):
    """run_ranks as the training entry point calls it (no join_timeout)
    waits for slow ranks as long as they run, here a sleep of 1.5 s on a
    clock where that is 1.5 hours; a deadline of an hour stops ranks that
    sleep a minute with TimeoutError and kills them."""
    monkeypatch.setattr(launch, "time", _FastClock)
    out = str(tmp_path / "rank%d")
    if join_timeout is None:
        run_ranks(R.slow_rank, R.RANKS, (1.5, out))
        for r in range(R.RANKS):
            with open(out % r) as f:
                assert f.read().endswith(" done")
        return
    with pytest.raises(TimeoutError, match="did not finish"):
        run_ranks(R.slow_rank, R.RANKS, (60.0, out),
                  join_timeout=join_timeout)
    for r in range(R.RANKS):
        if os.path.exists(out % r):  # the rank had started: it is gone
            with open(out % r) as f:
                pid = int(f.read().split()[0])
            with pytest.raises(ProcessLookupError):
                os.kill(pid, 0)


# --- the trainer and the entry point ------------------------------------

NV = 1024


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    """A synthetic drive of 32 frames: 4 training pairs (2 iterations of
    batch 2), with both packages' pair datasets pointed at its splits."""
    root = tmp_path_factory.mktemp("kitti")
    generate_synthetic_kitti(str(root), n_drives=1, n_frames=32, step=3.0)
    write_split_files(str(root / "config"), 1)
    files = {p: os.path.join(str(root), "config", f"{p}_kitti.txt")
             for p in ("train", "val", "test")}
    mp = pytest.MonkeyPatch()
    for cls in (JPairs, pairs.PairComplementKittiDataset):
        mp.setattr(cls, "DATA_FILES", files)
    yield root, files
    mp.undo()


def _written(run_dir):
    """The files a run wrote, but for tensorboardX's event files."""
    return sorted(f for f in os.listdir(run_dir)
                  if not f.startswith("events.out"))


def _dp_config(default, root, out_dir, **kw):
    cfg = default(
        kitti_root=str(root), out_dir=str(out_dir), voxel_size=0.3,
        point_capacity=8192, voxel_capacity=NV, nghb_point_capacity=8192,
        pair_min_dist=3, pair_max_dist=10, complement_pair_dist=3,
        num_complement_one_side=2, use_old_pose=False, batch_size=2,
        val_batch_size=1, max_epoch=1, val_max_iter=1,
        num_pos_per_batch=NV * 4, num_hn_samples_per_batch=NV,
        model="SimpleNetBNE", conv1_kernel_size=5, model_n_out=16,
        knn_chunk=256, corr_k=4, stat_freq=1, jitter_feats=False,
        use_random_rotation=False, use_random_scale=False,
        train_num_thread=0, val_num_thread=0, data_parallel="true",
        num_devices=2, trainer="HardestContrastiveLossTrainer",
        train_dataset="PairComplementKittiDataset")
    cfg.update(kw)
    return cfg


def _torchrun(argv, cwd):
    """``torchrun --standalone --nproc_per_node 2 -m gcl_tpu_torch.train
    *argv`` from ``cwd``; its whole process group killed if it outlives
    JOIN_S. Returns its output, asserting it exited with 0."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        p for p in (repo, os.environ.get("PYTHONPATH")) if p)}
    proc = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", str(R.RANKS), "-m", "gcl_tpu_torch.train",
         *argv], cwd=cwd, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True, start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=JOIN_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    assert proc.returncode == 0, out[-4000:]
    return out


def test_entry_point_epoch_matches_jax_trainer(synth_root, tmp_path,
                                               monkeypatch):
    """python -m gcl_tpu_torch.train --device cpu --data_parallel true
    --num_devices 2: one epoch of 2 iterations with validation on 2
    ranks. Rank 0 alone writes (one checkpoint set, one train/loss line a
    step); the parameters after the epoch within 1e-4 of each tensor's max
    of gcl_tpu's trainer with data_parallel=true, num_devices=2 from the
    same weights (gcl_tpu's trainer without validation). Then the same
    run under torchrun with --distributed_init true: the same files, and
    parameters within 1e-4 of the spawned run's."""
    root, _ = synth_root
    monkeypatch.chdir(root)  # the spawned ranks read ./config's splits
    init = random_state_dict(SimpleNetBNE(1, 16, conv1_kernel_size=5),
                             seed=7)
    weights = str(tmp_path / "init.pth")
    save_checkpoint(weights, epoch=0, state_dict=init, optimizer=None,
                    config={}, best_val=0.0, best_val_epoch=0,
                    best_val_metric="feat_match_ratio")

    jcfg = _dp_config(j_default_config, root, tmp_path / "jax")
    jtl = j_make_data_loader(jcfg, "train", 2)
    assert len(jtl) == 2
    variables = dict(zip(("params", "batch_stats"), (
        jax.tree_util.tree_map(jnp.asarray, t)
        for t in state_dict_to_flax(init))))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer_mod.AlignmentTrainer, "_init_variables",
                   lambda self, key: variables)
        jt = jtrainer_mod.get_trainer(jcfg.trainer)(jcfg, jtl, None)
    assert jt.mesh is not None and jt.shard_batch == 1
    np.random.seed(0)
    jt.train()

    argv = ["--device", "cpu", "--kitti_root", str(root), "--out_dir",
            str(tmp_path / "port"), "--weights", weights]
    for k in ("voxel_size", "point_capacity", "voxel_capacity",
              "nghb_point_capacity", "pair_min_dist", "pair_max_dist",
              "complement_pair_dist", "num_complement_one_side",
              "use_old_pose", "batch_size", "max_epoch", "val_max_iter",
              "num_pos_per_batch", "num_hn_samples_per_batch", "model",
              "conv1_kernel_size", "model_n_out", "knn_chunk", "corr_k",
              "stat_freq", "jitter_feats", "use_random_rotation",
              "use_random_scale", "train_num_thread", "val_num_thread",
              "data_parallel", "num_devices", "trainer", "train_dataset"):
        argv += [f"--{k}", str(jcfg[k]).lower() if isinstance(jcfg[k], bool)
                 else str(jcfg[k])]
    config, device = entry.parse_config(argv)
    assert entry.main(config, device) is None  # the ranks trained
    run = tmp_path / "port"
    assert _written(run) == ["best_val_checkpoint.pth", "checkpoint.pth",
                             "config.json", "scalars.jsonl"]
    with open(run / "scalars.jsonl") as f:
        tags = [line.split('"tag": "')[1].split('"')[0] for line in f]
    assert tags.count("train/loss") == 2 and "val/rte" in tags
    got = load_checkpoint(str(run / "checkpoint.pth"))["state_dict"]
    want = _jax_tree(jt.state.params)
    for k in want:
        assert not torch.equal(got[k], init[k]), k
        assert_close_to_max(to_np(got[k]), want[k], 1e-4, k)

    # the same run under torchrun: --distributed_init true joins the group
    # of its env:// variables (rank r on LOCAL_RANK r); rank 0 alone
    # writes, and the parameters agree with the spawned ranks' as those
    # agree with gcl_tpu's: torchrun's ranks take one thread each, the
    # spawned ones share the cores, the pools split the sums differently
    # and two steps of hardest-negative mining carry that rounding on
    tr = tmp_path / "torchrun"
    out = _torchrun([str(tr) if a == str(run) else a for a in argv]
                    + ["--distributed_init", "true"], root)
    assert "Data-parallel rank 1 of 2" in out
    assert _written(tr) == _written(run)
    with open(tr / "scalars.jsonl") as f:
        assert sum('"train/loss"' in line for line in f) == 2
    got_tr = load_checkpoint(str(tr / "checkpoint.pth"))["state_dict"]
    assert got_tr.keys() == got.keys()
    for k in got:
        assert_close_to_max(to_np(got_tr[k]), to_np(got[k]), 1e-4, k)
