"""The port's trainers and training entry point against gcl_tpu's, on a
synthetic mini-KITTI at tests/test_train.py:tiny_config's sizes, with a
narrow ResUNetFatBNEXP (tests/_torch_parity.py:narrow_exp_classes) put in
both packages' load_model by a test-side patch.

- get_trainer over the five names, the --conv_* setting that raises, and
  data_parallel over two CPU ranks (built in spawned gloo ranks, which
  validate without a barrier; an indivisible batch raises);
- a HardestContrastiveLossTrainer epoch with validation, both packages
  from the same seeded weights (models/weights.py:random_state_dict,
  carried into gcl_tpu's TrainState in place of its flax init, which also
  spares its init compile): gcl_tpu's trainer runs first, then the
  port's with the same batches (both datasets re-seeded) and the draws
  gcl_tpu's steps take from its TrainState key, replayed
  (tests/test_torch_pair_step.py says how). Each
  step's train/ scalars within 1e-5, the parameters after the epoch within
  1e-4 of each tensor's max, and the val/ scalars of the validation epoch
  (gcl_tpu's _valid_epoch against the port's, with gcl_tpu's subsample
  uniforms handed over) on a loader of clouds moved by whole voxels, where
  the two packages' features pick the same matches: hit ratio and the
  feature-match ratio equal, RTE, RRE and the loss within 1e-3. As in
  tests/test_torch_pair_step.py, the weights' seed is one where no ReLU
  input sits within float32 rounding of zero. From gcl_tpu's flax init
  one does, in the second step: +5.4e-6 in the port's float32 against
  -5.9e-7 in its float64 run (plain versions, the same draws), so the
  port's float32 parameters left float64's by up to 5e-3 of a tensor's
  max (block2_tr.conv1.kernel) while gcl_tpu's float32 stayed within
  1.2e-6 of them and every loss agreed within 1e-6; one step earlier all
  three agreed within 4e-6;
- the checkpoint: the port resumes from its own (weights, momentum
  buffers, epoch and best-val), loads gcl_tpu's through ``weights``, and
  refuses to resume from gcl_tpu's; the best-val rule with an exact tie;
- the colocation dataset against gcl_tpu's, sample for sample, a
  FinestContrastiveLossTrainer epoch of the port on it under
  --profile_dir, and --calc_distance_err;
- the entry point: ``python -m gcl_tpu_torch.train``'s main on the CPU
  writes checkpoint.pth and config.json, and --device cuda raises without
  a card.
"""
import json
import os

import jax
import numpy as np
import pytest
import torch

import gcl_tpu.train.trainer as jtrainer_mod
import gcl_tpu_torch.train.trainer as ttrainer_mod
from gcl_tpu.config import default_config as j_default_config
from gcl_tpu.data import make_data_loader as j_make_data_loader
from gcl_tpu.data.colocation import ColocationKittiDataset as JColoc
from gcl_tpu.data.pairs import PairComplementKittiDataset as JPairs
from gcl_tpu_torch.config import default_config
from gcl_tpu_torch.data import colocation, pairs
from gcl_tpu_torch.data.loader import make_data_loader
from gcl_tpu_torch.data.synthetic import (generate_synthetic_kitti,
                                          write_split_files)
from gcl_tpu_torch.models.weights import (flatten_tree, momentum_by_name,
                                          random_state_dict,
                                          state_dict_to_flax)
from gcl_tpu_torch.train import __main__ as entry
from gcl_tpu_torch.train.checkpoint import load_checkpoint
from gcl_tpu_torch.train.trainer import TRAINERS, get_trainer

from _torch_parity import (assert_close_to_max, clouds, narrow_exp_classes,
                           one_torch_thread,  # noqa: F401
                           replay_pair_step_draws, to_np)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NV = 2048
VAL_P = 1500


@pytest.fixture(scope="module")
def synth_env(tmp_path_factory):
    """A synthetic drive with its split files, both packages' datasets
    pointed at them, and the narrow EXP registered as 'NarrowEXP' in both
    load_models."""
    root = tmp_path_factory.mktemp("kitti")
    generate_synthetic_kitti(str(root), n_drives=1, n_frames=50, step=3.0)
    write_split_files(str(root / "config"), 1)
    files = {p: os.path.join(str(root), "config", f"{p}_kitti.txt")
             for p in ("train", "val", "test")}
    jcls, tcls = narrow_exp_classes()
    mp = pytest.MonkeyPatch()
    for cls in (JColoc, JPairs, colocation.ColocationKittiDataset,
                pairs.PairComplementKittiDataset):
        mp.setattr(cls, "DATA_FILES", files)
    mp.setattr(jtrainer_mod, "load_model", lambda name: jcls)
    mp.setattr(ttrainer_mod, "load_model", lambda name: tcls)
    yield root
    mp.undo()


def tiny_config(default_config, root, out_dir, **kw):
    """tests/test_train.py:tiny_config with the narrow EXP."""
    cfg = default_config(
        kitti_root=str(root), out_dir=str(out_dir),
        voxel_size=0.3, min_dist=3, max_dist=18, num_neighborhood=2,
        point_capacity=4096, voxel_capacity=NV, nghb_point_capacity=4096,
        pair_min_dist=3, pair_max_dist=10, complement_pair_dist=3,
        num_complement_one_side=2, use_old_pose=False,
        batch_size=2, val_batch_size=1, max_epoch=1, val_max_iter=2,
        num_pos_per_batch=64, num_hn_samples_per_batch=64,
        model="NarrowEXP", conv1_kernel_size=5, model_n_out=16,
        pos_pair_capacity=1 << 15, knn_chunk=256,
        hit_ratio_thresh=0.3, stat_freq=1,
        use_random_rotation=True, use_random_scale=True,
        train_num_thread=0, val_num_thread=0,
        trainer="HardestContrastiveLossTrainer",
        train_dataset="PairComplementKittiDataset")
    cfg.update(kw)
    return cfg


class _Batches:
    """A validation loader over fixed batches (the trainers read
    .dataset's length, .batch_size and iterate)."""

    def __init__(self, batches):
        self.batches, self.batch_size = batches, 1
        self.dataset = list(range(len(batches)))

    def __iter__(self):
        return iter(self.batches)

    def __len__(self):
        return len(self.batches)


def _val_batches():
    """Two pairs: a cloud and the same cloud moved by whole voxels (the
    same voxels, so the same features in each package)."""
    out = []
    for seed, shift in ((9, [0.6, -0.9, 0.3]), (10, [-0.3, 0.3, 0.0])):
        pts, pmask = clouds(seed, 1, VAL_P)
        trans = np.eye(4, dtype=np.float32)[None].copy()
        trans[0, :3, 3] = shift
        out.append({"points0": pts, "pmask0": pmask,
                    "points1": (pts + trans[:, None, :3, 3]).astype(
                        np.float32),
                    "pmask1": pmask.copy(), "trans": trans})
    return out


def _scalars(run_dir):
    """{tag: [values in order]} of a run directory's scalars.jsonl."""
    out = {}
    with open(os.path.join(run_dir, "scalars.jsonl")) as f:
        for line in f:
            r = json.loads(line)
            out.setdefault(r["tag"], []).append(r["value"])
    return out


def _val_draws(n_batches):
    """gcl_tpu's _valid_epoch subsample uniforms, per batch of one pair."""
    key, out = jax.random.PRNGKey(0), []
    for _ in range(n_batches):
        key, sub = jax.random.split(key)
        k0, k1 = jax.random.split(jax.random.split(sub, 1)[0])
        out.append([tuple(torch.from_numpy(np.array(
            jax.random.uniform(kk, (min(5000, NV),)))) for kk in (k0, k1))])
    return out


@pytest.mark.parametrize("name", sorted(TRAINERS))
def test_get_trainer_names(name):
    cls = get_trainer(name)
    assert cls.__name__ == name
    assert cls.__name__ in jtrainer_mod.TRAINERS


def test_get_trainer_unknown_and_unported_settings(synth_env, tmp_path,
                                                   monkeypatch):
    """An unknown trainer and the --conv_* knobs raise; data_parallel true
    over num_devices=2 builds the trainer on 2 CPU ranks (spawned, gloo):
    one sample a rank, one shard's capacities, its loader slice, rank 0's
    parameters on both ranks, every rank validating with no barrier and
    rank 0 alone writing; an indivisible batch raises ValueError; a
    trainer asked for data parallelism outside the ranks raises, and one
    told --data_parallel false inside a process group; no card for 'cuda'
    raises."""
    import _torch_ranks
    from gcl_tpu_torch.parallel import spawn
    from gcl_tpu_torch.parallel.launch import init_local_group

    with pytest.raises(ValueError, match="not found"):
        get_trainer("NoSuchTrainer")
    cfg = tiny_config(default_config, synth_env, tmp_path / "x")
    tl = make_data_loader(cfg, "train", 2)
    with pytest.raises(NotImplementedError, match="conv tuning"):
        get_trainer(cfg.trainer)(type(cfg)({**cfg, "conv_tile": 512}), tl,
                                 device="cpu")
    dp = type(cfg)({**cfg, "data_parallel": "true", "num_devices": 2,
                    "model": "ResUNetBN2C", "conv1_kernel_size": 3})
    with pytest.raises(RuntimeError, match="inside the ranks"):
        get_trainer(cfg.trainer)(dp, tl, device="cpu")
    init_local_group("gloo")  # a group of one: --data_parallel false there
    try:
        with pytest.raises(RuntimeError, match="inside a process group"):
            get_trainer(cfg.trainer)(type(cfg)({**cfg, "data_parallel":
                                                "false"}), tl, device="cpu")
    finally:
        torch.distributed.destroy_process_group()
    monkeypatch.chdir(synth_env)  # the ranks read ./config's split files
    spawn(_torch_ranks.build_trainer, 2, (dp, str(tmp_path / "r%d.pt")),
          join_timeout=120.0)
    got = [torch.load(tmp_path / f"r{r}.pt", weights_only=False)
           for r in range(2)]
    for r, g in enumerate(got):
        assert (g["data_parallel"], g["rank"], g["n_shards"],
                g["shard_batch"], g["loader_shard"]) == (True, r, 2, 1,
                                                         (r, 2))
        assert g["level_caps"][1] == NV  # one shard's capacity
    # each rank drew its own initial weights; both hold rank 0's
    for k, v in got[0]["params"].items():
        assert torch.equal(got[1]["params"][k], v), k
    # both ranks validated each epoch; rank 0 alone wrote the run
    # directory (the second epoch's equal record saves the newest too)
    assert [g["validated"] for g in got] == [2, 2]
    assert sorted(f for f in os.listdir(tmp_path / "x")
                  if not f.startswith("events.out")) == [
        "best_val_checkpoint.pth", "best_val_newest_checkpoint.pth",
        "checkpoint.pth", "config.json", "scalars.jsonl"]
    odd = type(cfg)({**dp, "batch_size": 3})
    with pytest.raises(ValueError, match="not divisible"):
        get_trainer(cfg.trainer)(odd, make_data_loader(odd, "train", 3),
                                 device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            get_trainer(cfg.trainer)(cfg, tl)


@pytest.fixture(scope="module")
def fcgf_epoch(synth_env, tmp_path_factory):
    """gcl_tpu's and the port's HardestContrastiveLossTrainer after one
    epoch with validation, from the same weights and draws."""
    tmp = tmp_path_factory.mktemp("fcgf")
    val = _Batches(_val_batches())
    _, tcls = narrow_exp_classes()
    init = random_state_dict(tcls(1, 16, conv1_kernel_size=5), seed=3)
    variables = dict(zip(("params", "batch_stats"), (
        jax.tree_util.tree_map(jax.numpy.asarray, t)
        for t in state_dict_to_flax(init))))
    jcfg = tiny_config(j_default_config, synth_env, tmp / "jax")
    jtl = j_make_data_loader(jcfg, "train", 2)
    jtl.dataset.files = jtl.dataset.files[:4]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtrainer_mod.AlignmentTrainer, "_init_variables",
                   lambda self, key: variables)
        jt = jtrainer_mod.get_trainer(jcfg.trainer)(jcfg, jtl, val)
    rng0 = jt.state.rng
    jtl.dataset.reset_seed(0)
    np.random.seed(0)
    jt.train()

    tcfg = tiny_config(default_config, synth_env, tmp / "port")
    ttl = make_data_loader(tcfg, "train", 2)
    ttl.dataset.files = ttl.dataset.files[:4]
    tt = get_trainer(tcfg.trainer)(tcfg, ttl, val, device="cpu")
    tt.model.load_state_dict(init)
    step_fn, rng = tt.step_fn, [rng0]

    def replayed(lr, *batch, generator=None):
        rng[0], k = jax.random.split(rng[0])
        return step_fn(lr, *batch, draws=replay_pair_step_draws(
            k, 2, 2 * NV, 2 * NV * 8, num_pos=64 * 2, num_hn=64 * 2))

    tt.step_fn = replayed
    valid, vdraws = tt._valid_epoch, _val_draws(len(val))
    tt._valid_epoch = lambda: valid(draws=lambda i: vdraws[i])
    ttl.dataset.reset_seed(0)
    np.random.seed(0)
    tt.train()
    return jt, tt, tmp


def test_fcgf_epoch_matches_jax(fcgf_epoch):
    jt, tt, tmp = fcgf_epoch
    js, ts = _scalars(tmp / "jax"), _scalars(tmp / "port")
    assert sorted(ts) == sorted(js)
    for tag in ("train/loss", "train/pos_loss", "train/neg_loss"):
        assert len(ts[tag]) == len(js[tag]) == 2, tag
        np.testing.assert_allclose(ts[tag], js[tag], rtol=0, atol=1e-5,
                                   err_msg=tag)
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, jt.state.params))
    for name, p in tt.model.named_parameters():
        assert_close_to_max(to_np(p), want[name], 1e-4, name)
    for tag in ("val/hit_ratio", "val/feat_match_ratio"):
        assert ts[tag] == js[tag], tag
    assert js["val/hit_ratio"][0] > 0.2
    for tag in ("val/rte", "val/rre", "val/loss"):
        np.testing.assert_allclose(ts[tag], js[tag], rtol=0, atol=1e-3,
                                   err_msg=tag)
    for f in ("checkpoint.pth", "best_val_checkpoint.pth", "config.json"):
        assert os.path.exists(tmp / "port" / f), f
    with open(tmp / "port" / "config.json") as f:
        assert json.load(f)["trainer"] == "HardestContrastiveLossTrainer"


def test_checkpoint_resume_round_trip(fcgf_epoch, synth_env, tmp_path):
    """Resume from the port's checkpoint.pth: weights, BN stats, momentum
    buffers, epoch and best-val as saved; gcl_tpu's checkpoint loads
    through ``weights`` and is refused by ``resume``."""
    jt, tt, tmp = fcgf_epoch
    ck = str(tmp / "port" / "checkpoint.pth")
    state = load_checkpoint(ck)
    assert state["epoch"] == 1 and state["best_val_epoch"] == -(2 ** 31)
    cfg = tiny_config(default_config, synth_env, tmp_path / "resumed",
                      resume=ck, max_epoch=2)
    tl = make_data_loader(cfg, "train", 2)
    t2 = get_trainer(cfg.trainer)(cfg, tl, None, device="cpu")
    assert t2.start_epoch == 1
    for k, v in tt.model.state_dict().items():
        assert torch.equal(t2.model.state_dict()[k], v), k
    mom, mom2 = (momentum_by_name(t.model, t.opt) for t in (tt, t2))
    for k, v in mom.items():
        assert torch.equal(mom2[k], v), k
    best = load_checkpoint(str(tmp / "port" / "best_val_checkpoint.pth"))
    assert best["best_val"] == tt.best_val == 1.0
    assert best["best_val_epoch"] == 1

    jck = str(tmp / "jax" / "checkpoint.pth")
    cfg_w = tiny_config(default_config, synth_env, tmp_path / "w",
                        weights=jck)
    t3 = get_trainer(cfg.trainer)(cfg_w, tl, None, device="cpu")
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, jt.state.params))
    for name, p in t3.model.named_parameters():
        np.testing.assert_array_equal(to_np(p), want[name])
    cfg_r = tiny_config(default_config, synth_env, tmp_path / "r",
                        resume=jck)
    with pytest.raises(ValueError, match="--weights"):
        get_trainer(cfg.trainer)(cfg_r, tl, None, device="cpu")


def test_best_val_keeps_the_first_of_exact_ties(synth_env, tmp_path):
    """The best-val rule over three epochs whose validation reads 1.0, 1.0,
    0.5: epoch 1 saves best_val_checkpoint, the exact tie of epoch 2 saves
    best_val_newest_checkpoint and keeps epoch 1 as the best, epoch 3
    saves neither; the val/ scalars are written every epoch."""
    cfg = tiny_config(default_config, synth_env, tmp_path / "ties",
                      max_epoch=3)
    tl = make_data_loader(cfg, "train", 2)
    t = get_trainer(cfg.trainer)(cfg, tl, _Batches([]), device="cpu")
    reads = iter((1.0, 1.0, 0.5))
    t._train_epoch = lambda epoch: None
    t._valid_epoch = lambda: dict(feat_match_ratio=next(reads), rte=0.1)
    t.train()
    assert (t.best_val, t.best_val_epoch) == (1.0, 1)
    for name, epoch in (("best_val_checkpoint", 1),
                        ("best_val_newest_checkpoint", 2),
                        ("checkpoint", 3)):
        state = load_checkpoint(str(tmp_path / "ties" / f"{name}.pth"))
        assert state["epoch"] == epoch, name
    assert _scalars(tmp_path / "ties")["val/feat_match_ratio"] == [1.0, 1.0,
                                                                  0.5]


def test_colocation_dataset_matches_jax(synth_env):
    """The port's ColocationKittiDataset: the same frame index and, from
    the same seeds, the same sample arrays as gcl_tpu's."""
    kw = dict(random_rotation=True, random_scale=True)
    cfg = tiny_config(default_config, synth_env, "unused")
    jcfg = tiny_config(j_default_config, synth_env, "unused")
    np.random.seed(0)
    ours = colocation.ColocationKittiDataset("train", config=cfg, **kw)
    np.random.seed(0)
    ref = JColoc("train", config=jcfg, **kw)
    assert ours.files == ref.files and len(ours) >= 2
    for i in range(2):
        out = []
        for ds in (ours, ref):
            ds.reset_seed(i)
            np.random.seed(i)
            out.append(ds[i])
        assert out[0].keys() == out[1].keys()
        for k in ("points", "pmask", "transforms", "search_radius"):
            np.testing.assert_array_equal(out[0][k], out[1][k], err_msg=k)
        assert out[0]["points"].shape == (3, 4096, 3)


def test_finest_trainer_epoch(synth_env, tmp_path):
    """FinestContrastiveLossTrainer on the colocation loader: one epoch of
    two GCL steps under --profile_dir; finite losses logged, parameters
    moved, checkpoint written, the epoch's torch.profiler trace with the
    step's gcl/ ranges."""
    cfg = tiny_config(default_config, synth_env, tmp_path / "gcl",
                      trainer="FinestContrastiveLossTrainer",
                      train_dataset="ColocationKittiDataset",
                      finest_weight=1.0, batch_size=1,
                      profile_dir=str(tmp_path / "prof"))
    tl = make_data_loader(cfg, "train", 1)
    tl.dataset.files = tl.dataset.files[:2]
    t = get_trainer(cfg.trainer)(cfg, tl, None, device="cpu")
    assert t.loss_kind == "finest" and t.clouds_per_sample == 3
    before = {k: v.clone() for k, v in t.model.state_dict().items()}
    t.train()
    s = _scalars(tmp_path / "gcl")
    assert len(s["train/loss"]) == 2 and np.isfinite(s["train/loss"]).all()
    assert any(not torch.equal(v, before[k])
               for k, v in t.model.state_dict().items())
    assert os.path.exists(tmp_path / "gcl" / "checkpoint.pth")
    with open(tmp_path / "prof" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"gcl/unet", "gcl/loss", "gcl/sgd"} <= names


def test_calc_distance_err_dumps_and_aborts(synth_env, tmp_path):
    """--calc_distance_err: eval-mode diagnostics over the colocation
    loader, dist_err_normal.npz written, then ValueError, as gcl_tpu's
    trainer does."""
    cfg = tiny_config(default_config, synth_env, tmp_path / "derr",
                      trainer="FinestContrastiveLossTrainer",
                      train_dataset="ColocationKittiDataset",
                      finest_weight=1.0, batch_size=1,
                      calc_distance_err=True)
    tl = make_data_loader(cfg, "train", 1)
    tl.dataset.files = tl.dataset.files[:2]
    t = get_trainer(cfg.trainer)(cfg, tl, None, device="cpu")
    with pytest.raises(ValueError, match="calc_distance_err"):
        t.train()
    data = np.load(tmp_path / "derr" / "dist_err_normal.npz")
    assert len(data["distance"]) == len(data["err"]) > 0
    assert np.isfinite(data["err"]).all()


def test_entry_point_main_on_cpu(synth_env, tmp_path, monkeypatch):
    """python -m gcl_tpu_torch.train's flags, resume merge and main: an
    epoch on the CPU with validation writes checkpoint.pth, config.json
    and scalars; --resume_dir takes the run's own config.json; --device
    cuda raises without a card."""
    run = tmp_path / "run"
    argv = ["--device", "cpu", "--kitti_root", str(synth_env),
            "--out_dir", str(run), "--trainer",
            "HardestContrastiveLossTrainer", "--model", "NarrowEXP",
            "--conv1_kernel_size", "5", "--model_n_out", "16",
            "--train_dataset", "PairComplementKittiDataset",
            "--voxel_size", "0.3", "--batch_size", "2", "--max_epoch", "1",
            "--point_capacity", "4096", "--voxel_capacity", str(NV),
            "--pair_min_dist", "3", "--pair_max_dist", "10",
            "--complement_pair_dist", "3", "--num_complement_one_side", "2",
            "--use_old_pose", "false", "--val_max_iter", "1",
            "--num_pos_per_batch", "64", "--num_hn_samples_per_batch", "64",
            "--train_num_thread", "0", "--val_num_thread", "0"]
    config, device = entry.parse_config(argv)
    assert device == "cpu" and config.model == "NarrowEXP"
    real = make_data_loader

    def short(config, phase, batch_size, num_threads=0, shuffle=None,
              shard=(0, 1)):
        loader = real(config, phase, batch_size, num_threads, shuffle, shard)
        loader.dataset.files = loader.dataset.files[:2]
        return loader

    monkeypatch.setattr(entry, "make_data_loader", short)
    trainer = entry.main(config, device)
    for f in ("checkpoint.pth", "config.json", "scalars.jsonl"):
        assert os.path.exists(run / f), f
    assert np.isfinite(_scalars(run)["train/loss"]).all()
    assert trainer.device == torch.device("cpu")
    resumed, _ = entry.parse_config(["--resume_dir", str(run),
                                     "--max_epoch", "5"])
    assert resumed.resume == os.path.join(str(run), "checkpoint.pth")
    assert resumed.max_epoch == 1 and resumed.model == "NarrowEXP"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            entry.main(entry.parse_config(argv[2:])[0])
