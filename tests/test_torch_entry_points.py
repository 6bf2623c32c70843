"""The port's entry points against gcl_tpu's root scripts, on the CPU:
python -m gcl_tpu_torch.demo against demo.py, .eval_eth against
generalization_ETH/evaluate.py, .sc2_pcr.test_kitti (and its shims)
against scripts/SC2_PCR/test_KITTI.py, each script loaded by path and
fed the same files.

- Demo: both read one gcl_tpu checkpoint, whose weights are gcl_tpu's
  import of a synthetic MinkowskiEngine .pth; the written .ply's points
  are equal bit for bit, the features (captured where each hands them to
  get_colored_point_cloud_feature_ply) within 1e-4 of their max, and the
  port's own import of the .pth, through the port's model, gives
  gcl_tpu's features within 1e-5. Colours are not compared: gcl_tpu's
  t-SNE is Barnes-Hut, the port's exact (tests/test_torch_utils.py holds
  the port's to scikit-learn's exact method).
- ETH: random weights tie some voxels' features to float32 rounding, so
  gcl_tpu's evaluation is handed the port's features (after its own are
  checked within 1e-4 of them), and the port is handed gcl_tpu's RANSAC
  samples, replayed from PRNGKey(0)'s splits: mutual pairs and inlier
  ratios equal exactly, poses within 1e-3, RR equal.
- SC2-PCR: num_node "all" (no node subset is drawn), RR and F1 equal, TE
  within 1e-2 cm and RE's cosine within 1e-6 (as in
  tests/test_torch_eval_kitti.py: SC2-PCR's hard thresholds flip at
  float32 rounding, and near 0 deg arccos magnifies the cosine's
  rounding).
"""
import argparse
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import gcl_tpu.reg
import gcl_tpu.utils.misc
import gcl_tpu.utils.visualization
from gcl_tpu.models import load_model as j_load_model
from gcl_tpu.train.checkpoint import save_checkpoint as j_save_checkpoint
from gcl_tpu.train.import_torch import \
    load_torch_checkpoint as j_load_torch_checkpoint
from gcl_tpu_torch import demo, eval_eth
from gcl_tpu_torch.data import posegraph
from gcl_tpu_torch.models import load_model
from gcl_tpu_torch.models.weights import random_state_dict, state_dict_to_flax
from gcl_tpu_torch.reg.ransac import ransac_pose
from gcl_tpu_torch.sc2_pcr import test_3dlomatch, test_3dmatch, test_kitti
from gcl_tpu_torch.train import import_torch
from gcl_tpu_torch.utils.misc import extract_features
from gcl_tpu_torch.utils.pointcloud import read_ply_xyz, write_ply_xyz

from _torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread",
                                     "quick_jax_compiles")


@pytest.fixture(scope="module")
def quick_jax_compiles():
    """The root scripts compile ~700 eager JAX ops on small inputs, most
    of this file's time: XLA's optimization passes off for this module
    (restored after it) take a fifth of it off. The comparisons below
    hold either way."""
    before = jax.config.read("jax_disable_most_optimizations")
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SC2_CONFIGS = os.path.join(REPO, "scripts", "SC2_PCR", "config_json")


def _script(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bn2c(seed: int):
    """tests/test_demo.py's model (ResUNetBN2C, 16 out, conv1 k = 3) with
    seeded weights."""
    model = load_model("ResUNetBN2C")(1, 16, bn_momentum=0.05,
                                      normalize_feature=True,
                                      conv1_kernel_size=3, D=3)
    model.load_state_dict(random_state_dict(model, seed))
    return model


def _save_j_checkpoint(path, params, stats):
    j_save_checkpoint(path, epoch=0, params=params, batch_stats=stats,
                      opt_state={}, config={}, best_val=0,
                      best_val_epoch=0, best_val_metric="x")


def _capture(monkeypatch, module, store):
    real = module.get_colored_point_cloud_feature_ply

    def capture(xyz, feature, path, voxel_size=0.025):
        store.append((np.asarray(torch.as_tensor(xyz).cpu()),
                      np.asarray(torch.as_tensor(feature).cpu())))
        return real(xyz, feature, path, voxel_size)

    monkeypatch.setattr(module, "get_colored_point_cloud_feature_ply",
                        capture)


def test_demo_matches_root_demo(tmp_path, monkeypatch):
    # a part of the demo's synthetic scan, so both t-SNEs stay small
    xyz = demo.synthetic_scan()
    xyz = xyz[(np.abs(xyz[:, :2]) < 9).all(1)]
    cloud = str(tmp_path / "cloud.ply")
    write_ply_xyz(cloud, xyz)
    me = str(tmp_path / "me.pth")
    torch.save({"state_dict": import_torch.export_state_dict(
        _bn2c(7).state_dict())}, me)
    params, stats, _ = j_load_torch_checkpoint(me)
    ckpt = str(tmp_path / "weights.ckpt")
    _save_j_checkpoint(ckpt, params, stats)

    root_demo = _script("demo.py", "root_demo")
    captured = {"ref": [], "ours": []}
    _capture(monkeypatch, gcl_tpu.utils.visualization, captured["ref"])
    _capture(monkeypatch, demo, captured["ours"])
    out = {k: str(tmp_path / f"{k}.ply") for k in captured}
    root_demo.main(argparse.Namespace(
        input=cloud, output=out["ref"], weights=ckpt, model="ResUNetBN2C",
        model_n_out=16, voxel_size=0.3, conv1_kernel_size=3))
    stats = demo.main(["--input", cloud, "--output", out["ours"],
                       "--weights", ckpt, "--model_n_out", "16",
                       "--conv1_kernel_size", "3", "--device", "cpu"])
    ref_xyz, ref_f = captured["ref"][0]
    our_xyz, our_f = captured["ours"][0]
    assert stats["n_voxels"] == len(ref_f) > 200
    np.testing.assert_array_equal(read_ply_xyz(out["ours"]),
                                  read_ply_xyz(out["ref"]))
    np.testing.assert_array_equal(our_xyz, ref_xyz)
    assert our_f.dtype == np.float64
    np.testing.assert_allclose(our_f, ref_f, rtol=0,
                               atol=1e-4 * np.abs(ref_f).max())

    model = load_model("ResUNetBN2C")(1, 16, bn_momentum=0.05,
                                      normalize_feature=True,
                                      conv1_kernel_size=3, D=3)
    model.load_state_dict(import_torch.load_torch_checkpoint(me)[0])
    _, f = extract_features(model, xyz, voxel_size=0.3, device="cpu")
    np.testing.assert_allclose(f.numpy(), ref_f, rtol=0, atol=1e-5)


def test_extract_features_input_rules_match_gcl_tpu():
    """extract_features on rgb and normals ([rgb - 0.5, normal / 2] on a
    6-channel model) within 1e-5 of gcl_tpu's, and both range checks."""
    rng = np.random.RandomState(5)
    xyz = demo.synthetic_scan()[:900]
    rgb, normal = rng.rand(len(xyz), 3), rng.rand(len(xyz), 3) * 2 - 1
    model = load_model("ResUNetBN2C")(6, 16, bn_momentum=0.05,
                                      normalize_feature=True,
                                      conv1_kernel_size=3, D=3)
    state = random_state_dict(model, 6)
    model.load_state_dict(state)
    jmodel = j_load_model("ResUNetBN2C")(6, 16, bn_momentum=0.05,
                                         normalize_feature=True,
                                         conv1_kernel_size=3, D=3)
    v, f = extract_features(model, xyz, rgb, normal, 0.3, "cpu")
    jv, jf = gcl_tpu.utils.misc.extract_features(
        jmodel, *state_dict_to_flax(state), xyz, rgb, normal, 0.3)
    np.testing.assert_array_equal(v.numpy(), jv)
    np.testing.assert_allclose(f.numpy(), jf, rtol=0, atol=1e-5)
    for bad in (dict(rgb=rgb + 1), dict(normal=normal + 2)):
        with pytest.raises(ValueError):
            extract_features(model, xyz, voxel_size=0.3, device="cpu",
                             **bad)


@pytest.fixture
def eth_scene(tmp_path):
    """tests/test_eth.py's scene: two fragments of one structured cloud
    under a known rigid transform, the same 120 keypoint indices."""
    rng = np.random.RandomState(0)
    scene = tmp_path / "eth" / "gazebo_summer"
    (scene / "Keypoints").mkdir(parents=True)
    x0 = np.concatenate([
        rng.rand(400, 3) * [4, 4, 0.1],
        rng.rand(200, 3) * [0.5, 0.5, 2] + [1, 1, 0],
        rng.rand(200, 3) * [0.5, 2, 1.5] + [2.5, 0.5, 0],
    ]).astype(np.float32)
    th = 0.4
    r_mat = np.array([[np.cos(th), -np.sin(th), 0],
                      [np.sin(th), np.cos(th), 0], [0, 0, 1]], np.float32)
    t_vec = np.array([0.7, -0.4, 0.15], np.float32)
    x1 = (x0 - t_vec) @ r_mat
    gt = np.eye(4)
    gt[:3, :3] = r_mat
    gt[:3, 3] = t_vec
    write_ply_xyz(str(scene / "Hokuyo_0.ply"), x0)
    write_ply_xyz(str(scene / "Hokuyo_1.ply"), x1.astype(np.float32))
    kp_idx = rng.choice(len(x0), 120, replace=False)
    for i in (0, 1):
        np.savetxt(str(scene / "Keypoints" / f"Hokuyo_{i}_Keypoints.txt"),
                   kp_idx, fmt="%d")
    with open(scene / "gt.log", "w") as f:
        f.write("0\t1\t2\n")
        for r in range(4):
            f.write("\t".join(str(gt[r, c]) for c in range(4)) + "\n")
    return tmp_path / "eth", gt


def test_eth_matches_root_evaluate(eth_scene, tmp_path, monkeypatch,
                                   capsys):
    root, gt = eth_scene
    model = _bn2c(8)
    ckpt = str(tmp_path / "rand.ckpt")
    _save_j_checkpoint(ckpt, *state_dict_to_flax(model.state_dict()))

    real_extract = gcl_tpu.utils.misc.extract_features

    def ports_features(jmodel, params, stats, xyz, voxel_size):
        jv, jf = real_extract(jmodel, params, stats, xyz,
                              voxel_size=voxel_size)
        v, f = extract_features(model, xyz, voxel_size=voxel_size,
                                device="cpu")
        np.testing.assert_array_equal(v.numpy(), jv)
        np.testing.assert_allclose(f.numpy(), jf, rtol=0, atol=1e-4)
        return v.numpy(), f.numpy()

    monkeypatch.setattr(gcl_tpu.utils.misc, "extract_features",
                        ports_features)
    j_pairs = []
    real_ransac = gcl_tpu.reg.ransac_pose

    def j_ransac(src, tgt, key, *a, **kw):
        j_pairs.append(np.asarray(src))
        return real_ransac(src, tgt, key, *a, **kw)

    monkeypatch.setattr(gcl_tpu.reg, "ransac_pose", j_ransac)
    ev = _script("generalization_ETH/evaluate.py", "root_eth")
    monkeypatch.setattr(ev, "SCENE_LIST", ["gazebo_summer"])
    flags = ["--eth_root", str(root), "--checkpoint", ckpt, "--model",
             "ResUNetBN2C", "--model_n_out", "16", "--conv1_kernel_size",
             "3", "--voxel_size", "0.12"]
    monkeypatch.setattr("sys.argv", ["evaluate.py", "--log_dir",
                                     str(tmp_path / "ref")] + flags)
    ev.main()
    ref_out = capsys.readouterr().out

    key = [jax.random.PRNGKey(0)]
    p_pairs = []

    def replayed(src, tgt, thr, *, generator, num_hypotheses, sample_size):
        """gcl_tpu's minimal samples for this pair, drawn as its
        ransac_pose draws them from the next split of PRNGKey(0)."""
        key[0], sub = jax.random.split(key[0])
        draws = jax.random.randint(sub, (num_hypotheses, sample_size), 0,
                                   jnp.int32(2 ** 30)) % src.shape[0]
        p_pairs.append(src.numpy())
        return ransac_pose(src, tgt, thr, samples=torch.from_numpy(
            np.asarray(draws)), sample_size=sample_size)

    monkeypatch.setattr(eval_eth, "ransac_pose", replayed)
    res = eval_eth.main(flags + ["--log_dir", str(tmp_path / "ours"),
                                 "--device", "cpu"],
                        scenes=["gazebo_summer"])
    our_out = capsys.readouterr().out
    np.testing.assert_array_equal(p_pairs[0], j_pairs[0])  # mutual pairs
    scene = res["scenes"]["gazebo_summer"]
    (pair,) = scene["pairs"]
    assert pair["n_mutual"] == len(j_pairs[0]) > 20
    ratio = float(ref_out.split("inlier ratio ")[1].split(",")[0])
    assert f"inlier ratio {pair['inlier_ratio']:.4f}" in our_out
    assert round(pair["inlier_ratio"], 4) == ratio
    logs = [np.loadtxt(tmp_path / d / "est_gazebo_summer.log", skiprows=1)
            for d in ("ref", "ours")]
    np.testing.assert_allclose(logs[1], logs[0], rtol=0, atol=1e-3)
    np.testing.assert_allclose(pair["transform"], logs[0], rtol=0,
                               atol=1e-3)
    ref_rr = float(ref_out.split("registration recall ")[1].split("%")[0])
    assert scene["rr"] == ref_rr and res["rr"] == ref_rr
    assert pair["registered"] and pair["rte"] < 0.3
    assert set(pair["stage_ms"]) == set(eval_eth.STAGES)


def _sc2_pair(rng, n=400):
    """tests/test_sc2pcr_loaders.py's pair: a cloud and its rigid
    transform, identical unit descriptors."""
    xyz0 = (rng.rand(n, 3) * [8, 8, 3]).astype(np.float32)
    th = 0.5
    r = np.array([[np.cos(th), -np.sin(th), 0],
                  [np.sin(th), np.cos(th), 0], [0, 0, 1]], np.float32)
    t = np.array([1.0, -2.0, 0.3], np.float32)
    gt = np.eye(4, dtype=np.float32)
    gt[:3, :3] = r
    gt[:3, 3] = t
    feat = rng.randn(n, 16).astype(np.float32)
    feat /= np.linalg.norm(feat, axis=1, keepdims=True)
    return xyz0, xyz0 @ r.T + t, feat, feat.copy(), gt


@pytest.fixture
def sc2_roots(tmp_path):
    """A 3DMatch root (gt_result/<scene>-evaluation/*.npz) and two KITTI
    roots (fcgf_test/*.npz, FCGF's key names), two pairs each. In the
    3DMatch root a third of the second pair's descriptors are random unit
    vectors. The first KITTI root has no such outliers; the second
    ("KITTI outliers") holds the same arrays with the 3DMatch root's
    random third: config_KITTI.json refines over the inliers within
    1.2 m, and a random match whose residual lies within float32 rounding
    of that may flip between the packages
    (test_sc2pcr_kitti_with_outliers_matches_root)."""
    rng = np.random.RandomState(0)
    threed = tmp_path / "3dmatch"
    (threed / "fragments" / "7-scenes-redkitchen").mkdir(parents=True)
    gt_dir = threed / "gt_result" / "7-scenes-redkitchen-evaluation"
    gt_dir.mkdir(parents=True)
    kitti = tmp_path / "kitti" / "fcgf_test"
    kitti.mkdir(parents=True)
    outliers = tmp_path / "kitti_outliers" / "fcgf_test"
    outliers.mkdir(parents=True)
    for i in range(2):
        xyz0, xyz1, f0, f1, gt = _sc2_pair(rng)
        np.savez(kitti / f"pair_{i}.npz", xyz0=xyz0, xyz1=xyz1,
                 features0=f0, features1=f1, gt_trans=gt)
        if i:
            noise = rng.randn(len(f1[::3]), 16)
            f1[::3] = noise / np.linalg.norm(noise, axis=1, keepdims=True)
        np.savez(gt_dir / f"pair_{i}.npz", xyz0=xyz0, xyz1=xyz1, feat0=f0,
                 feat1=f1, gt_trans=gt)
        np.savez(outliers / f"pair_{i}.npz", xyz0=xyz0, xyz1=xyz1,
                 features0=f0, features1=f1, gt_trans=gt)
    return {"3DMatch": (threed, "config_3DMatch.json"),
            "KITTI": (tmp_path / "kitti", "config_KITTI.json"),
            "KITTI outliers": (tmp_path / "kitti_outliers",
                               "config_KITTI.json")}


@pytest.mark.parametrize("dataset", ["3DMatch", "KITTI"])
def test_sc2pcr_benchmark_matches_root(sc2_roots, tmp_path, monkeypatch,
                                    dataset):
    root, name = sc2_roots[dataset]
    with open(os.path.join(SC2_CONFIGS, name)) as f:
        cfg = json.load(f)
    cfg.update(num_node="all", max_points=500)
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    flags = ["--config_path", cfg_path, "--data_root", str(root)]
    root_bench = _script("scripts/SC2_PCR/test_KITTI.py", "root_sc2")
    monkeypatch.setattr("sys.argv", ["test_KITTI.py"] + flags)
    ref = root_bench.main()
    got = test_kitti.main(flags + ["--device", "cpu"])
    assert got["RR"] == ref["RR"] == 100.0
    assert got["F1"] == ref["F1"] and 0.5 < got["F1"] <= 1.0
    assert got["TE"] == pytest.approx(ref["TE"], abs=1e-2)
    # near 0 deg arccos turns float32 rounding of the cosine into
    # hundredths of a degree: the cosines within 1e-6
    assert np.cos(np.radians(got["RE"])) == pytest.approx(
        np.cos(np.radians(ref["RE"])), abs=1e-6)
    assert got["ms_per_pair"] > 0
    if dataset == "3DMatch":  # the shims read their own configs
        for shim in (test_3dmatch, test_3dlomatch):
            stats = shim.main(["--data_root", str(root), "--device",
                               "cpu"])
            assert stats["RR"] == 100.0


def _record_refinement(monkeypatch, jsc, tsc):
    """Record, in each package's post_refinement, every round's pose (the
    argument of transform) and inlier weights (the argument of
    rigid_transform_3d: w > 0 exactly on the matches within 1.2 m).
    gcl_tpu's rounds run inside its jitted SC2_PCR: ordered debug
    callbacks hand their values out as they run. Returns {"ref": [...],
    "ours": [...]}, each a list of ("T" | "w", array) in call order (per
    pair: 20 rounds of T then w, then the estimator's final T)."""
    rec = {"ref": [], "ours": []}
    j_rigid, j_transform = jsc.rigid_transform_3d, jsc.transform
    t_rigid, t_transform = tsc.rigid_transform_3d, tsc.transform

    def keep(kind):
        return lambda a: rec["ref"].append((kind, np.asarray(a)[0].copy()))

    def j_rigid_rec(src, tgt, w):
        if w.ndim == 2 and w.shape[0] == 1:  # a refinement round, bs 1
            jax.debug.callback(keep("w"), w, ordered=True)
        return j_rigid(src, tgt, w)

    def j_transform_rec(pts, trans):
        jax.debug.callback(keep("T"), trans, ordered=True)
        return j_transform(pts, trans)

    def t_rigid_rec(src, tgt, w):
        if w.dim() == 2 and w.shape[0] == 1:
            rec["ours"].append(("w", w[0].cpu().numpy().copy()))
        return t_rigid(src, tgt, w)

    def t_transform_rec(pts, trans):
        rec["ours"].append(("T", trans[0].cpu().numpy().copy()))
        return t_transform(pts, trans)

    monkeypatch.setattr(jsc, "rigid_transform_3d", j_rigid_rec)
    monkeypatch.setattr(jsc, "transform", j_transform_rec)
    monkeypatch.setattr(tsc, "rigid_transform_3d", t_rigid_rec)
    monkeypatch.setattr(tsc, "transform", t_transform_rec)
    return rec


def test_sc2pcr_kitti_with_outliers_matches_root(sc2_roots, tmp_path,
                                                 monkeypatch):
    """config_KITTI.json's outlier path: a third of the second pair's
    descriptors are random, so its matches hold outliers at every
    residual, some near the refinement's 1.2 m.

    In every one of the 20 refinement rounds of each pair, the two
    packages' inlier sets may differ only on matches whose residual is
    within float32 rounding of 1.2 m: in float64, from the float32
    coordinates and each package's own pose of that round, both residuals
    lie within 8 float32 epsilons of |src| + |t| + |tgt| (the rounding of
    R src + t - tgt and its norm) plus the two poses' largest difference
    times |src| + 1. (On these arrays the sets are equal in every round.)
    RR and F1 are equal. The final poses are within 1e-5 (float32
    rounding of the 20 reweighted Kabsch rounds) plus, for each match
    whose membership differs in the last round, its weight's largest
    pull on the weighted fit, 0.5 * 1.2 m / (the round's weight sum): a
    match at 1.2 m has weight 1 / (1 + 1)."""
    import gcl_tpu.reg.sc2pcr as jsc

    from gcl_tpu_torch.reg import sc2pcr as tsc

    root, name = sc2_roots["KITTI outliers"]
    with open(os.path.join(SC2_CONFIGS, name)) as f:
        cfg = json.load(f)
    cfg.update(num_node="all", max_points=500)
    cfg_path = str(tmp_path / "cfg.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f)
    flags = ["--config_path", cfg_path, "--data_root", str(root)]
    rec = _record_refinement(monkeypatch, jsc, tsc)
    root_bench = _script("scripts/SC2_PCR/test_KITTI.py", "root_sc2")
    monkeypatch.setattr("sys.argv", ["test_KITTI.py"] + flags)
    ref = root_bench.main()
    got = test_kitti.main(flags + ["--device", "cpu"])
    assert got["RR"] == ref["RR"] == 100.0
    assert got["F1"] == ref["F1"] and 0.5 < got["F1"] <= 1.0

    rounds = cfg["num_iterations"]
    per_pair = 2 * rounds + 1
    eps = float(np.finfo(np.float32).eps)
    n_pairs = len(os.listdir(root / "fcgf_test"))
    assert len(rec["ref"]) == len(rec["ours"]) == n_pairs * per_pair
    outlier_rounds = 0
    for p in range(n_pairs):
        pair = np.load(root / "fcgf_test" / f"pair_{p}.npz")
        f0, f1 = pair["features0"], pair["features1"]
        nn = np.argmin(2 - 2 * f0 @ f1.T, axis=1)  # num_node "all"
        src = pair["xyz0"].astype(np.float64)
        tgt = pair["xyz1"][nn].astype(np.float64)
        scale = np.abs(src).sum(1) + np.abs(tgt).sum(1)
        recs = [r[p * per_pair:(p + 1) * per_pair] for r in
                (rec["ref"], rec["ours"])]
        assert all([k for k, _ in r] == ["T", "w"] * rounds + ["T"]
                   for r in recs)
        for j in range(rounds):
            (_, t_ref), (_, w_ref) = recs[0][2 * j:2 * j + 2]
            (_, t_ours), (_, w_ours) = recs[1][2 * j:2 * j + 2]
            in_ref, in_ours = w_ref > 0, w_ours > 0
            outlier_rounds += int((~in_ref).any())
            gap = np.abs(t_ref.astype(np.float64) - t_ours).max()
            for m in np.nonzero(in_ref != in_ours)[0]:
                tol = (8 * eps * (scale[m] + np.abs(t_ref[:3, 3]).sum())
                       + gap * (np.abs(src[m]).sum() + 1))
                for t in (t_ref, t_ours):
                    t = t.astype(np.float64)
                    res = np.linalg.norm(src[m] @ t[:3, :3].T + t[:3, 3]
                                         - tgt[m])
                    assert abs(res - 1.2) <= tol, (p, j, m, res, tol)
        w_last = [recs[i][2 * rounds - 1][1] for i in (0, 1)]
        flips = int(((w_last[0] > 0) != (w_last[1] > 0)).sum())
        pose_tol = 1e-5 + flips * 0.5 * 1.2 / w_last[1].sum()
        np.testing.assert_allclose(recs[1][-1][1], recs[0][-1][1], rtol=0,
                                   atol=pose_tol)
    assert outlier_rounds >= rounds  # the outlier pair's rounds saw some


@pytest.mark.parametrize("entry,argv", [
    (demo.main, []),
    (eval_eth.main, ["--eth_root", "x", "--checkpoint", "y"]),
    (test_kitti.main, ["--data_root", "x"]),
    (test_3dmatch.main, ["--data_root", "x"]),
    (test_3dlomatch.main, ["--data_root", "x"]),
    (posegraph.main, []),
])
def test_entry_points_need_a_card_by_default(entry, argv):
    """Without --device cpu each entry point asks for the card, and raises
    on a machine without one (no CPU fallback)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    with pytest.raises(RuntimeError, match="--device cuda"):
        entry(argv)
