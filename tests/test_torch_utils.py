"""Parity of the port's host utilities with gcl_tpu's: PLY, trajectory and
file IO, matching helpers, square_distance, the exact
t-SNE and Spectral colours that replace scikit-learn and matplotlib, the
SC2-PCR utilities and the MinkowskiEngine checkpoint import
(extract_features and the features of imported weights are held to
gcl_tpu's in tests/test_torch_entry_points.py, beside the root scripts
that compile the same JAX model).

The t-SNE is held to scikit-learn's exact method (the port's stated
departure from gcl_tpu, which calls the Barnes-Hut default) started from
the port's PCA initialisation, within 1e-4 of the embedding's range: both
run the same float32 / float64 arithmetic step for step (0 apart seen). The
PCA initialisation is held to scikit-learn's within 1e-5 of its largest
value, sign included, on both of the solvers its default picks at these
sizes ("full" below 10 samples a feature, "covariance_eigh" above).
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from sklearn.decomposition import PCA
from sklearn.manifold import TSNE

from gcl_tpu.train.import_torch import \
    load_torch_checkpoint as j_load_torch_checkpoint
from gcl_tpu.utils import file as jfile
from gcl_tpu.utils import misc as jmisc
from gcl_tpu.utils import pointcloud as jpc
from gcl_tpu.utils import trajectory as jtraj
from gcl_tpu.utils import timer as jtimer
from gcl_tpu.utils import visualization as jvis
from gcl_tpu_torch.models import load_model
from gcl_tpu_torch.models.weights import flax_to_state_dict, random_state_dict
from gcl_tpu_torch.sc2_pcr.utils import max_clique, sinkhorn
from gcl_tpu_torch.train import import_torch
from gcl_tpu_torch.utils import file as tfile
from gcl_tpu_torch.utils import (misc, pointcloud, timer, trajectory,
                                  visualization)

from _torch_parity import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _features(seed: int, n: int, d: int = 16) -> np.ndarray:
    """Clustered unit-norm rows, like a model's normalized features."""
    rng = np.random.RandomState(seed)
    x = rng.randn(n, d) + np.repeat(rng.randn(5, d) * 3, -(-n // 5),
                                    0)[:n]
    return x / np.linalg.norm(x, axis=1, keepdims=True)


@pytest.mark.parametrize("n", [150, 600])
def test_pca_init_matches_sklearn(n):
    x = _features(n, n)
    ref = PCA(1).fit_transform(x).astype(np.float32)[:, 0]
    ref = ref / np.std(ref) * 1e-4
    got = visualization.pca_init(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    big = np.abs(ref) > 0.1 * np.abs(ref).max()
    assert (np.sign(got[big]) == np.sign(ref[big])).all()


@pytest.mark.parametrize("seed", [0, 1])
def test_tsne_matches_sklearn_exact(seed):
    x = _features(seed, 150)
    xt = torch.from_numpy(x)
    init = visualization.pca_init(xt)
    ref = TSNE(n_components=1, perplexity=40, max_iter=300, method="exact",
               init=init.numpy()[:, None]).fit_transform(x)[:, 0]
    got = visualization.tsne_1d(xt, init).numpy()
    span = ref.max() - ref.min()
    assert span > 1.0
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * span)
    t = visualization.embed_tsne(x).numpy()
    assert t.min() == 0.0 and t.max() == 1.0 and t.dtype == np.float32


def test_spectral_colors_match_matplotlib():
    t = np.concatenate([np.random.RandomState(0).rand(1000), [0.0, 1.0],
                        np.linspace(0, 1, 257)])
    for arr in (t, t.astype(np.float32), np.array([-0.2, 1.3, 0.5])):
        np.testing.assert_allclose(visualization.spectral_colors(arr),
                                   jvis.spectral_colors(arr), rtol=0,
                                   atol=1e-12)
    assert visualization.spectral_colors([np.nan]).tolist() == [[0, 0, 0]]


def test_ply_and_trajectory_files_are_byte_equal(tmp_path):
    rng = np.random.RandomState(0)
    xyz = rng.randn(50, 3).astype(np.float32)
    colors = rng.rand(50, 3)
    for c in (None, colors):
        paths = [str(tmp_path / f"{n}.ply") for n in ("ref", "ours")]
        jpc.write_ply_xyz(paths[0], xyz, c)
        pointcloud.write_ply_xyz(paths[1], xyz, c)
        assert open(paths[0], "rb").read() == open(paths[1], "rb").read()
        np.testing.assert_array_equal(pointcloud.read_ply_xyz(paths[1]),
                                      jpc.read_ply_xyz(paths[0]))
    ascii_ply = tmp_path / "a.ply"
    ascii_ply.write_text("ply\nformat ascii 1.0\nelement vertex 2\n"
                         "property float x\nproperty float y\n"
                         "property float z\nend_header\n1 2 3\n4 5 6\n")
    np.testing.assert_array_equal(pointcloud.read_ply_xyz(str(ascii_ply)),
                                  jpc.read_ply_xyz(str(ascii_ply)))

    traj = [jtraj.TrajectoryEntry((i, i + 1, 3), rng.randn(4, 4))
            for i in range(3)]
    jtraj.write_trajectory(traj, str(tmp_path / "ref.log"))
    trajectory.write_trajectory(traj, str(tmp_path / "ours.log"))
    assert (tmp_path / "ref.log").read_bytes() == \
        (tmp_path / "ours.log").read_bytes()
    got = trajectory.read_trajectory(str(tmp_path / "ref.log"))
    ref = jtraj.read_trajectory(str(tmp_path / "ref.log"))
    assert [e.metadata for e in got] == [e.metadata for e in ref]
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.pose, b.pose)

    for name in ("f10.txt", "f2.txt", "f1.log"):
        (tmp_path / name).write_text("x\ny\n")
    (tmp_path / "sub").mkdir()
    assert tfile.get_file_list(str(tmp_path), ".txt") == \
        jfile.get_file_list(str(tmp_path), ".txt")
    assert tfile.get_file_list(str(tmp_path)) == \
        jfile.get_file_list(str(tmp_path))
    assert tfile.get_folder_list(str(tmp_path)) == \
        jfile.get_folder_list(str(tmp_path))
    assert tfile.read_txt(str(tmp_path / "f1.log")) == ["x", "y"]


def test_matching_helpers_match():
    rng = np.random.RandomState(1)
    a = (rng.rand(300, 3) * 4).astype(np.float32)
    t = jpc.sample_random_trans(a, np.random.RandomState(3), 30)
    assert np.array_equal(
        pointcloud.sample_random_trans(a, np.random.RandomState(3), 30), t)
    b = (a @ t[:3, :3].T + t[:3, 3] + rng.randn(300, 3) * 0.02).astype(
        np.float32)
    for k in (None, 2):
        assert pointcloud.get_matching_indices(a, b, t, 0.1, k) == \
            jpc.get_matching_indices(a, b, t, 0.1, k)
    assert pointcloud.compute_overlap_ratio(a, b, t, 0.1) == \
        jpc.compute_overlap_ratio(a, b, t, 0.1)

    src, dst = rng.randn(2, 40, 8), rng.randn(2, 30, 8)
    for norm in (False, True):
        np.testing.assert_allclose(
            misc.square_distance(torch.from_numpy(src),
                                 torch.from_numpy(dst), norm).numpy(),
            np.asarray(jmisc.square_distance(jnp.asarray(src),
                                             jnp.asarray(dst), norm)),
            rtol=1e-5, atol=1e-5)


def test_sc2pcr_utilities_match():
    jsink = _script("scripts/SC2_PCR/utils/sinkhorn.py", "j_sinkhorn")
    jclique = _script("scripts/SC2_PCR/utils/max_clique.py", "j_clique")
    rng = np.random.RandomState(2)
    scores = rng.randn(7, 5).astype(np.float32)
    got = sinkhorn.log_optimal_transport(torch.from_numpy(scores), 0.5, 20)
    ref = jsink.log_optimal_transport(jnp.asarray(scores), 0.5, 20)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5)
    adj = rng.rand(30, 30) > 0.5
    adj = adj | adj.T
    np.testing.assert_array_equal(max_clique.max_clique(adj),
                                  jclique.max_clique(adj))


# ----------------------------------------------------------------------
# MinkowskiEngine checkpoints and extract_features
# ----------------------------------------------------------------------

def _me_checkpoint(path, name, k, seed, in_block=None):
    """A synthetic ME checkpoint of ``name`` (conv1 k): the port's seeded
    weights in ME's layout, the top-level norms' BN under normN.bn.* and
    the blocks' under blockN.normI.*, the norms of ``in_block`` dropped
    (an instance-norm block)."""
    model = load_model(name)(1, 16, bn_momentum=0.05, normalize_feature=True,
                             conv1_kernel_size=k, D=3)
    me = import_torch.export_state_dict(random_state_dict(model, seed))
    out = {}
    for key, v in me.items():
        if key.startswith("block"):
            if in_block and key.startswith(in_block + ".norm"):
                continue
            key = key.replace(".bn.", ".")
        out[key] = v
    torch.save({"state_dict": out, "epoch": 7, "best_val": 0.5,
                "best_val_epoch": 6, "best_val_metric": "feat_match_ratio"},
               path)
    return model


@pytest.mark.parametrize("name,k,in_block", [
    ("ResUNetBN2C", 5, "block2"), ("ResUNetFatBN", 7, None),
    ("ResUNetIN2", 5, None)])
def test_me_import_equals_gcl_tpu_bit_for_bit(tmp_path, name, k, in_block):
    path = str(tmp_path / "me.pth")
    _me_checkpoint(path, name, k, seed=3, in_block=in_block)
    sd, meta = import_torch.load_torch_checkpoint(path)
    params, stats, j_meta = j_load_torch_checkpoint(path)
    ref = flax_to_state_dict(params, stats)
    assert meta == j_meta and meta["epoch"] == 7
    assert sd.keys() == ref.keys()
    for key in ref:
        assert sd[key].dtype == ref[key].dtype, key
        assert torch.equal(sd[key], ref[key]), key
    if in_block:
        assert not any(k.startswith(in_block + ".norm") for k in sd)
    assert any("_tr.kernel" in k for k in sd) and "final.kernel" in sd


def test_min_timer_matches_gcl_tpu(monkeypatch):
    """MinTimer on a clock that reads 0, 3, 10, 11, 20, 25 (intervals 3, 1,
    5): the same min, average and last interval as gcl_tpu's."""
    out = []
    for mod in (timer, jtimer):
        reads = iter([0.0, 3.0, 10.0, 11.0, 20.0, 25.0])
        monkeypatch.setattr(mod.time, "time", lambda: next(reads))
        t = mod.MinTimer()
        assert t.min == float("inf")
        got = []
        for _ in range(3):
            t.tic()
            got.append(t.toc(average=False))
        out.append((got, t.min, t.avg, t.calls, t.diff))
        monkeypatch.undo()
    assert out[0] == out[1] == ([3.0, 1.0, 5.0], 1.0, 3.0, 3, 5.0)

