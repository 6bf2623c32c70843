"""The port's spans (gcl_tpu_torch/utils/spans.py) under torch.profiler on
the CPU: a GCL step of two clouds, an FCGF pair step, register_pair with
SC2-PCR on a few hundred voxels, and random_sample + find_nn +
ransac_pose at 256 hypotheses, each at narrow widths. Every span of the
port appears where the benchmark's readers look for it (conv/bwd inside
the backward), no span of a reader's list nests in another of the same
list, no span takes a name of the steps' own ranges or the benchmark's,
and with no profiler running a span enters no record_function."""
from typing import NamedTuple

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark.metrics import (conv_ms_train, estimate_device_ms_register,
                               extract_device_ms_register)
from gcl_tpu_torch.core.kernel_maps import default_level_caps
from gcl_tpu_torch.eval_kitti import random_sample
from gcl_tpu_torch.infer import (kitti_matcher, make_feature_extractor,
                                 register_pair)
from gcl_tpu_torch.losses.gcl import GCLLossConfig
from gcl_tpu_torch.models.resunet import ResUNetFatBN, ResUNetFatBNEXP
from gcl_tpu_torch.models.weights import random_state_dict
from gcl_tpu_torch.reg.matching import find_nn
from gcl_tpu_torch.reg.ransac import ransac_pose
from gcl_tpu_torch.train import steps
from gcl_tpu_torch.utils.spans import span

from _torch_parity import (NARROW_EXP, VOXEL, clouds,  # noqa: F401
                           one_torch_thread, strides_of)

pytestmark = pytest.mark.usefixtures("one_torch_thread")

NV = 256
STEP_RANGES = {f"{p}/{s}" for p, stages in (
    ("gcl", ("voxelize", "groups", "graph", "unet", "loss", "backward",
             "sgd")),
    ("fcgf", ("voxelize", "graph", "unet", "correspondences", "loss",
              "backward", "sgd"))) for s in stages}
READERS = {"conv_ms.train": conv_ms_train.SPANS,
           "extract_device_ms.register": extract_device_ms_register.SPANS,
           "estimate_device_ms.register": estimate_device_ms_register.SPANS}
WANT = {
    "gcl_step": {"conv/fwd", "conv/bwd", "graph/levels", "graph/index",
                 "graph/maps"},
    "fcgf_step": {"conv/fwd", "conv/bwd", "graph/levels", "graph/index",
                  "graph/maps"},
    "sc2pcr_pair": {"extract/voxelize", "extract/graph", "extract/unet",
                    "conv/fwd", "graph/levels", "graph/index", "graph/maps",
                    "register/keypoints", "sc2pcr/match",
                    "sc2pcr/consistency", "sc2pcr/seeds",
                    "sc2pcr/hypotheses", "sc2pcr/refine"},
    "ransac_pair": {"match/sample", "match/nn", "ransac/draw",
                    "ransac/score", "ransac/refine"},
}
NarrowFatBN = type("NarrowFatBN", (ResUNetFatBN,),
                   dict(CHANNELS=[None, 8, 8, 16, 16],
                        TR_CHANNELS=[None, 16, 16, 16, 16]))
NarrowEXP = type("NarrowEXP", (ResUNetFatBNEXP,), dict(NARROW_EXP))


def _model(cls, seed):
    model = cls(1, 16, bn_momentum=0.05, normalize_feature=True,
                conv1_kernel_size=5, D=3)
    model.load_state_dict(random_state_dict(model, seed=seed))
    return model


def _step_config(specs, n_rows, **kw):
    return steps.StepConfig(
        voxel_size=VOXEL, nv_cap=NV,
        level_caps=default_level_caps(n_rows, strides_of(specs), 0.6),
        knn_chunk=128, search_cell=None, **kw)


def _gcl_step():
    """One GCL step of one sample of two clouds, exact input jitter on."""
    specs = NarrowFatBN.conv_specs(5)
    model = _model(NarrowFatBN, 3)
    _, step = steps.make_gcl_train_step(
        model, specs, _step_config(specs, 2 * NV), GCLLossConfig(),
        "finest", max_pos_cluster=32, max_hn_samples=32, pos_weight=1.0,
        finest_weight=1.0, neg_weight=1.0)
    pts, pmask = clouds(1, 2, 600)
    pts[1] = pts[0] + np.array([0.6, 0.0, 0.0], np.float32)
    tr = np.broadcast_to(np.eye(4, dtype=np.float32), (1, 2, 4, 4)).copy()
    tr[0, 1, 0, 3] = -0.6
    batch = (torch.from_numpy(pts[None]), torch.from_numpy(pmask[None]),
             torch.from_numpy(tr), torch.tensor([0.45]))
    gen = torch.Generator().manual_seed(0)
    return lambda: step(0.01, *batch, generator=gen)


def _fcgf_step():
    """One hardest-contrastive pair step of one pair, jitter on."""
    specs = NarrowEXP.conv_specs(5)
    model = _model(NarrowEXP, 4)
    cfg = dict(batch_size=1, num_pos_per_batch=32,
               num_hn_samples_per_batch=32, triplet_num_pos=8,
               triplet_num_hn=8, triplet_num_rand=8, pos_thresh=0.1,
               neg_thresh=1.4, neg_weight=1.0, jitter_feats=True)
    _, step = steps.make_pair_train_step(
        model, specs, _step_config(specs, NV, corr_k=4),
        "hardest_contrastive", cfg)
    pts, pmask = clouds(2, 2, 600)
    moved = pts[0] + np.array([0.4, -0.2, 0.0], np.float32)
    tr = np.eye(4, dtype=np.float32)[None].copy()
    tr[0, :3, 3] = [0.4, -0.2, 0.0]
    batch = (torch.from_numpy(pts[:1]), torch.from_numpy(pmask[:1]),
             torch.from_numpy(moved[None]), torch.from_numpy(pmask[:1]),
             torch.from_numpy(tr), torch.tensor([0.45]))
    gen = torch.Generator().manual_seed(0)
    return lambda: step(0.01, *batch, generator=gen)


def _sc2pcr_pair():
    """register_pair: both clouds in one extract call, 100 keypoints,
    SC2-PCR at the KITTI settings."""
    specs = NarrowFatBN.conv_specs(5)
    extract = make_feature_extractor(
        _model(NarrowFatBN, 5), specs, VOXEL, NV,
        default_level_caps(NV, strides_of(specs), 0.7))
    pts, pmask = clouds(3, 2, 600)
    pts[1] = pts[0] + np.array([0.3, 0.2, 0.0], np.float32)
    pmask[1] = pmask[0]
    points, mask = torch.from_numpy(pts), torch.from_numpy(pmask)
    gen = torch.Generator().manual_seed(0)
    return lambda: register_pair(extract, kitti_matcher(100), points, mask,
                                 100, generator=gen)


def _ransac_pair():
    """eval_kitti's RANSAC calls on 400 and 300 rows of 16-d features."""
    rng = np.random.RandomState(6)
    x0, x1 = rng.randn(400, 3) * 5, rng.randn(300, 3) * 5
    f0, f1 = rng.randn(400, 16), rng.randn(300, 16)
    gen = torch.Generator().manual_seed(0)

    def pair():
        (a, fa), (b, fb) = (random_sample(x.astype(np.float32),
                                          f.astype(np.float32), 200, rng)
                            for x, f in ((x0, f0), (x1, f1)))
        nn, _ = find_nn(torch.from_numpy(fa), torch.from_numpy(fb),
                        chunk=64)
        return ransac_pose(torch.from_numpy(a), torch.from_numpy(b)[nn],
                           0.3, generator=gen, num_hypotheses=256,
                           edge_length_ratio=0.9)

    return pair


UNITS = {"gcl_step": _gcl_step, "fcgf_step": _fcgf_step,
         "sc2pcr_pair": _sc2pcr_pair, "ransac_pair": _ransac_pair}


class Range(NamedTuple):
    name: str
    start: int
    end: int
    thread: int

    def holds(self, other: "Range") -> bool:
        return self.start <= other.start and other.end <= self.end


@pytest.fixture(scope="module")
def traced():
    """Each unit run once under the profiler: {unit: the host ranges
    whose name holds a '/', as the benchmark's trace reducer keeps them}
    (read from the profiler's raw events: building its event tree takes
    seconds a unit here)."""
    out = {}
    for name, make in UNITS.items():
        unit = make()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            unit()
        out[name] = [Range(e.name(), e.start_ns(), e.end_ns(),
                           e.start_thread_id())
                     for e in prof.profiler.kineto_results.events()
                     if "/" in e.name() and e.is_user_annotation()]
    return out


@pytest.mark.parametrize("unit", sorted(UNITS))
def test_every_span_appears(traced, unit):
    names = {e.name for e in traced[unit]}
    assert WANT[unit] <= names, WANT[unit] - names


@pytest.mark.parametrize("stage", ["gcl", "fcgf"])
def test_conv_bwd_runs_inside_the_backward(traced, stage):
    events = traced[f"{stage}_step"]
    back = [e for e in events if e.name == f"{stage}/backward"]
    bwd = [e for e in events if e.name == "conv/bwd"]
    assert len(back) == 1 and bwd
    assert all(back[0].holds(e) for e in bwd)
    # the forward's convs ran inside the U-Net's range
    unet = [e for e in events if e.name == f"{stage}/unet"]
    fwd = [e for e in events if e.name == "conv/fwd"]
    assert fwd and all(any(u.holds(e) for u in unet) for e in fwd)


@pytest.mark.parametrize("unit", sorted(UNITS))
@pytest.mark.parametrize("metric", sorted(READERS))
def test_no_span_nests_in_another_of_its_list(traced, unit, metric):
    mine = [e for e in traced[unit] if e.name in READERS[metric]]
    for a in mine:
        for b in mine:
            assert a is b or a.thread != b.thread or not a.holds(b), \
                (a.name, b.name)


def test_new_spans_take_no_name_of_the_steps_or_the_benchmark(traced):
    names = {e.name for events in traced.values() for e in events}
    assert not any(n.startswith("bench/") for n in names)
    assert {n for n in names
            if n.startswith(("gcl/", "fcgf/"))} <= STEP_RANGES
    listed = {n for spans in READERS.values() for n in spans}
    assert not any(n.startswith(("gcl/", "fcgf/", "bench/"))
                   for n in listed)
    assert listed <= names


def test_a_span_is_one_range_of_the_profilers_events():
    """The operator record inside a span folds into its user annotation:
    the profiler's events hold one range of the name, with the span's
    operators as its children."""
    x = torch.ones(8)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("probe/fold"):
            (x + 1).sum()
    ranges = [e for e in prof.events() if e.name == "probe/fold"]
    assert len(ranges) == 1 and ranges[0].is_user_annotation
    assert {c.name for c in ranges[0].cpu_children} == {"aten::add",
                                                        "aten::sum"}


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []
    enter = torch.ops.profiler._record_function_enter_new

    def counting(*args, **kwargs):
        entered.append(args[0])
        return enter(*args, **kwargs)

    monkeypatch.setattr(torch.ops.profiler, "_record_function_enter_new",
                        counting)
    # the count sees a span while a profiler runs ...
    with profile(activities=[ProfilerActivity.CPU]):
        with span("probe/on"):
            pass
    assert entered == ["probe/on"]
    entered.clear()
    # ... and none of the program's in a whole step, backward included,
    # without one (torch's optimizer opens a range of its own, with no
    # '/' in its name)
    assert not torch._C._autograd._profiler_enabled()
    _gcl_step()()
    _ransac_pair()()
    assert [n for n in entered if "/" in n] == []
