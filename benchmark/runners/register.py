"""Registration cells: what users of the trained features run per pair,
closed loop with one client, a pair ending when its 4 x 4 transform is
read on the host. The estimator is the cell's: ``sc2pcr`` drives
gcl_tpu_torch.infer.register_pair (both clouds in one extract call, 5,000
random keypoints a cloud, SC2-PCR), ``ransac`` the calls of
gcl_tpu_torch.eval_kitti.main's loop with --use_RANSAC true (each cloud
extracted on its own, eval_kitti.random_sample of 5,000 points, feature
nearest neighbours, RANSAC).

Pairs cycle through a pool drawn from the seed; every pair of the window
draws its host random numbers from a generator seeded by the run's seed
and the pair's index. The outputs of a sample of the window's pairs,
drawn from the seed, are kept; after the window the reference extracts
the same clouds (voxels and features are compared) and runs the
estimator from the program's own features and the pair's seed (the
transform is compared). The reference's estimator also runs on the
reference's own voxels and features: that transform's gap to the
program's, the whole pair held against an independent pipeline, is
printed as a reading."""
from __future__ import annotations

import contextlib
import math
import random
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from .. import traffic, weights
from ..check import feat_gap, pose_gaps, vox_mismatch


def _levels(model_cls, k: int, nv_cap: int, shrink: float, caps_fn):
    specs = model_cls.conv_specs(k)
    strides = sorted({s for sp in specs
                      for s in (sp.in_stride, sp.out_stride)})
    return specs, caps_fn(nv_cap, strides, shrink)


def build_program(cfg: dict, seed: int, dev):
    """The port's feature extractor (infer.make_feature_extractor) at the
    configuration's registration settings, with the seed's weights."""
    from gcl_tpu_torch.core.kernel_maps import default_level_caps
    from gcl_tpu_torch.infer import make_feature_extractor
    from gcl_tpu_torch.models import load_model

    m, reg = cfg["model"], cfg["register"]
    model_cls = load_model(m["class"])
    model = model_cls(1, m["out_channels"], bn_momentum=m["bn_momentum"],
                      conv1_kernel_size=m["conv1_kernel_size"],
                      normalize_feature=m["normalize_feature"], D=3)
    model.load_state_dict(weights.random_state(weights.shapes_of(model),
                                               seed, dev))
    specs, caps = _levels(model_cls, m["conv1_kernel_size"], reg["nv_cap"],
                          reg["level_cap_shrink"], default_level_caps)
    return make_feature_extractor(model.to(dev), specs, reg["voxel_size"],
                                  reg["nv_cap"], caps)


def _matcher(cfg: dict, module):
    s = cfg["register"]["sc2pcr"]
    return module.Matcher(
        inlier_threshold=s["inlier_threshold"], num_node=s["num_node"],
        use_mutual=s["use_mutual"], d_thre=s["d_thre"],
        num_iterations=s["num_iterations"], ratio=s["ratio"],
        nms_radius=s["nms_radius"], max_points=s["max_points"], k1=s["k1"],
        k2=s["k2"])


class _Spans:
    """The benchmark's own spans around a pair's extractor and estimator
    calls: host-clock times (``timed``; the extractor's span ends in a
    synchronize) and profiler ranges ``bench/extract``,
    ``bench/estimate`` (``labelled``, which name the idle gaps of a
    trace). Neither in the timed window."""

    def __init__(self, ctx, timed: bool = False, labelled: bool = False):
        self.ctx, self.on, self.labelled = ctx, timed, timed or labelled
        self.s: Dict[str, List[float]] = {"extract": [], "estimate": []}

    @contextlib.contextmanager
    def __call__(self, name: str):
        if not self.labelled:
            yield
            return
        from torch.profiler import record_function
        t0 = time.perf_counter()
        with record_function(f"bench/{name}"):
            yield
            if self.on and name == "extract":
                self.ctx.sync()
        if self.on:
            self.s[name].append(time.perf_counter() - t0)


class _LabelledMatcher:
    """A matcher whose estimator runs inside the ``bench/estimate`` range
    (a label only: the estimate span's time runs to the host read)."""

    def __init__(self, matcher):
        self.matcher = matcher

    def estimator(self, *args, **kwargs):
        from torch.profiler import record_function
        with record_function("bench/estimate"):
            return self.matcher.estimator(*args, **kwargs)


def _sc2pcr_pair(ctx, cell, cfg, extract, matcher, item, index, spans):
    """One serving pair through infer.register_pair: (transform on the
    host, outputs to keep)."""
    from gcl_tpu_torch.infer import register_pair

    n_key = cell["estimator"]["keypoints"]
    gen = torch.Generator().manual_seed(traffic.pair_seed(ctx.seed, index))
    t_end = {}

    def timed_extract(points, pmask):
        with spans("extract"):
            out = extract(points, pmask)
        t_end["extract"] = time.perf_counter()
        return out

    t, vox, f = register_pair(timed_extract if spans.labelled else extract,
                              _LabelledMatcher(matcher)
                              if spans.labelled else matcher,
                              item["points"], item["pmask"], n_key,
                              generator=gen)
    t = t.cpu()
    if spans.on:
        spans.s["estimate"].append(time.perf_counter() - t_end["extract"])
    return t, {"vox": [vox], "f": [f]}


def _ransac_pair(ctx, cell, cfg, extract, matcher, item, index, spans):
    """One evaluation pair as eval_kitti.main's loop registers it with
    --use_RANSAC true: (transform on the host, outputs to keep)."""
    from gcl_tpu_torch.eval_kitti import random_sample
    from gcl_tpu_torch.reg.matching import find_nn
    from gcl_tpu_torch.reg.ransac import ransac_pose

    r = cfg["register"]["ransac"]
    dev = item["points"].device
    seed = traffic.pair_seed(ctx.seed, index)
    voxes, fs, sides = [], [], []
    with spans("extract"):
        for c in (0, 1):
            vox, f = extract(item["points"][c:c + 1], item["pmask"][c:c + 1])
            m = vox.mask[0]
            voxes.append(vox)
            fs.append(f)
            sides.append((vox.xyz[0][m].cpu().numpy(),
                          f[0][m].float().cpu().numpy()))
    with spans("estimate"):
        rng = np.random.RandomState(seed % (1 << 32))
        gen = torch.Generator().manual_seed(seed)
        (x0s, f0s), (x1s, f1s) = (random_sample(x, f, r["points"], rng)
                                  for x, f in sides)
        x0, x1, f0, f1 = (torch.from_numpy(a).to(dev)
                          for a in (x0s, x1s, f0s, f1s))
        nn, _ = find_nn(f0, f1, chunk=r["knn_chunk"])
        t, _, _ = ransac_pose(x0, x1[nn], r["threshold_m"], generator=gen,
                              num_hypotheses=r["hypotheses"],
                              sample_size=r["sample_size"],
                              edge_length_ratio=r["edge_length_ratio"])
        t = t.cpu()
    return t, {"vox": voxes, "f": fs, "sides": sides}


PAIRS = {"sc2pcr": _sc2pcr_pair, "ransac": _ransac_pair}


def run(ctx) -> dict:
    """One run of a registration cell (see the module's docstring)."""
    from gcl_tpu_torch.reg import sc2pcr

    cell, cfg, dev, seed = ctx.cell, ctx.config, ctx.device, ctx.seed
    p, est = cell["traffic"], cell["estimator"]
    extract = build_program(cfg, seed, dev)
    matcher = _matcher(cfg, sc2pcr) if est["kind"] == "sc2pcr" else None
    pool = traffic.registration_pairs(seed, p, dev)
    ctx.note("program built, pool drawn")
    pair = PAIRS[est["kind"]]
    off = _Spans(ctx)

    for i in range(cell["warmup_pairs"]):
        pair(ctx, cell, cfg, extract, matcher, pool[i % len(pool)], -1 - i,
             off)
    ctx.note("warm-up pairs done")
    rng = random.Random(seed)
    keep_at = set(rng.sample(range(cell["check_within"]),
                             cell["check_pairs"]))
    kept = {}

    ctx.start_window()
    lat, i = [], 0
    t0 = time.perf_counter()
    while True:
        a = time.perf_counter()
        t, out = pair(ctx, cell, cfg, extract, matcher, pool[i % len(pool)],
                      i, off)
        b = time.perf_counter()
        lat.append(b - a)
        if i in keep_at:
            kept[i] = (t, out)
        i += 1
        if b - t0 >= ctx.seconds:
            break
    elapsed = time.perf_counter() - t0
    record = {"attempted": i, "failed": 0,
              "window": {"seconds": elapsed, "pairs": i,
                         "latencies_s": lat}}
    ctx.note(f"window: {i} pairs in {elapsed:.3f} s")
    if ctx.trace:
        # the span pass: the benchmark's spans, the extractor's ending in a
        # synchronize; then the profiled window, without them
        spans = _Spans(ctx, timed=True)
        for k in range(i, i + cell["span_units"]):
            pair(ctx, cell, cfg, extract, matcher, pool[k % len(pool)], k,
                 spans)
        record["spans"] = spans.s
        i += cell["span_units"]
        labels = _Spans(ctx, labelled=True)
        units = [lambda k=k: pair(ctx, cell, cfg, extract, matcher,
                                  pool[k % len(pool)], k, labels)
                 for k in range(i, i + cell["trace_units"])]
        record["trace"] = ctx.trace_window(units)
        ctx.note_stretch(record["trace"], elapsed / record["window"]["pairs"])
    record["memory_peak_bytes"] = ctx.memory_peak()
    del extract, matcher
    ctx.free()
    ctx.note(f"reference checks pairs {sorted(kept)}")
    record["numbers"] = check_pairs(ctx, kept, pool)
    ctx.note("reference done")
    record["checked"] = sorted(kept)
    return record


def check_pairs(ctx, kept: dict, pool) -> Dict[str, float]:
    """The reference's judgement of the kept pairs: voxels that differ,
    the widest feature gap and the transform's gaps (to the reference's
    estimator on the program's features, and ``*_e2e`` to the reference's
    whole pipeline), each the worst over the pairs."""
    cell = ctx.cell
    ref_extract = reference_extractor(ctx.config, ctx.seed, ctx.device)
    nums = {"vox_mismatch": 0.0, "feat_gap": 0.0, "pose_t_gap_m": 0.0,
            "pose_r_gap_deg": 0.0, "pose_t_gap_e2e_m": 0.0,
            "pose_r_gap_e2e_deg": 0.0}
    if not kept:  # no pair of the sample came due: nothing is shown
        return {k: math.nan for k in nums}
    for index, (t_prog, out) in sorted(kept.items()):
        item = pool[index % len(pool)]
        refs = _reference_voxels(cell, ref_extract, item)
        for (vox_r, f_r), vox_p, f_p in zip(refs, out["vox"], out["f"]):
            nums["vox_mismatch"] += vox_mismatch(vox_p, vox_r)
            nums["feat_gap"] = max(nums["feat_gap"],
                                   feat_gap(f_p, f_r, vox_r.mask))
        for suffix, own in (("", out), ("_e2e", _outputs(cell, refs))):
            dt, dr = pose_gaps(t_prog, reference_estimate(ctx, own, index))
            nums[f"pose_t_gap{suffix}_m"] = max(
                nums[f"pose_t_gap{suffix}_m"], dt)
            nums[f"pose_r_gap{suffix}_deg"] = max(
                nums[f"pose_r_gap{suffix}_deg"], dr)
    return nums


def _reference_voxels(cell, ref_extract, item):
    """The reference's (voxels, features) of a pair, per extract call of
    the cell's estimator."""
    if cell["estimator"]["kind"] == "sc2pcr":
        return [ref_extract(item["points"], item["pmask"])]
    return [ref_extract(item["points"][c:c + 1], item["pmask"][c:c + 1])
            for c in (0, 1)]


def reference_pair(ctx, item, index: int, precision: Optional[str]):
    """A pair computed by the reference alone, in ``precision`` (the
    control): (transform on the host, outputs as the program's)."""
    from ..precision import lower

    with lower(precision):
        ref_extract = reference_extractor(ctx.config, ctx.seed, ctx.device)
        out = _outputs(ctx.cell, _reference_voxels(ctx.cell, ref_extract,
                                                   item))
        return reference_estimate(ctx, out, index), out


def _outputs(cell, refs) -> dict:
    """The reference's (voxels, features) of a pair as the program's
    outputs are kept."""
    out = {"vox": [v for v, _ in refs], "f": [f for _, f in refs]}
    if cell["estimator"]["kind"] == "ransac":
        out["sides"] = [(v.xyz[0][v.mask[0]].cpu().numpy(),
                         f[0][v.mask[0]].float().cpu().numpy())
                        for v, f in refs]
    return out


def reference_extractor(cfg: dict, seed: int, dev):
    """The reference's feature extractor at the same settings and weights."""
    from ..reference.core.kernel_maps import default_level_caps
    from ..reference.models import MODELS
    from ..reference.register import make_feature_extractor

    m, reg = cfg["model"], cfg["register"]
    model_cls = MODELS[m["class"]]
    model = model_cls(1, m["out_channels"], bn_momentum=m["bn_momentum"],
                      conv1_kernel_size=m["conv1_kernel_size"],
                      normalize_feature=m["normalize_feature"], D=3)
    model.load_state_dict(weights.random_state(weights.shapes_of(model),
                                               seed, dev))
    specs, caps = _levels(model_cls, m["conv1_kernel_size"], reg["nv_cap"],
                          reg["level_cap_shrink"], default_level_caps)
    return make_feature_extractor(model.to(dev), specs, reg["voxel_size"],
                                  reg["nv_cap"], caps)


def reference_estimate(ctx, out: dict, index: int) -> torch.Tensor:
    """The reference estimator's transform from the voxels and features
    ``out`` of a pair (the program's or the reference's own), with the
    pair's random numbers."""
    from ..reference import register as rr
    from ..reference.reg import sc2pcr
    from ..reference.reg.matching import find_nn
    from ..reference.reg.ransac import ransac_pose

    cfg, cell = ctx.config, ctx.cell
    seed = traffic.pair_seed(ctx.seed, index)
    if cell["estimator"]["kind"] == "sc2pcr":
        vox, f = out["vox"][0], out["f"][0]
        gen = torch.Generator().manual_seed(seed)
        # the serving path draws its keypoints from the generator first
        return rr.sc2pcr_estimate(
            _matcher(cfg, sc2pcr), [vox.xyz[0], vox.xyz[1]], [f[0], f[1]],
            [vox.mask[0], vox.mask[1]], cell["estimator"]["keypoints"],
            gen).cpu()
    r = cfg["register"]["ransac"]
    dev = out["f"][0].device
    rng = np.random.RandomState(seed % (1 << 32))
    gen = torch.Generator().manual_seed(seed)
    (x0s, f0s), (x1s, f1s) = (rr.random_sample(x, f, r["points"], rng)
                              for x, f in out["sides"])
    x0, x1, f0, f1 = (torch.from_numpy(a).to(dev)
                      for a in (x0s, x1s, f0s, f1s))
    nn, _ = find_nn(f0, f1, chunk=r["knn_chunk"])
    t, _, _ = ransac_pose(x0, x1[nn], r["threshold_m"], generator=gen,
                          num_hypotheses=r["hypotheses"],
                          sample_size=r["sample_size"],
                          edge_length_ratio=r["edge_length_ratio"])
    return t.cpu()
