"""The serving path: GCL features + SC2-PCR registration of a pair.

Port of gcl_tpu/train/steps.py:make_feature_extractor and
scripts/bench_infer.py. For each pair:

  voxelize both clouds -> stride levels + conv maps -> ResUNetFatBN (eval)
  -> random keypoint subsample per cloud -> SC2-PCR (cloud 0 -> cloud 1)

``python -m gcl_tpu_torch.infer`` times that on the card for a synthetic
pair at bench_infer.py's shapes and prints one JSON line with
bench_infer.py's keys (``metric: gcl_sc2pcr_inference``, ``pairs/s``,
``pair_time_s``). Where the time goes is the benchmark's to say
(``python3 benchmark/run.py --workload gcl.register.sc2pcr --seed <n>
--seconds <s> --trace 1``): the extractor's spans ``extract/voxelize``,
``extract/graph``, ``extract/unet`` and register_pair's
``register/keypoints`` (utils.spans) name the stages in its trace.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from .core.kernel_maps import ConvSpec, build_graph, default_level_caps
from .data.device_pipeline import voxelize_per_cloud
from .data.synthetic import synth_lidar
from .models.resunet import ResUNetFatBN
from .models.weights import random_state_dict
from .reg.sc2pcr import Matcher, stable_topk_indices
from .utils.spans import span

BASELINE_FPS = 7.0  # the reference's own figure on an RTX 3090


def make_feature_extractor(model: torch.nn.Module,
                           conv_specs: Sequence[ConvSpec], voxel_size: float,
                           nv_cap: int, level_caps: Dict[int, int]):
    """Eval-mode features for one batch of clouds.

    extract(points f32[C, P, 3], pmask bool[C, P], point_feats=None) ->
    (VoxelizedClouds, feats f32[C, nv_cap, out_channels]); rows follow vox
    row for row. The model's input is the occupancy (ones on voxels), or
    ``point_feats`` f32[C, P, F] taken at each voxel's representative
    point. The settings ride on the function as attributes (model,
    conv_specs, voxel_size, nv_cap, level_caps).
    """
    model.eval()

    @torch.inference_mode()
    def extract(points: torch.Tensor, pmask: torch.Tensor,
                point_feats: Optional[torch.Tensor] = None):
        with span("extract/voxelize"):
            vox = voxelize_per_cloud(points, pmask, voxel_size, nv_cap)
            flat = vox.flatten()
            x = flat.feats
            if point_feats is not None:
                f_in = point_feats.shape[-1]
                x = torch.gather(point_feats, 1, vox.rep.long()[..., None]
                                 .expand(-1, -1, f_in))
                x = torch.where(vox.mask[..., None], x, 0.0).reshape(
                    -1, f_in)
        with span("extract/graph"):
            graph = build_graph(flat.coords, flat.mask, conv_specs,
                                level_caps, n_clouds=points.shape[0])
        with span("extract/unet"):
            f = model(graph, x)
        c, nv = vox.mask.shape
        return vox, f.reshape(c, nv, -1)

    extract.model, extract.conv_specs = model, conv_specs
    extract.voxel_size, extract.nv_cap = voxel_size, nv_cap
    extract.level_caps = level_caps
    return extract


def random_keypoints(mask: torch.Tensor, n_key: int,
                     generator: torch.Generator) -> torch.Tensor:
    """n_key random valid rows of one cloud (uniform scores, top n_key, as
    bench_infer.py subsamples); ``generator`` is a CPU generator."""
    score = torch.rand(mask.shape, generator=generator).to(mask.device)
    score = torch.where(mask, score, -1.0)
    return stable_topk_indices(score, n_key)


def register_pair(extract, matcher: Matcher, points: torch.Tensor,
                  pmask: torch.Tensor, n_key: int,
                  generator: Optional[torch.Generator] = None,
                  keypoints: Optional[Sequence[torch.Tensor]] = None):
    """Transform [4, 4] taking cloud 0 onto cloud 1 (points [2, P, 3]).

    ``keypoints`` pins the two clouds' keypoint rows; otherwise n_key are
    drawn from ``generator`` (a CPU torch.Generator).
    Returns (transform, vox, feats).
    """
    vox, f = extract(points, pmask)
    with span("register/keypoints"):
        if keypoints is None:
            keypoints = [random_keypoints(vox.mask[c], n_key, generator)
                         for c in (0, 1)]
        x0, x1 = (vox.xyz[c][keypoints[c]] for c in (0, 1))
        f0, f1 = (f[c][keypoints[c]] for c in (0, 1))
    t, _, _, _ = matcher.estimator(x0[None], x1[None], f0[None], f1[None],
                                   generator)
    return t[0], vox, f


def kitti_matcher(n_key: int) -> Matcher:
    """SC2-PCR at the shipped KITTI settings."""
    return Matcher(inlier_threshold=0.6, num_node="all", use_mutual=False,
                   d_thre=0.1, num_iterations=20, ratio=0.2,
                   nms_radius=0.6, max_points=n_key, k1=30, k2=20)


def serving_model(seed: int, device,
                  model_cls=ResUNetFatBN) -> torch.nn.Module:
    """``model_cls`` (ResUNetFatBN, or ResUNetFatBNEXP, FCGF's) at full
    width (CH 32/64/128/256, TR 128/128/128/256, conv1 k=5, 32-d
    L2-normalized output) with seeded random weights."""
    model = model_cls(1, 32, bn_momentum=0.05, normalize_feature=True,
                      conv1_kernel_size=5, D=3)
    model.load_state_dict(random_state_dict(model, seed))
    return model.to(device).eval()


def serving_extractor(model: torch.nn.Module, nv_cap: int,
                      voxel_size: float = 0.3):
    """bench_infer.py's extractor: the conv plan of the model's class,
    level caps default_level_caps(nv_cap, strides, 0.7) per cloud."""
    specs = type(model).conv_specs(model.conv1.spec.kernel_size)
    strides = sorted({s for sp in specs
                      for s in (sp.in_stride, sp.out_stride)})
    return make_feature_extractor(model, specs, voxel_size, nv_cap,
                                  default_level_caps(nv_cap, strides, 0.7))


def gpu_identity() -> str:
    """``name, power.limit`` of the card as nvidia-smi reports them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--points", type=int, default=65536)
    ap.add_argument("--nv", type=int, default=18432)
    ap.add_argument("--keypts", type=int, default=5000)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: this benchmark times the card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    extract = serving_extractor(serving_model(args.seed, dev), args.nv)
    matcher = kitti_matcher(args.keypts)
    rng = np.random.RandomState(args.seed)
    pts = torch.from_numpy(np.stack([synth_lidar(rng, args.points)
                                     for _ in range(2)])).to(dev)
    pmask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    gen = torch.Generator().manual_seed(args.seed)

    register_pair(extract, matcher, pts, pmask, args.keypts, gen)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.iters):
        register_pair(extract, matcher, pts, pmask, args.keypts, gen)
        torch.cuda.synchronize()  # per-pair sync, as bench_infer.py
    dt = (time.perf_counter() - t0) / args.iters
    print(json.dumps({
        "metric": "gcl_sc2pcr_inference",
        "value": 1.0 / dt,
        "unit": "pairs/s",
        "pair_time_s": dt,
        "vs_baseline": 1.0 / dt / BASELINE_FPS,
        "device": torch.cuda.get_device_name(0),
        "gpu": gpu_identity(),
    }))


if __name__ == "__main__":
    main()
