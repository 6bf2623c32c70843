"""The reference against the port's plain path on the CPU at tiny sizes:
a GCL step, an FCGF step and a pair of each estimator agree bit for bit
(the reference is a frozen copy of that path), and the matched pairs that
the benchmark counts from the reference's maps equal the port's own
count (kernels.sparse_conv.compacted_rows)."""
from __future__ import annotations

import json

import pytest
import torch

from benchmark import spec, traffic
from benchmark.runners import register, train
from benchmark.tests import _tiny


class _Ctx:
    """What the runners read of a run, on the CPU."""

    def __init__(self, cell, config, seed):
        self.cell, self.config, self.seed = cell, config, seed
        self.device = torch.device("cpu")
        self.on_card, self.trace = False, False

    def note(self, what):
        pass

    def sync(self):
        pass

    def free(self):
        pass


def _tiny_files(cell_name):
    cell = spec.cell(cell_name)
    config = spec.config(cell["config"])
    _tiny._tiny_config(config, float32=True)
    _tiny._tiny_cell(cell)
    return cell, config


@pytest.mark.parametrize("cell_name", ["gcl.train.b4x7",
                                       "fcgf.train.b4pairs"])
def test_reference_steps_equal_the_ports_plain_steps(cell_name):
    cell, cfg = _tiny_files(cell_name)
    ctx = _Ctx(cell, cfg, 314159)
    _, batches, draws, prog = train.first_steps(ctx)
    n = cell["check_steps"]
    ref = train.reference_steps(
        cfg, cell["traffic"], ctx.seed, ctx.device,
        [batches[k % len(batches)] for k in range(n)],
        [draws[k % len(draws)] for k in range(n)])
    assert prog["loss"] == ref["loss"]
    for k in ref["p"]:
        assert torch.equal(prog["p0"][k], ref["p0"][k]), k
        assert torch.equal(prog["p"][k], ref["p"][k]), k
        # the program's first gradient is its momentum less the decay
        torch.testing.assert_close(prog["grad"][k], ref["grad"][k],
                                   rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("cell_name", ["gcl.register.sc2pcr",
                                       "fcgf.register.ransac"])
def test_reference_pair_equals_the_ports_pair(cell_name):
    cell, cfg = _tiny_files(cell_name)
    ctx = _Ctx(cell, cfg, 271828)
    extract = register.build_program(cfg, ctx.seed, ctx.device)
    from gcl_tpu_torch.reg import sc2pcr
    matcher = (register._matcher(cfg, sc2pcr)
               if cell["estimator"]["kind"] == "sc2pcr" else None)
    pool = traffic.registration_pairs(ctx.seed, cell["traffic"], ctx.device)
    pair = register.PAIRS[cell["estimator"]["kind"]]
    t, out = pair(ctx, cell, cfg, extract, matcher, pool[1], 7,
                  register._Spans(ctx))
    t_ref, ref = register.reference_pair(ctx, pool[1], 7, None)
    assert torch.equal(t, t_ref)
    for a, b in zip(out["f"], ref["f"]):
        assert torch.equal(a, b)
    nums = register.check_pairs(ctx, {7: (t, out)}, pool)
    assert nums == {"vox_mismatch": 0.0, "feat_gap": 0.0,
                    "pose_t_gap_m": 0.0, "pose_r_gap_deg": 0.0,
                    "pose_t_gap_e2e_m": 0.0, "pose_r_gap_e2e_deg": 0.0}


@pytest.mark.parametrize("cell_name", ["gcl.train.b4x7",
                                       "fcgf.train.b4pairs"])
def test_matched_pairs_equal_the_ports_count(cell_name):
    from gcl_tpu_torch.core.coords import lookup
    from gcl_tpu_torch.core.kernel_maps import build_graph
    from gcl_tpu_torch.data.device_pipeline import voxelize_per_cloud
    from gcl_tpu_torch.kernels.sparse_conv import compacted_rows
    from gcl_tpu_torch.models import load_model

    from benchmark.kernels.sparse_conv import _matched
    from benchmark.reference import steps as rs
    from benchmark.reference.core.kernel_maps import build_graph as rbuild
    from benchmark.reference.data.device_pipeline import \
        voxelize_per_cloud as rvox

    cell, cfg = _tiny_files(cell_name)
    p = cell["traffic"]
    batch = train.pool(cfg, p, 99, torch.device("cpu"))[0]
    pts = batch[0].reshape(-1, *batch[0].shape[-2:])
    pmask = batch[1].reshape(-1, batch[1].shape[-1])
    _, scfg, _ = train._reference_step(cfg, p, 0, torch.device("cpu"), rs)
    specs = load_model(cfg["model"]["class"]).conv_specs(
        cfg["model"]["conv1_kernel_size"])
    flat = voxelize_per_cloud(pts, pmask, scfg.voxel_size,
                              scfg.nv_cap).flatten()
    graph = build_graph(flat.coords, flat.mask, specs, scfg.level_caps,
                        n_clouds=pts.shape[0])
    rflat = rvox(pts, pmask, scfg.voxel_size, scfg.nv_cap).flatten()
    rgraph = rbuild(rflat.coords, rflat.mask, specs, scfg.level_caps,
                    n_clouds=pts.shape[0])
    checked = 0
    for sp in specs:
        cmap = graph.maps.get(sp.key)
        if cmap is None or sp.is_identity_map:
            continue
        lv = graph.levels[sp.in_stride]
        hit = lookup(lv.skeys, lv.srow, cmap.qkey) >= 0
        assert compacted_rows(hit)[0] == _matched(rgraph, sp), sp.key
        checked += 1
    assert checked >= 10


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", ["gcl.train.b4x7", "fcgf.train.b4pairs",
                                       "gcl.register.sc2pcr",
                                       "fcgf.register.ransac"])
def test_the_control_is_not_correct_on_the_card(cell_name):
    """At the cell's own size: the program's numbers within the limits,
    the control's (the reference in the configuration's lower precision,
    in the program's place) not."""
    import subprocess
    import sys

    from benchmark.check import verdict
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = subprocess.run(
        [sys.executable, "benchmark/calibrate.py", "--workload", cell_name,
         "--seeds", "424242", "--control-seeds", "424242"], cwd=spec.ROOT,
        capture_output=True, text=True, timeout=1800)
    assert p.returncode == 0, p.stderr[-3000:]
    readings = {r["who"]: r for r in map(json.loads,
                                         p.stdout.strip().splitlines())}
    limits = spec.cell(cell_name)["limits"]
    assert verdict(readings["program"], limits)
    assert not verdict(readings["control"], limits)
