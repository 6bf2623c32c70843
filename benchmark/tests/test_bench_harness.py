"""The harness on the CPU: its files, its arithmetic, and whole runs of a
tiny copy of the benchmark (the look for a card skipped), sound and with
the program broken underneath."""
from __future__ import annotations

import ast
import json
import math
import statistics
from pathlib import Path

import pytest

from benchmark import spec, stats
from benchmark.check import pose_gaps, train_numbers, verdict
from benchmark.kernels.sparse_conv import least_seconds
from benchmark.tests import _tiny

BENCH = spec.benchmark()
ALLOWED = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves",
                  "workloads"},
}


def test_every_file_parses_and_names_existing_parts():
    assert spec.problems(BENCH) == []
    for name in spec.cells():
        cell = spec.cell(name)
        spec.config(cell["config"])
        assert (spec.HERE / "runners" / f"{cell['runner']}.py").is_file()
        for m in spec.metrics_of(BENCH, name, "end_to_end") + \
                spec.metrics_of(BENCH, name, "per_layer"):
            assert hasattr(spec.reader(m["name"]), "read")
    assert spec.kernel_family("sparse_conv")["patterns"]


def test_names_units_and_keys_are_allowed():
    assert set(BENCH) == ALLOWED["top"]
    assert (spec.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[section]:
            assert set(entry) <= ALLOWED[section], entry
            assert spec.NAME.match(entry["name"]), entry["name"]
            for key in ("why", "layer", "source"):
                if key in entry and section in ("configs", "workloads",
                                                "per_layer"):
                    assert 1 <= len(entry[key]) <= 200
                    assert "\n" not in entry[key] and "\t" not in entry[key]
            if "unit" in entry:
                assert spec.UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            if section == "end_to_end":
                assert 0.01 <= entry["bound"] <= 0.25
                assert entry["source"] in ("host_clock", "device_trace")
    for c in BENCH["configs"]:
        assert all(spec.NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("benchmark/")
    for p in spec.HERE.rglob("*"):
        rel = p.relative_to(spec.ROOT).as_posix()
        assert all(ch.isalnum() or ch in "_.-/" for ch in rel), rel


def test_rate_and_tail_by_hand():
    assert stats.rate(28 * 40, 10.0) == 112.0
    lat = [float(i) for i in range(1, 201)]          # 1 .. 200 ms
    assert stats.percentile(lat, 95) == (190.0, 10)  # 10 samples beyond
    assert stats.percentile([5.0], 95) == (5.0, 0)
    with pytest.raises(ValueError):
        stats.rate(1, 0)


def test_spread_takes_pythons_quartiles():
    v = [10.0, 11.0, 12.0, 13.0, 14.0, 15.0]
    q1, _, q3 = statistics.quantiles(v, n=4)        # 10.75, 14.25
    assert stats.spread(v) == pytest.approx((q3 - q1) / 12.5)


def test_union_of_device_intervals_by_hand():
    spans = [(0, 10), (5, 12), (20, 25), (21, 22), (30, 30)]
    assert stats.union_length(spans) == 12 + 5
    assert stats.gaps(spans, 0, 40) == [(12, 20), (25, 40)]


@pytest.mark.parametrize("name", ["device_idle_share.train",
                                  "device_idle_share.register"])
def test_idle_share_reads_the_trace_alone_by_hand(name):
    reader = spec.reader(name)
    # the timed window's wall has no say: both numbers are the trace's
    record = {"trace": {"busy_s": 0.3, "window_s": 0.4, "units": 4},
              "window": {"seconds": 1.0, "steps": 1, "pairs": 1}}
    assert reader.read(None, record) == pytest.approx(0.25)
    assert reader.read(None, {"window": record["window"]}) is None
    assert reader.read(None, {"trace": {**record["trace"],
                                        "busy_s": 0.0}}) is None


def test_mfu_and_roofline_sums_by_hand():
    mfu = spec.reader("step_mfu.train")
    record = {"work": {"model_flops": 2e12, "family_least_s": 0.01,
                       "peak_flops": 1e15},
              "window": {"steps": 40, "seconds": 10.0},
              "trace": {"units": 4, "kernel_s": {
                  "void gg::gather_gemm_kernel<float>(...)": 0.3,
                  "void sk::splitk_dw_kernel<float>(...)": 0.1,
                  "void at::native::reduce_kernel<...>": 5.0}}}
    # 40 steps x 2 TFLOP over 10 s x 1 PFLOP/s
    assert mfu.read(None, record) == pytest.approx(0.8)
    roof = spec.reader("conv_roofline.train")
    # 4 steps x 10 ms least time over 0.4 s of the family's kernels
    assert roof.read(None, record) == pytest.approx(10.0)
    call = {"flops": 2e9, "bytes": 6.7e6}
    assert least_seconds(call, 1e12, 3.35e12) == pytest.approx(2e-3)
    assert least_seconds(call, 1e15, 3.35e12) == pytest.approx(2e-6)


def test_train_numbers_by_hand():
    import torch
    ref = {"loss": [2.0, 1.0], "grad": {"a": torch.tensor([3.0, 4.0]),
                                        "b": torch.tensor([0.0, 1.0]),
                                        "c": torch.tensor([1e-6, 0.0])},
           "p0": {k: torch.zeros(2) for k in "abc"},
           "p": {"a": torch.tensor([0.6, 0.8]), "b": torch.tensor([0.0, 2.0]),
                 "c": torch.tensor([5.0, 0.0])}}
    prog = {"loss": [2.2, 1.0],
            "grad": {"a": torch.tensor([3.0, 4.5]), "b": ref["grad"]["b"],
                     "c": ref["grad"]["c"]},
            "p0": ref["p0"],
            "p": {"a": torch.tensor([0.6, 0.8]), "b": torch.tensor([0.0, 1.0]),
                  "c": torch.tensor([0.0, 0.0])}}
    n = train_numbers(prog, ref)
    assert n["loss_gap"] == pytest.approx(0.1)
    # leaf a: |sqrt(29.25) - 5| / max(5, median 1)
    assert n["grad_gap"] == pytest.approx((math.sqrt(29.25) - 5) / 5)
    # leaf c moves by round-off alone (gradient under 1e-3 of the median)
    # and is left out; leaf b: |1 - 2| / max(2, median 1)
    assert n["update_gap"] == pytest.approx(0.5)
    assert not verdict(n, {"loss_gap": 0.05})
    assert verdict(n, {"loss_gap": 0.2})
    assert not verdict({"x": math.nan}, {"x": 1.0})


def test_pose_gaps_by_hand():
    import torch
    a = torch.eye(4)
    b = torch.eye(4)
    th = math.radians(2.0)
    b[:2, :2] = torch.tensor([[math.cos(th), -math.sin(th)],
                              [math.sin(th), math.cos(th)]])
    b[:3, 3] = torch.tensor([0.3, 0.4, 0.0])
    dt, dr = pose_gaps(a, b)
    assert dt == pytest.approx(0.5)
    assert dr == pytest.approx(2.0, rel=1e-5)


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return _tiny.make(tmp_path_factory.mktemp("tiny"))


def _copy_cell(root: Path, old: str, new: str) -> None:
    """A later PR's cell: a copy of a cell file under a new name, and its
    BENCHMARK.json entries, no code."""
    wl = root / "benchmark" / "workloads"
    (wl / f"{new}.json").write_text((wl / f"{old}.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    entry = dict(next(w for w in bench["workloads"] if w["name"] == old))
    bench["workloads"].append({**entry, "name": new, "traffic": new})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if old in m.get("workloads", []):
            m["workloads"].append(new)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))


@pytest.mark.parametrize("old", ["gcl.train.b4x7", "fcgf.register.ransac"])
def test_copied_cell_runs_with_no_code_edit(tiny, old):
    new = old + "_copy"
    _copy_cell(tiny, old, new)
    bench = json.loads((tiny / "BENCHMARK.json").read_text())
    assert spec.problems(bench, tiny / "benchmark") == []
    assert new in spec.cells(tiny / "benchmark")
    rc, result, err = _tiny.run_cell(tiny, new)
    assert rc == 0, err[-3000:]
    assert result["correct"] is True, err[-3000:]
    want = {m["name"] for m in spec.metrics_of(bench, new, "end_to_end")}
    assert set(result["metrics"]) == want
    assert list(result)[-1] == "checks"
    assert err.strip().splitlines()[-1].startswith("check ")


def test_no_jax_after_a_run_and_reference_imports_no_port(tiny):
    probe = ("import atexit, sys\n"
             "atexit.register(lambda: print('MODULES', sorted({m.split('.')[0]"
             " for m in sys.modules}), file=sys.stderr))")
    rc, result, err = _tiny.run_cell(tiny, "gcl.register.sc2pcr",
                                     prelude=probe)
    assert rc == 0, err[-3000:]
    line = next(x for x in err.splitlines() if x.startswith("MODULES"))
    tops = set(ast.literal_eval(line[len("MODULES "):]))
    assert not tops & {"jax", "jaxlib", "flax", "gcl_tpu"}
    assert "benchmark" in tops and "gcl_tpu_torch" in tops
    for path in (spec.HERE / "reference").rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in (
                    "gcl_tpu_torch", "gcl_tpu", "jax", "jaxlib", "flax"), \
                    f"{path}: imports {n}"


FAULTS = {
    # a step that returns its state unchanged: the update is skipped
    "frozen_step": ("gcl.train.b4x7", """
import gcl_tpu_torch.train.steps as s
def _frozen(opt, grad_fn, stage='gcl'):
    def step_fn(lr, *batch, generator=None, draws=None):
        return grad_fn(*batch, generator=generator, draws=draws)
    return step_fn
s.make_train_step_from_grad = _frozen
"""),
    # half of the batch left out, the mean taken over the rest
    "half_batch": ("fcgf.train.b4pairs", """
import gcl_tpu_torch.train.steps as s
_make = s.make_pair_grad_fn
def _half(*a, **k):
    g = _make(*a, **k)
    def grad_fn(p0, m0, p1, m1, t, r, generator=None, draws=None):
        h = p0.shape[0] // 2
        rows = h * draws.side0.jitter[1].shape[0] // p0.shape[0]
        side = lambda d: d._replace(sample_gate_u=d.sample_gate_u[:h],
                                    jitter=(d.jitter[0], d.jitter[1][:rows]))
        return g(p0[:h], m0[:h], p1[:h], m1[:h], t[:h], r[:h],
                 generator=generator,
                 draws=draws._replace(side0=side(draws.side0),
                                      side1=side(draws.side1)))
    return grad_fn
s.make_pair_grad_fn = _half
"""),
    # an answer altered where it is produced: the transform
    "moved_answer": ("gcl.register.sc2pcr", """
import gcl_tpu_torch.infer as inf
_reg = inf.register_pair
def _moved(*a, **k):
    t, vox, f = _reg(*a, **k)
    t = t.clone(); t[0, 3] += 0.5
    return t, vox, f
inf.register_pair = _moved
"""),
    # an answer altered where it is produced: the features
    "bent_features": ("fcgf.register.ransac", """
import gcl_tpu_torch.infer as inf
_make = inf.make_feature_extractor
def _bent(*a, **k):
    ex = _make(*a, **k)
    def extract(points, pmask):
        vox, f = ex(points, pmask)
        return vox, f * 1.01
    return extract
inf.make_feature_extractor = _bent
"""),
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_program_is_not_correct(tiny, fault):
    cell, prelude = FAULTS[fault]
    rc, result, err = _tiny.run_cell(tiny, cell)
    assert rc == 0 and result["correct"] is True, err[-3000:]
    rc, result, err = _tiny.run_cell(tiny, cell, prelude=prelude)
    assert rc == 0, err[-3000:]
    assert result["correct"] is False, result["checks"]


def test_the_run_refuses_without_a_card(tmp_path):
    import subprocess
    import sys
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the refusal is not reachable here")
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        "gcl.train.b4x7", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=spec.ROOT, capture_output=True,
                       text=True, timeout=300)
    assert p.returncode != 0 and p.stdout.strip() == ""


@pytest.mark.cuda
def test_each_cell_runs_correct_on_the_card():
    import subprocess
    import sys
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for w in BENCH["workloads"]:
        p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                            w["name"], "--seed", "12345", "--seconds", "3",
                            "--trace", "0"], cwd=spec.ROOT,
                           capture_output=True, text=True, timeout=900)
        assert p.returncode == 0, p.stderr[-3000:]
        assert json.loads(p.stdout.strip().splitlines()[-1])["correct"]
