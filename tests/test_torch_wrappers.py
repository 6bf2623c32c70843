"""The port's eight shell wrappers (gcl_tpu_torch/scripts/*.sh) against
the root ones (scripts/*.sh): each pair is run with `python` and `date`
stubbed on PATH, each from a temporary working directory (the root
ones from one holding a copy of scripts/, as they call `bash scripts/...`
and `python scripts/test_kitti.py` relative to it), with the defaults and
with every environment variable and argument overridden.

The argv the stub receives must be equal once the root wrappers'
`train.py` reads `-m gcl_tpu_torch.train` and `scripts/test_kitti.py`
reads `-m gcl_tpu_torch.eval_kitti`; the OUT_DIR (a directory under the
working directory), the log file in it and the log's lines (the working
directory aside) must be equal too, and so must the environment the
entry point sees.
"""
import os
import shutil
import subprocess

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WRAPPERS = [f"{kind}_{model}_{data}.sh" for kind in ("train", "test")
            for model in ("gcl", "fcgf") for data in ("kitti", "nuscenes")]
ENTRY = {"train.py": ["-m", "gcl_tpu_torch.train"],
         "scripts/test_kitti.py": ["-m", "gcl_tpu_torch.eval_kitti"]}
STAMP = "2026-01-02_03-04-05"
SEEN_ENV = ("PYTHONUNBUFFERED", "OUT_DIR", "SAVE_DIR", "KITTI_PATH",
            "NUSCENES_PATH", "MISC_ARGS", "PATH_POSTFIX", "DATASET",
            "TRAIN_DATASET")
OVERRIDES = {
    "KITTI_PATH": "/d/kitti", "NUSCENES_PATH": "/d/nusc",
    "DATASET": "PairComplementKittiDataset",
    "TRAIN_DATASET": "ColocationKittiDataset",
    "TRAINER": "HardestContrastiveLossTrainer", "MODEL": "ResUNetBN2C",
    "MODEL_N_OUT": "16", "OPTIMIZER": "Adam", "LR": "0.05",
    "LOSS_RATIO": "1e-3", "WEIGHT_DECAY": "0", "MAX_EPOCH": "3",
    "BATCH_SIZE": "2", "VAL_BATCH_SIZE": "2", "ITER_SIZE": "2",
    "BEST_VAL_METRIC": "rte", "VOXEL_SIZE": "0.25",
    "POSITIVE_PAIR_SEARCH_VOXEL_SIZE_MULTIPLIER": "2",
    "CONV1_KERNEL_SIZE": "3", "EXP_GAMMA": "0.9", "RANDOM_SCALE": "False",
    "LoKITTI": "true", "LoNUSCENES": "true", "USE_RANSAC": "true",
    "PAIR_MIN_DIST": "3", "PAIR_MAX_DIST": "9"}

_PYTHON = """#!/bin/sh
printf '%s\\n' "$@" > "$STUB_OUT/argv"
for v in {env}; do eval "printf '%s=%s\\n' $v \\"\\${{$v-unset}}\\"" ; done \
    > "$STUB_OUT/env"
echo "entry point ran"
"""


@pytest.fixture(scope="module")
def stubs(tmp_path_factory):
    d = tmp_path_factory.mktemp("stubs")
    (d / "python").write_text(_PYTHON.format(env=" ".join(SEEN_ENV)))
    (d / "date").write_text(f"#!/bin/sh\necho {STAMP}\n")
    for f in ("python", "date"):
        os.chmod(d / f, 0o755)
    return d


def _run(script, cwd, out, stubs, env, args):
    os.makedirs(out)
    full = {**{k: v for k, v in os.environ.items() if k not in OVERRIDES},
            **env, "PATH": f"{stubs}:{os.environ['PATH']}",
            "STUB_OUT": str(out)}
    res = subprocess.run(["bash", script, *args], cwd=cwd, env=full,
                         capture_output=True, text=True, timeout=60)
    assert res.returncode == 0, res.stderr
    argv = (out / "argv").read_text().splitlines()
    seen = (out / "env").read_text().splitlines()
    logs = sorted(os.path.relpath(os.path.join(d, f), cwd)
                  for d, _, fs in os.walk(cwd / "outputs") for f in fs)
    lines = [open(os.path.join(cwd, p)).read().replace(str(cwd), "<cwd>")
             for p in logs]
    return argv, seen, logs, lines, res.stdout.replace(str(cwd), "<cwd>")


@pytest.mark.parametrize("overridden", [False, True],
                         ids=["defaults", "overridden"])
@pytest.mark.parametrize("name", WRAPPERS)
def test_wrapper_hands_the_root_argv(tmp_path, stubs, name, overridden):
    env = OVERRIDES if overridden else {}
    args = ["/runs/x" if name.startswith("test") else "_postfix",
            "--device cpu --stat_freq 7"] if overridden else []
    if name.startswith("test") and not overridden:
        args = ["/runs/x"]
    ref_cwd, our_cwd = tmp_path / "ref", tmp_path / "ours"
    shutil.copytree(os.path.join(REPO, "scripts"), ref_cwd / "scripts",
                    ignore=shutil.ignore_patterns("*.py", "SC2_PCR"))
    our_cwd.mkdir()
    ref = _run(f"scripts/{name}", ref_cwd, tmp_path / "ref_out", stubs, env,
               args)
    ours = _run(os.path.join(REPO, "gcl_tpu_torch", "scripts", name),
                our_cwd, tmp_path / "our_out", stubs, env, args)
    ref_argv = ENTRY[ref[0][0]] + ref[0][1:]
    assert ours[0] == ref_argv
    assert ours[1:] == ref[1:]  # environment, logs and their lines, stdout
    if name.startswith("train"):
        (log,) = ours[2]
        out_dir = ours[0][ours[0].index("--out_dir") + 1]
        assert log == os.path.normpath(f"{out_dir}/log_{STAMP}.txt")
        assert out_dir.startswith("./outputs/Experiments/")
        assert "entry point ran" in ours[3][0]
    else:
        assert ours[2] == [] and ours[0][:4] == [
            "-m", "gcl_tpu_torch.eval_kitti", "--save_dir", args[0]]
    if overridden:
        assert "--device" in ours[0] and "cpu" in ours[0]
