"""The readings that a cell's limits of ``correct`` are set from, on the
card at the cell's own size (the benchmark's own runs never run this;
without a card it exits 3 and prints nothing):

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,... \\
        [--control-seeds 1,2,3]

For each seed, the program's numbers: training cells drive the program
through the cell's first steps and hold them to the reference, as a run
does before its window; registration cells register the run's sample of
pairs. For each control seed, the control's numbers: the reference
computed in the configuration's lower precision (``control`` in its
file) put in the program's place; for training cells also the fault of
a step that sees half its batch, planted in the reference put in the
program's place. One JSON line a reading on standard output."""
from __future__ import annotations

import argparse
import json
import random
import sys
from pathlib import Path

if __package__ in (None, ""):
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    __package__ = "benchmark"
    import benchmark  # noqa: F401

from . import run as runner  # noqa: E402


def emit(**kw):
    print(json.dumps(kw), flush=True)


def train(ctx, seeds, control_seeds):
    from .check import train_diagnostics, train_numbers
    from .runners import train as drv

    cfg, p = ctx.config, ctx.cell["traffic"]
    n = ctx.cell["check_steps"]
    for seed in seeds:
        ctx.seed = seed
        step, batches, draws, kept = drv.first_steps(ctx)
        batches = [batches[k % len(batches)] for k in range(n)]
        draws = [draws[k % len(draws)] for k in range(n)]
        del step
        ctx.free()
        ref = drv.reference_steps(cfg, p, seed, ctx.device, batches, draws)
        emit(seed=seed, who="program", **train_numbers(kept, ref),
             look=train_diagnostics(kept, ref))
        if seed in control_seeds:
            ctl = drv.reference_steps(cfg, p, seed, ctx.device, batches,
                                      draws, cfg["control"]["train"])
            emit(seed=seed, who="control", **train_numbers(ctl, ref),
                 look=train_diagnostics(ctl, ref))
            half = drv.reference_steps(cfg, p, seed, ctx.device, batches,
                                       draws, keep=p["batch"] // 2)
            emit(seed=seed, who="fault.half_batch",
                 **train_numbers(half, ref), look=train_diagnostics(half, ref))
        ctx.free()


def register(ctx, seeds, control_seeds):
    from . import traffic
    from .runners import register as drv

    cell = ctx.cell
    for seed in seeds:
        ctx.seed = seed
        extract = drv.build_program(ctx.config, seed, ctx.device)
        from gcl_tpu_torch.reg import sc2pcr
        matcher = (drv._matcher(ctx.config, sc2pcr)
                   if cell["estimator"]["kind"] == "sc2pcr" else None)
        pool = traffic.registration_pairs(seed, cell["traffic"], ctx.device)
        pair = drv.PAIRS[cell["estimator"]["kind"]]
        off = drv._Spans(ctx)
        keep_at = sorted(random.Random(seed).sample(
            range(cell["check_within"]), cell["check_pairs"]))
        kept = {i: pair(ctx, cell, ctx.config, extract, matcher,
                        pool[i % len(pool)], i, off) for i in keep_at}
        del extract
        ctx.free()
        emit(seed=seed, who="program", **drv.check_pairs(ctx, kept, pool))
        if seed in control_seeds:
            ctl = {i: drv.reference_pair(ctx, pool[i % len(pool)], i,
                                         ctx.config["control"]["register"])
                   for i in keep_at}
            emit(seed=seed, who="control", **drv.check_pairs(ctx, ctl, pool))
        ctx.free()


def main(argv=None):
    import torch

    from . import spec

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    a = ap.parse_args(argv)
    seeds = [int(s) for s in a.seeds.split(",")]
    control = {int(s) for s in a.control_seeds.split(",") if s}
    cell = spec.cell(a.workload)
    config = spec.config(cell["config"])
    problem = runner._card_problem(cell.get("chips", 1))
    if problem:
        print(problem, file=sys.stderr)
        return 3
    from gcl_tpu_torch.kernels.build import load_library
    load_library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    args = argparse.Namespace(seed=seeds[0], seconds=0, trace=0)
    ctx = runner.Context(cell, config, args, "cuda")
    {"train": train, "register": register}[cell["runner"]](ctx, seeds,
                                                           control)
    return 0


if __name__ == "__main__":
    sys.exit(main())
