"""Run one cell of the benchmark once and print its result.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

(or ``python3 -m benchmark.run ...``) from the root of a checkout that
holds gcl_tpu_torch. The cell's file (``workloads/<cell>.json``) names
its configuration (``configs/<config>.json``) and its runner
(``runners/<kind>.py``); BENCHMARK.json names the metrics the cell
reports, each read by ``metrics/<metric>.py``. With ``--trace 0`` the
result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from a profiled window after the timed one.

The run needs as many CUDA cards as the cell asks for and exits 3
without a result where they are missing. It exits 4 without a result if,
once the window has closed, JAX or the JAX package is loaded. It prints
each number that decides ``correct`` beside its limit, as the last lines
of standard error and under ``checks``, the last key of the result, the
last line of standard output.
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def _process_start() -> float:
    """The process's start on the wall clock (from /proc where it can be
    read, else now)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration):
        return time.time()


_STARTED = _process_start()
_ROOT = Path(__file__).resolve().parent.parent
if str(_ROOT) not in sys.path:
    sys.path.insert(0, str(_ROOT))
# every build and kernel cache at a fixed path inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ[_var] = str(_ROOT / "build" / _sub)
os.environ.setdefault("USE_FLAX", "0")

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "gcl_tpu")


def loaded_forbidden() -> list:
    """Modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


class Context:
    """What a runner gets: the cell, its configuration, the run's
    arguments and the device, and the hooks that time and trace."""

    def __init__(self, cell: dict, config: dict, args, device):
        import torch

        self.cell, self.config = cell, config
        self.seed, self.seconds, self.trace = args.seed, args.seconds, \
            bool(args.trace)
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.setup_s = None

    def note(self, what: str):
        """A line on standard error, stamped with the seconds since the
        process started."""
        print(f"[{time.time() - _STARTED:8.2f} s] {what}", file=sys.stderr,
              flush=True)

    def sync(self):
        if self.on_card:
            import torch
            torch.cuda.synchronize(self.device)

    def start_window(self):
        """Marks the end of set-up: the first timed unit starts now."""
        self.sync()
        self.setup_s = time.time() - _STARTED

    def memory_peak(self) -> int:
        import torch
        return (int(torch.cuda.max_memory_allocated(self.device))
                if self.on_card else 0)

    def free(self):
        import gc

        import torch
        gc.collect()
        if self.on_card:
            torch.cuda.empty_cache()

    def trace_window(self, units):
        from .trace import window
        return window(units) if self.on_card else None

    def note_stretch(self, trace, timed_s_a_unit: float):
        """A line on standard error: the profiled window's wall a unit
        against the timed window's, the profiler's own stretch."""
        if trace:
            a_unit = trace["window_s"] / trace["units"]
            self.note(f"profiled window {a_unit * 1e3:.3f} ms a unit, timed "
                      f"{timed_s_a_unit * 1e3:.3f}: stretch "
                      f"{a_unit / timed_s_a_unit:.4f}")


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def _card_problem(chips: int):
    import torch
    if not torch.cuda.is_available():
        return "no CUDA device: the benchmark measures the card"
    if torch.cuda.device_count() < chips:
        return (f"the cell asks for {chips} cards; "
                f"{torch.cuda.device_count()} visible")
    return None


def main(argv=None, device: str = "cuda") -> int:
    """Run the cell; ``device`` 'cpu' (tests only) skips the look for a
    card and runs the rest of the run on the CPU."""
    from . import spec
    from .check import verdict

    args = parse(argv)
    bench = spec.benchmark()
    cell = spec.cell(args.workload)
    config = spec.config(cell["config"])
    chips = cell.get("chips", 1)
    import torch
    ctx = Context(cell, config, args, device)
    ctx.note("torch imported")
    if device == "cuda":
        problem = _card_problem(chips)
        if problem:
            print(problem, file=sys.stderr)
            return 3
        torch.cuda.init()
        ctx.note("CUDA initialised")
        from gcl_tpu_torch.kernels.build import load_library
        load_library()
        ctx.note("kernel library loaded")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    record = spec.runner(cell["runner"]).run(ctx)
    record["setup_s"] = ctx.setup_s

    found = loaded_forbidden()
    if found:
        print(f"loaded after the window: {', '.join(found)}",
              file=sys.stderr)
        return 4

    limits = cell["limits"]
    numbers = record["numbers"]
    correct = verdict(numbers, limits)
    section = "per_layer" if args.trace else "end_to_end"
    metrics = {}
    for m in spec.metrics_of(bench, cell["name"], section):
        value = spec.reader(m["name"]).read(ctx, record)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = {k: {"value": numbers.get(k, math.nan), "limit": v}
              for k, v in limits.items()}
    for k, v in numbers.items():
        if k not in limits:
            print(f"reading {k}: {v!r} (no limit)", file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    dev_info = {"platform": "gpu" if ctx.on_card else "cpu",
                "kind": (torch.cuda.get_device_name(ctx.device)
                         if ctx.on_card else "cpu"),
                "count": chips,
                "memory_peak_bytes": record["memory_peak_bytes"]}
    out = {"correct": correct, "attempted": record["attempted"],
           "failed": record["failed"], "metrics": metrics,
           "device": dev_info}
    if args.trace and record.get("trace"):
        tr = record["trace"]
        dev_info["busy_s"], dev_info["window_s"] = tr["busy_s"], \
            tr["window_s"]
        out["breakdown"] = tr["breakdown"]
    out["checks"] = checks
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    if __package__ in (None, ""):
        __package__ = "benchmark"
        import benchmark  # noqa: F401
    sys.exit(main())
