"""Training cells: the port's GCL colocation step or FCGF pair step, built
from gcl_tpu_torch/train/steps.py as its trainer builds it, driven closed
loop over a pool of batches drawn from the seed, every step ending in a
synchronize.

Set-up builds one step (model, optimizer state), drives it through its
first ``check_steps`` steps on distinct batches of the pool (these warm
up every shape the window uses) and hands that same step to the window.
After the window the program is freed and the reference follows the
first steps from the same weights, batches and random draws; the check
compares each step's loss, the first gradient as the optimizer got it
(its momentum after one step, less the weight decay) and the parameters'
change over the first steps, each leaf's norm against the reference's."""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import torch

from .. import traffic, weights
from ..check import train_numbers

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def clouds_per_step(cfg: dict, p: dict) -> int:
    """Clouds (scans) the step voxelizes: B x C for a colocation batch, 2
    B for a batch of pairs."""
    return (p["batch"] * p["clouds"] if cfg["train"]["step"] == "colocation"
            else 2 * p["batch"])


def pool(cfg: dict, p: dict, seed: int, dev) -> List[tuple]:
    if cfg["train"]["step"] == "colocation":
        return traffic.colocation_batches(seed, p, dev)
    return traffic.pair_batches(seed, p, dev)


def draws_pool(cfg: dict, p: dict, seed: int, dev, ns) -> List:
    """The random numbers of each pool batch's step, drawn on the device
    from the seed: per-sample jitter gates, conv1's noise and the loss's
    uniforms, in the program's (and the reference's) draw types, ``ns``
    the module of StepDraws / PairDraws / LossDraws / PairLossDraws."""
    gen = traffic.generator(seed, 4, dev)
    st, loss, b = cfg["train"]["step_config"], cfg["train"]["loss"], p["batch"]
    nv = st["nv_cap"]

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    def side(n_clouds):
        return ns.StepDraws(rand(b), (rand(), torch.randn(
            (n_clouds * nv, 1), generator=gen, device=dev)))

    out = []
    for _ in range(p["pool"]):
        if cfg["train"]["step"] == "colocation":
            n = b * p["clouds"] * nv
            groups = b * nv
            d = side(b * p["clouds"])
            m_pos = min(loss["num_pos_per_batch"] * b, groups)
            m_hn = min(loss["num_hn_samples_per_batch"] * b, n)
            out.append(d._replace(loss=ns.LossDraws(rand(m_pos), rand(m_hn),
                                                    rand(m_hn))))
        else:
            n, m = b * nv, b * nv * st["corr_k"]
            out.append(ns.PairDraws(side(b), side(b), ns.PairLossDraws(
                pos=rand(min(loss["num_pos_per_batch"] * b, m)),
                hn0=rand(min(loss["num_hn_samples_per_batch"] * b, n)),
                hn1=rand(min(loss["num_hn_samples_per_batch"] * b, n)))))
    return out


class _Types:
    """The program's draw types."""

    def __init__(self):
        from gcl_tpu_torch.losses.gcl import LossDraws
        from gcl_tpu_torch.losses.pairs import PairLossDraws
        from gcl_tpu_torch.train.steps import PairDraws, StepDraws
        self.LossDraws, self.PairLossDraws = LossDraws, PairLossDraws
        self.StepDraws, self.PairDraws = StepDraws, PairDraws


def build_program(cfg: dict, p: dict, seed: int, dev):
    """(model, optimizer, step_fn) of the port, as its trainer builds them
    from the configuration's run config; raises where the port's step
    settings differ from the ones the configuration file states."""
    from gcl_tpu_torch.config import default_config
    from gcl_tpu_torch.losses.gcl import GCLLossConfig
    from gcl_tpu_torch.models import load_model
    from gcl_tpu_torch.train import steps
    from gcl_tpu_torch.train.trainer import step_config

    tr = cfg["train"]
    rc = default_config(**tr["run_config"])
    model_cls = load_model(rc.model)
    model = model_cls(1, rc.model_n_out, bn_momentum=rc.bn_momentum,
                      conv1_kernel_size=rc.conv1_kernel_size,
                      normalize_feature=rc.normalize_feature, D=3)
    model.load_state_dict(weights.random_state(weights.shapes_of(model),
                                               seed, dev))
    model.to(dev)
    specs = model_cls.conv_specs(rc.conv1_kernel_size)
    per_side = (clouds_per_step(cfg, p) if tr["step"] == "colocation"
                else p["batch"])
    scfg = step_config(rc, per_side * rc.voxel_capacity)
    _same_settings(scfg, tr["step_config"])
    for k, v in tr["loss"].items():
        if k != "kind" and k in rc and rc[k] != v:
            raise SystemExit(f"the port's loss setting {k} is {rc[k]!r}; "
                             f"the configuration states {v!r}")
    loss, b = tr["loss"], p["batch"]
    if tr["step"] == "colocation":
        grad_fn = steps.make_gcl_grad_fn(
            model, specs, scfg, GCLLossConfig(**{
                k: loss[k] for k in (
                    "pos_thresh", "finest_thresh", "neg_thresh",
                    "square_loss", "block_finest_gradient",
                    "use_hard_negative", "use_pair_group_positive_loss",
                    "safe_radius")}),
            loss["kind"], max_pos_cluster=loss["num_pos_per_batch"] * b,
            max_hn_samples=loss["num_hn_samples_per_batch"] * b,
            pos_weight=loss["pos_weight"], finest_weight=loss["finest_weight"],
            neg_weight=loss["neg_weight"], jitter=loss["jitter_feats"])
    else:
        grad_fn = steps.make_pair_grad_fn(model, specs, scfg, loss["kind"],
                                          dict(rc))
    opt = steps.make_optimizer(model.parameters(), scfg)
    return model, opt, steps.make_train_step_from_grad(opt, grad_fn,
                                                        tr["prefix"])


def _same_settings(scfg, stated: dict) -> None:
    """Raise unless the port's StepConfig holds the settings stated."""
    have = dataclasses.asdict(scfg)
    for k, v in stated.items():
        if k == "level_cap_shrink":
            continue
        got = have[k]
        if k == "compute_dtype":
            got = {torch.float32: "float32", torch.bfloat16: "bfloat16"}[got]
        if got != v:
            raise SystemExit(f"the port's step setting {k} is {got!r}; the "
                             f"configuration states {v!r}")


def _snapshot(model) -> Dict[str, torch.Tensor]:
    return {n: p.detach().clone() for n, p in model.named_parameters()}


def _first_gradients(model, opt, p0, wd: float) -> Dict[str, torch.Tensor]:
    """The first step's gradient as the optimizer got it: its momentum
    buffer after that step, less the weight decay term (zero where the
    optimizer holds none: it took no step)."""
    out = {}
    for n, p in model.named_parameters():
        buf = opt.state.get(p, {}).get("momentum_buffer")
        out[n] = (torch.zeros_like(p) if buf is None
                  else buf - wd * p0[n])
    return out


def first_steps(ctx):
    """Build the program and drive it through the cell's first steps on
    distinct batches of the pool (they warm up every shape the window
    uses). Returns (step, batches, draws, what the check keeps of the
    first steps: {"loss", "grad", "p0", "p"} on the host)."""
    cfg, p, dev, seed = ctx.config, ctx.cell["traffic"], ctx.device, ctx.seed
    tr = cfg["train"]
    model, opt, step = build_program(cfg, p, seed, dev)
    ctx.note("program built")
    batches = pool(cfg, p, seed, dev)
    draws = draws_pool(cfg, p, seed, dev, _Types())
    ctx.note("pool drawn")
    lr, wd = tr["lr"], tr["step_config"]["weight_decay"]
    p0 = _snapshot(model)
    losses, grads = [], None
    for i in range(ctx.cell["check_steps"]):
        metrics = step(lr, *batches[i % len(batches)],
                       draws=draws[i % len(draws)])
        losses.append(float(metrics["loss"]))
        if i == 0:
            grads = {n: g.cpu() for n, g in
                     _first_gradients(model, opt, p0, wd).items()}
    ctx.sync()
    kept = {"loss": losses, "grad": grads,
            "p0": {n: t.cpu() for n, t in p0.items()},
            "p": {n: t.cpu() for n, t in _snapshot(model).items()}}
    ctx.note(f"first {len(losses)} steps done, losses {losses}")
    return step, batches, draws, kept


def run(ctx) -> dict:
    """One run of a training cell (see the module's docstring)."""
    cfg, p, dev, seed = ctx.config, ctx.cell["traffic"], ctx.device, ctx.seed
    lr = cfg["train"]["lr"]
    n_check = ctx.cell["check_steps"]
    step, batches, draws, kept = first_steps(ctx)
    scans = clouds_per_step(cfg, p)

    # the window: steps back to back, each ending in a synchronize
    ctx.start_window()
    done = failed = 0
    i = n_check
    t0 = time.perf_counter()
    while True:
        metrics = step(lr, *batches[i % len(batches)],
                       draws=draws[i % len(draws)])
        ctx.sync()
        done += 1
        failed += int(not bool(torch.isfinite(metrics["loss"])))
        i += 1
        elapsed = time.perf_counter() - t0
        if elapsed >= ctx.seconds:
            break
    record = {"attempted": done, "failed": failed,
              "window": {"seconds": elapsed, "steps": done,
                         "scans": done * scans}}
    ctx.note(f"window: {done} steps in {elapsed:.3f} s")
    if ctx.trace:
        units = []
        for _ in range(ctx.cell["trace_units"]):
            b_i, d_i = batches[i % len(batches)], draws[i % len(draws)]
            units.append(lambda b_i=b_i, d_i=d_i: step(lr, *b_i, draws=d_i))
            i += 1
        record["trace"] = ctx.trace_window(units)
        ctx.note_stretch(record["trace"], elapsed / done)
    record["memory_peak_bytes"] = ctx.memory_peak()

    del step, metrics
    check_batches = [batches[k % len(batches)] for k in range(n_check)]
    check_draws = [draws[k % len(draws)] for k in range(n_check)]
    work_batches = batches
    del batches, draws
    ctx.free()
    ctx.note("reference starts")
    ref = reference_steps(cfg, p, seed, dev, check_batches, check_draws)
    ctx.note(f"reference done, losses {ref['loss']}")
    record["numbers"] = train_numbers(kept, ref)
    if ctx.trace and ctx.on_card:
        record["work"] = step_work(cfg, p, dev, work_batches)
    return record


def reference_steps(cfg: dict, p: dict, seed: int, dev, batches, draws,
                    precision: Optional[str] = None,
                    keep: Optional[int] = None) -> dict:
    """The reference's first steps over ``batches`` with ``draws``, from
    the seed's weights: {"loss" [per step], "grad" (first step, by
    parameter name), "p0", "p" (after the steps)}, on the host.
    ``precision`` runs it in that lower precision (the control, see
    benchmark/precision.py); ``keep`` hands each step only the first
    ``keep`` samples of its batch (a fault: half the batch left out)."""
    from ..precision import lower
    from ..reference import steps as rs

    model, scfg, grad_fn = _reference_step(cfg, p, seed, dev, rs)
    params = [q for _, q in model.named_parameters()]
    names = [n for n, _ in model.named_parameters()]
    p0 = {n: q.detach().cpu().clone() for n, q in zip(names, params)}
    momenta = [None] * len(params)
    tr = cfg["train"]
    losses, grads = [], None
    with lower(precision):
        for k, (batch, d) in enumerate(zip(batches, draws)):
            if keep is not None:
                batch, d = _first_samples(cfg, batch, d, keep, rs)
            d = _as_reference_draws(cfg, d, rs)
            metrics = grad_fn(*batch, draws=d)
            losses.append(float(metrics["loss"]))
            if k == 0:
                grads = {n: q.grad.detach().cpu().clone()
                         for n, q in zip(names, params)}
            rs.sgd_step(params, momenta, tr["lr"], scfg.momentum,
                        scfg.weight_decay)
    out = {"loss": losses, "grad": grads, "p0": p0,
           "p": {n: q.detach().cpu().clone() for n, q in zip(names, params)}}
    del model, grad_fn, params, momenta
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def _reference_step(cfg: dict, p: dict, seed: int, dev, rs):
    """(model, StepConfig, grad_fn) of the reference at the configuration's
    stated settings, in float32."""
    from ..reference.core.kernel_maps import default_level_caps
    from ..reference.losses.gcl import GCLLossConfig
    from ..reference.models import MODELS

    tr = cfg["train"]
    m = cfg["model"]
    model_cls = MODELS[m["class"]]
    model = model_cls(1, m["out_channels"], bn_momentum=m["bn_momentum"],
                      conv1_kernel_size=m["conv1_kernel_size"],
                      normalize_feature=m["normalize_feature"], D=3)
    model.load_state_dict(weights.random_state(weights.shapes_of(model),
                                               seed, dev))
    model.to(dev)
    specs = model_cls.conv_specs(m["conv1_kernel_size"])
    st = dict(tr["step_config"])
    strides = sorted({s for sp in specs
                      for s in (sp.in_stride, sp.out_stride)})
    per_side = (clouds_per_step(cfg, p) if tr["step"] == "colocation"
                else p["batch"])
    caps = default_level_caps(per_side * st["nv_cap"], strides,
                              st.pop("level_cap_shrink"))
    st["compute_dtype"] = torch.float32
    scfg = rs.StepConfig(level_caps=caps, **st)
    loss, b = tr["loss"], p["batch"]
    if tr["step"] == "colocation":
        grad_fn = rs.make_gcl_grad_fn(
            model, specs, scfg, GCLLossConfig(**{
                k: loss[k] for k in (
                    "pos_thresh", "finest_thresh", "neg_thresh",
                    "square_loss", "block_finest_gradient",
                    "use_hard_negative", "use_pair_group_positive_loss",
                    "safe_radius")}),
            loss["kind"], max_pos_cluster=loss["num_pos_per_batch"] * b,
            max_hn_samples=loss["num_hn_samples_per_batch"] * b,
            pos_weight=loss["pos_weight"], finest_weight=loss["finest_weight"],
            neg_weight=loss["neg_weight"], jitter=loss["jitter_feats"])
    else:
        grad_fn = rs.make_pair_grad_fn(model, specs, scfg, loss["kind"], {
            "batch_size": b, **loss})
    return model, scfg, grad_fn


def _as_reference_draws(cfg: dict, d, rs):
    """The same numbers in the reference's draw types."""
    from ..reference.losses.gcl import LossDraws
    from ..reference.losses.pairs import PairLossDraws

    def side(s):
        return rs.StepDraws(s.sample_gate_u, s.jitter)

    if cfg["train"]["step"] == "colocation":
        return rs.StepDraws(d.sample_gate_u, d.jitter,
                            LossDraws(*d.loss))
    return rs.PairDraws(side(d.side0), side(d.side1),
                        PairLossDraws(*d.loss))


def _first_samples(cfg: dict, batch, d, keep: int, rs):
    """The first ``keep`` samples of a batch and their draws."""
    if cfg["train"]["step"] == "colocation":
        c = batch[0].shape[1]
        rows = keep * c * cfg["train"]["step_config"]["nv_cap"]
        gate_u, normal = d.jitter
        return (tuple(t[:keep] for t in batch),
                d._replace(sample_gate_u=d.sample_gate_u[:keep],
                           jitter=(gate_u, normal[:rows])))
    rows = keep * cfg["train"]["step_config"]["nv_cap"]

    def side(s):
        return s._replace(sample_gate_u=s.sample_gate_u[:keep],
                          jitter=(s.jitter[0], s.jitter[1][:rows]))

    return (tuple(t[:keep] for t in batch),
            d._replace(side0=side(d.side0), side1=side(d.side1)))


def step_work(cfg: dict, p: dict, dev, batches) -> dict:
    """The sparse convs' work in a step, the mean over the pool's
    ``batches``, counted from the reference's maps: the model's operations
    (forward, dX but conv1's, dW) and the least time of the conv family's
    calls."""
    from ..kernels import peaks
    from ..kernels.sparse_conv import conv_calls, least_seconds
    from ..reference.core.kernel_maps import build_graph
    from ..reference.data.device_pipeline import voxelize_per_cloud
    from ..reference import steps as rs

    model, scfg, _ = _reference_step(cfg, p, 0, dev, rs)
    specs = type(model).conv_specs(cfg["model"]["conv1_kernel_size"])
    dtype = cfg["train"]["step_config"]["compute_dtype"]
    pk = peaks()
    peak = cfg["peaks"]["train_flops"]
    elt = 2 if dtype == "bfloat16" else 4
    sides = []
    for batch in batches:
        if cfg["train"]["step"] == "colocation":
            points, pmask = batch[0], batch[1]
            sides.append((points.reshape(-1, *points.shape[2:]),
                          pmask.reshape(-1, pmask.shape[-1])))
        else:
            sides += [(batch[0], batch[1]), (batch[2], batch[3])]
    calls = []
    with torch.no_grad():
        for pts, pm in sides:
            vox = voxelize_per_cloud(pts, pm, scfg.voxel_size, scfg.nv_cap)
            flat = vox.flatten()
            graph = build_graph(flat.coords, flat.mask, specs,
                                scfg.level_caps, n_clouds=pts.shape[0],
                                method=scfg.graph_method)
            calls += conv_calls(model, graph, elt, backward=True)
    fam = [c for c in calls if c["family"]]
    n = len(batches)
    return {"model_flops": sum(c["flops"] for c in calls) / n,
            "family_least_s": sum(least_seconds(c, peak, pk["hbm_bytes_per_s"])
                                  for c in fam) / n,
            "peak_flops": peak}
