"""Smoke run of gcl_tpu_torch's serving path, its FCGF evaluation path, its
GCL train steps (the implicit and the explicit conv-map route, in float32
and in bf16), its FCGF train step, its training entry point, its
data-parallel steps, the rest of its model zoo, its other entry points
(the demo, the ETH evaluation, the SC2-PCR benchmark), its host C++
library and nuScenes data path, and its shell wrappers on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure raises and the exit code is non-zero:

1. device: requires CUDA (there is no CPU run), turns TF32 off for
   float32 matmuls and convolutions, prints the card's name and power
   limit;
2. build: compiles the CUDA kernels from gcl_tpu_torch/csrc with nvcc;
3. serving kernels: runs K6 and K2 against their plain PyTorch versions on
   the card at the serving path's shapes (two synthetic 65,536-point LiDAR
   clouds, voxel 0.3 m): K6 for every k=3 conv of ResUNetFatBN at its real
   Cin / Cout (rtol = atol = 1e-4), K2 on conv1 (out within 1e-5, sbits
   exact), and times both versions with CUDA events; K2's staged keys, as
   the kernel counts them, equal to its window table's sum (see phase 5);
4. serving slice: registers pairs with ResUNetFatBN (seeded random
   weights) + SC2-PCR at bench_infer.py's settings: exactly 1 K2 and 20 K6
   launches per pair, kernel-path features within 1e-3 of the plain
   path's on the same card, a cloud registered against itself within
   RTE < 2 m and RRE < 5 deg, and pairs/s of both paths;
4b. the FCGF evaluation pair: ResUNetFatBNEXP at full width (strides 1,
   3, 9, 27; k = 5 strided and transposed convs; seeded weights) on two
   65,536-point scans, the second a known rigid transform of the first:
   K6 on each of the six k = 5 convs at its real widths within 1e-4 of
   its plain version's max, timed, its bound, and the rows it multiplies
   (counted by the kernel, equal to compacted_rows) against the matched
   rows, reported and not gated (sparse offsets at stride 3); K2 at this
   conv1, timed; exactly 1 K2 and 20 K6 launches per extract call, every
   launch inside it against its plain version, features within 1e-3 of
   the plain path's; find_nn on 5000 points and RANSAC with 131,072
   hypotheses registering a cloud against itself within RTE < 2 m and
   RRE < 5 deg (the moved pair reported); pairs/s of the kernel and the
   plain path and the stage times (voxelize, graph, U-Net, find_nn,
   RANSAC); then eval_kitti.main end to end on a synthetic mini-KITTI in
   a temporary directory, with the port's checkpoint of this model, for 3
   pairs: finite RR, RTE and RRE (random weights: RR is no gate);
5. train kernels: builds the graph of the train step's batch (4 x 7
   clouds, 516,096 stride-1 rows) and runs every kernel of the step
   against its plain version there, each within 1e-4 of the plain
   tensor's max (float32 sums in another order; dW sums over blocks by
   atomics): K7's dX and dW for every k=3 geometry at its real Cin / Cout,
   K7's dX also against K6 through the reverse map with flipped transposed
   weights, K3 (and its yardstick: one cuBLAS torch.mm of the bits,
   unpacked beforehand, by g, timed as K3's "library_ms"), K4 (a dense
   random x, and the gated eps case bit for bit
   against the ungated kernel), K5 (the keys each K4 and K5 launch stages,
   dense and gated, counted by the kernel in a launch of its own, equal to
   the plain torch window table of the rows it flags), K9 (conv1's dX, by
   the adjoint identity with K4 and through ScalarConv's backward, with
   and without the step's row flag; the keys it stages equal to the
   unflagged window table's sum, its flag gating the rows of g it
   gathers), and K6 / K2 again
   at these shapes (K6
   also against itself, bit for bit; K2's blocks work out their key
   windows themselves, and the keys they stage into shared memory,
   counted by the kernel in a launch of its own, are required equal to
   the sum of the plain torch window table's lengths and printed a valid
   row). It times each with CUDA events and
   works out each kernel's bound from the bytes it must move and the
   operations of its matched (offset, row) pairs: for the matrix products
   (K6, K7, K8, K12) split TF32 on the tensor cores, printed beside the
   CUDA-core FP32 bound. Per conv and per step it prints the matched GFLOP
   and the GFLOP that K6 and K7's dX execute, counted by the kernels
   themselves in a separate launch (the rows of the mma fragments they ran;
   compacted_rows' count from the map must agree), and requires both
   within 1.4 x the matched work.
   Per conv it also sets the one-pass backward (K7) beside the two-pass
   one (K6 through the reverse map for dX + K8 over the forward map for
   dW): dX and dW of both within 1e-4 of each other's max, the times of
   both and their sums per step; it reads the rows that the split-K dW
   core stages for K7's dW and for K8 (counted by the kernel in a launch
   of its own) and requires each between the matched pairs and 1.05 x
   them plus 8 rows per block; and it holds the explicit tables of this
   batch (K10) equal to the rows the implicit maps' keys resolve to;
   then the group kernels K1 and K11 (see group_kernel_checks; K1's
   staged targets, counted by the kernel in a launch of its own, equal to
   the plain torch window table's sum and printed a valid query, and
   torch.searchsorted of the run starts timed as its "library_ms", the
   searches only; K11 over 589,824 targets at 4096 and at 18,432 queries,
   both timed, and on ties that enter a window chunk after another chunk
   filled the slots, in gcl_tpu's order, through the wrapper);
6. train step: make_gcl_train_step at gcl_tpu_torch.bench's settings,
   float32: one step on the kernel path and one on the plain path from
   the same weights and the same draws (loss within 1e-4, every gradient
   within 0.1 of its max: ReLUs at the edge of rounding open in one path
   and not the other, as the printed yardstick shows), a step in which
   each of the 44 launches is held to its plain version on the same
   inputs within 1e-4 of the max, exactly K2 1, K3 1, K4 1, K5 1, K6 20,
   K7 20 launches per step, then 3 timed steps (finite losses, groups found,
   a parameter of every module changed), one timed plain-path step and
   the peak device memory;
7. explicit-route kernels at the batch above 31 clouds (8 x 7 clouds,
   1,032,192 stride-1 rows, unblocked levels): K10 for each of the 11
   distinct geometries of ResUNetFatBN (conv1 k = 5, the k = 3 same-level,
   strided and transposed maps with their twins), tables equal to the
   plain version's, the keys it stages (counted as K2's) equal to the sum
   of the plain torch window table's lengths and printed a valid query,
   and torch.searchsorted alone over the same fused int64 keys (the
   nearest one-call library counterpart; K10's "library_ms", which K10
   must beat summed over the geometries); the index-table forward K12 for
   conv1 and the 20 k = 3
   convs at their real Cin / Cout, K12 through the reverse table (the dX
   of the two-pass backward) against the scatter-add backward, and K8 over
   the tables, each within 1e-4 of the plain tensor's max; times, bounds
   and K12's matched and executed GFLOP (counted as above); per conv K8
   beside its plain version, its bound, its staged rows (gated as above)
   and, as a yardstick, the products alone: cuBLAS in float32 on the
   CUDA cores (TF32 off) on the matched rows gathered beforehand;
8. explicit-route train step at 8 x 7: as phase 6 with exactly K1 1, K10
   11, K12 41 (21 forward + 20 dX), K8 21 launches per step and none of
   K2-K7; then the 4 x 7 step on the explicit route, one timed step, so
   that the two routes stand side by side on one batch;
9. bf16 kernels (the main path: root bench.py's step computes in bf16):
   phase 5 again with bf16 features, every bf16 launch of K2-K7 and K9
   against its plain bf16 version -- a bf16 output bit-equal on at least
   BF16_EQUAL_SHARE of its elements and one ulp apart on the rest or,
   where the sum cancels, one ulp plus the float32 sums' error bound; a
   float32 dW within 1e-4 of the max -- with the same executed and staged
   row gates, times and bounds (bf16 products at the bf16 tensor-core
   rate), and, on one conv, the cancellation measured against float64;
10. the bf16 train step at 4 x 7 on the implicit route: the launch counts
   of the float32 step exactly, every launch against its plain bf16
   version inside the step, the loss terms of the kernel path within
   twice the plain path's bf16-vs-float32 drift (measured in the same
   run, from a plain float32 step), 3 timed steps, peak memory; then
   phase 7's K12 and K8 in bf16 at 8 x 7 and the bf16 steps at 8 x 7 and
   at 4 x 7 on the explicit route, checked the same way;
11. the FCGF train step (scripts/train_fcgf_kitti.sh's settings:
   ResUNetFatBNEXP at full width, 4 pairs of 65,536-point scans, each
   second scan a known rigid transform of the first, voxel_capacity
   24,576, hardest-contrastive loss, exact input jitter, float32):
   (a) K7's dX and dW on each of EXP's six k = 5 strided and transposed
   convs and its 14 k = 3 convs at their real widths against their plain
   versions within 1e-4 of the max, K7's dX executed / matched rows as the
   kernel counts them (gated at 1.4x over the k = 3 convs only), its dW's
   staged rows gated at every conv, K3, K4 and K5 at its conv1 with the
   step's row flag, each timed with its bound; (b) one step on the kernel
   path and one on the plain path from the same weights and draws (loss
   within 1e-4, gradients within 0.1 of each tensor's max), a step with
   every launch held to its plain version, exactly K2 2, K4 2, K6 40, K3
   2, K5 2, K7 40 launches, 3 timed steps (pairs/s; finite losses,
   positives found, a parameter of every module changed), a timed
   plain-path step and the peak memory; (c) one
   bf16 step with the same launches, every launch against its plain bf16
   version, the loss terms
   within twice the plain path's bf16-vs-float32 drift; (d) the entry
   point, python -m gcl_tpu_torch.train's main, on a synthetic mini-KITTI:
   an FCGF epoch with validation, a resume, a GCL epoch of two
   iterations;
12. data parallelism on the one card (see dp_checks): two ranks on cuda:0
   over gloo run root bench.py's bf16 GCL step at 4 x 7 clouds (2 x 7 a
   rank) and the float32 FCGF step at 4 pairs (2 a rank): reduced
   gradients and BN statistics equal to the mean of the ranks' unreduced
   ones, the averaged loss within 1e-4 of the one-process steps on the
   same shards and draws, every launch against its plain version, the
   launches per rank exact, parameters bit-equal across the ranks after 3
   steps; python -m gcl_tpu_torch.bench --data_parallel at world size 1 on
   NCCL beside the plain bench (step times of both, in turns); an FCGF
   trainer epoch of 2 iterations under --data_parallel true
   --num_devices 1, and the same epoch under torchrun with
   --distributed_init true (NCCL over env://);
13. the model zoo: K6 and K7 at ResUNetFatBNEXP_V2's conv1_extra (1 -> 5,
   k = 5, dilation 5) and conv1_tr_extra (5 -> 1, dilation 4) against
   their plain versions, timed, with executed / matched rows; the FCGF
   step of 11 with V2 and with the instance-norm ResUNetIN2E at full width
   (kernel path against plain path, every launch checked, exact launches,
   3 timed steps, peak memory);
14. the entry points, each through its main on the card: (a) python -m
   gcl_tpu_torch.demo with ResUNetBN2C(1, 32, conv1 k = 5) and seeded
   weights on the default synthetic scan and on a 65,536-point scan
   written as a KITTI .bin: exactly 1 K2 and 20 K6 launches an input,
   every launch inside an extract call against its plain version, K6 on
   each k = 3 conv and K2 on conv1 at that geometry timed beside their
   plain versions and bounds, the .ply's points equal to the voxels'
   representative points, the exact t-SNE embedding finite and within
   [0, 1], the weights written in MinkowskiEngine's layout and imported
   back giving the same features; extract and t-SNE ms and N; (b) python
   -m gcl_tpu_torch.eval_eth with ResUNetFatBN at full width, voxel 0.05,
   on one synthetic scene of three 65,536-point fragments with 5000
   keypoints each: exactly 4 K2 and 80 K6 launches (two pairs), every
   launch checked, K6 / K2 at a fragment's geometry, the pair moved by
   whole voxels at inlier ratio 1 and registered, the 10 deg / 0.5 m
   pair reported, the stage ms; (c) python -m
   gcl_tpu_torch.sc2_pcr.test_kitti at config_KITTI.json on 4 synthetic
   .npz pairs of 5000 keypoints (70% of the descriptors shared): RR 100,
   ms a pair;
16. host native and the wrappers (before 15's lines are printed): (a)
   the host library gcl_tpu_torch.native must have built on this machine;
   voxelize (0.3 m), radius_knn (r 0.45, k 5, 20,000 queries) and
   kernel_map (27 offsets over the voxels) of a 120,000-point scan, each
   equal to its numpy / scipy plain version, both timed; (b) a synthetic
   nuScenes-as-KITTI root (2 logs of 150 frames): ColocationNuscenesDataset
   ("train") iterated once with the scan pool and 0 workers, every
   sample's first read of each of its scans served by the pool (counted
   here by wrapping the pool's fetch binding), the samples bit-equal to a
   pass without the pool and to one in 2 forked torch.utils.data workers;
   (c) bash gcl_tpu_torch/scripts/train_gcl_nuscenes.sh with its defaults
   (ResUNetFatBN at full width, 4 samples of 7 clouds) for one epoch on
   that root, as a subprocess: exit 0, the root wrappers' OUT_DIR, its
   log, checkpoint.pth and 2-6 finite train/loss lines; (d) bash
   gcl_tpu_torch/scripts/test_gcl_nuscenes.sh on that OUT_DIR: exit 0, at
   least one pair, finite RTE and RRE; no kernel launch in this process
   (the wrappers' kernels run in their subprocesses);
15. prints {"fcgf_step": {...}}, {"data_parallel": ..., "zoo": ...},
   {"entry_points": ...}, {"host_native": ...}, then
   {"kernels": [...]} (twelve kernels, each with its launches on one rank
   of phase 12's steps, on phase 13's steps, on phase 14's paths and on
   phase 16's in-process parts;
   a conv kernel's row holds its bf16 form's numbers, the main path's, and
   its float32 form's under "float32"; K11's holds its 18,432-query shape
   under "second_shape"; K2's and K6's float32 parts hold phase 4b's
   numbers as exp_*; K3's, K4's, K5's and K7's rows phase 11's as
   fcgf_*), the card line and, last, the {"ok": true, "device": {...}}
   line. Each phase prints its wall seconds as it ends.
"""
import contextlib
import json
import sys
import time

import numpy as np

N_POINTS = 65536
NV_CAP = 18432
N_KEY = 5000
N_HYP = 131072     # RANSAC hypotheses of the FCGF evaluation
SEED = 0
REPS = 5
BATCH = 4          # the train step's batch: 4 samples x 7 clouds
BATCH_EXPLICIT = 8  # 56 clouds: above the 31 the implicit maps address
HBM_BYTES_PER_S = 3.35e12   # H100 SXM, published
FP32_FLOP_PER_S = 67e12     # float32 outside the tensor cores, published
TF32_FLOP_PER_S = 495e12    # TF32 on the tensor cores, dense, published
BF16_FLOP_PER_S = 989e12    # bf16 on the tensor cores, dense, published
# the kernels whose operations are matrix products: the card can run them
# as split TF32 (float32) or bf16 products on the tensor cores
PRODUCTS = ("K6", "K7", "K8", "K12")
REL_TOL = 1e-4     # kernel vs plain, relative to the plain tensor's max
# bf16 outputs: the kernel and its plain version sum the same exact
# products in float32 in another order and round once, so they are equal
# bit for bit but where the two float32 sums straddle a bf16 rounding
# boundary: at least this share equal, the rest one ulp apart -- or, where
# the sum cancels (its float32 rounding exceeds a bf16 ulp of the result,
# which no summation order avoids; the bf16 cancellation phase measures
# it), within one ulp plus the float32 error bound of the two sums of n
# products, n * 2^-22 * sum |products| (Higham's gamma_n for each sum,
# with the tensor cores' truncating adder's 2^-23)
BF16_EQUAL_SHARE = 0.999
SUM_BOUND = 2.0 ** -22


def _require(ok: bool, what: str) -> None:
    """Raise unless ok (a check that, unlike assert, survives python -O)."""
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def _ms(fn, reps: int) -> float:
    """Mean device time of fn() in ms over reps launches (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def _routed(route):
    """Put route(K, wrapper, plain) in each kernel wrapper's place where
    its callers look it up: core.sparse_ops for the convs of the model,
    core.kernel_maps for the join of the explicit tables,
    kernels.radius_topk for the group search of data.device_pipeline."""
    from gcl_tpu_torch.core import kernel_maps, sparse_ops
    from gcl_tpu_torch.kernels import KERNELS, radius_topk

    saved = []
    for k, (fn, plain) in KERNELS.items():
        for mod in (sparse_ops, kernel_maps, radius_topk):
            if hasattr(mod, fn.__name__):
                saved.append((mod, fn.__name__, fn))
                setattr(mod, fn.__name__, route(k, fn, plain))
    try:
        yield
    finally:
        for mod, name, fn in saved:
            setattr(mod, name, fn)


def plain_path():
    """Route the model's convs, forward and backward, and the group search
    through the kernels' plain versions (for the comparison runs only)."""
    return _routed(lambda k, fn, plain: plain)


def checked_path(errs: dict, unequal: dict = None):
    """Keep the model on the kernels, and hold every launch against the
    plain version on the very same inputs: errs[K] collects the worst
    error relative to the plain tensor's max (integer outputs must be
    equal; bf16 outputs pass _bf16_gate, and unequal[K] collects their
    largest share not bit-equal). A failure raises inside the step."""
    import torch

    def checked(k, fn, plain):
        def both(*args, **kw):
            got, ref = fn(*args, **kw), plain(*args, **kw)
            one = not isinstance(got, tuple)
            for a, b in zip((got,) if one else got, (ref,) if one else ref):
                if a is None:
                    _require(b is None, f"{k}: both leave dX out")
                elif a.dtype == torch.int32:
                    _require(torch.equal(a, b), f"{k}: equal integers")
                    errs.setdefault(k, 0.0)
                elif k in ("K1", "K11"):
                    _require(_bit_equal(a, b), f"{k}: d2 bit for bit")
                    errs.setdefault(k, 0.0)
                else:
                    i = 0 if one else [x is a for x in got].index(True)
                    rel, _, share = _close(
                        a, b, f"{k} inside the step",
                        lambda i=i: _sum_bound(plain, args, kw, i))
                    errs[k] = max(errs.get(k, 0.0), rel)
                    if share is not None and unequal is not None:
                        unequal[k] = max(unequal.get(k, 0.0), share)
            return got
        return both

    return _routed(checked)


def _bit_equal(a, b) -> bool:
    import torch

    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def _aux_bytes(aux) -> int:
    """The bytes of aux that the conv1 kernels (K2, K4, K5, K9) read:
    columns 0-3 (the key and the grid coords; columns 4-7 are padding they
    never read)."""
    return 16 * aux.shape[0]


def _k2_bytes(aux, skeys, w, out, sbits) -> int:
    """The bytes K2 must move: aux's used columns, the level's keys, W in
    out's type, out and sbits."""
    return (_aux_bytes(aux) + _nbytes(skeys, out, sbits)
            + w.numel() * out.element_size())


def _flagged_bytes(aux, skeys, row_sel, side: int, *per_row) -> int:
    """The bytes a gated K4 or K5 launch must read besides W: the row
    flags, and for the flagged rows only aux's used columns and each
    per-row tensor of per_row (x, and K5's g); the level's keys and their
    rows (skeys and srow, 8 bytes a key) once for each key that a flagged
    row's neighbour can be, the union of the flagged tiles' windows
    (occupancy_windows with row_sel)."""
    import torch

    from gcl_tpu_torch.kernels import occupancy_windows

    start, length = occupancy_windows(aux, skeys, side, row_sel).flatten(
        1).long()
    start, length = start[length > 0], length[length > 0]
    edge = torch.zeros(skeys.shape[0] + 1, dtype=torch.int64,
                       device=skeys.device)
    edge.index_add_(0, start, torch.ones_like(start))
    edge.index_add_(0, start + length, -torch.ones_like(start))
    keys = int((edge.cumsum(0)[:-1] > 0).sum())
    flagged = int((row_sel > 0).sum())
    return (row_sel.numel() * row_sel.element_size() + 8 * keys
            + flagged * (_aux_bytes(aux[:1]) + sum(
                t[:1].numel() * t.element_size() for t in per_row)))


def _bound(n_bytes: float, flops: float, products=None):
    """(bound_ms, bound_by): the larger of bytes over the card's memory
    rate and the operations over the fastest rate for their type.
    Operations on the CUDA cores (products None): float32,
    FP32_FLOP_PER_S. Float32 matrix products (products "split_tf32"):
    split TF32 on the tensor cores, three TF32 products per float32 one,
    3 x flops / TF32_FLOP_PER_S, the lesser time; _bounds prints the
    CUDA-core bound beside it. bf16 matrix products (products "bf16"):
    flops / BF16_FLOP_PER_S."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = {None: flops / FP32_FLOP_PER_S,
             "split_tf32": 3 * flops / TF32_FLOP_PER_S,
             "bf16": flops / BF16_FLOP_PER_S}[products]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _rel_err(a, b, what: str) -> float:
    """max|a - b| / max|b|, required within REL_TOL."""
    scale = float(b.abs().max())
    _require(scale > 0, f"{what}: the plain version is not all zero")
    err = float((a - b).abs().max()) / scale
    _require(err <= REL_TOL, f"{what} within {REL_TOL} of max, got {err}")
    return err


def _bf16_ordered(t):
    """bf16 values as int32 in the order of the values: neighbours in
    bf16 differ by one (+0 and -0 are both 0)."""
    import torch

    bits = t.contiguous().view(torch.int16).to(torch.int32)
    return torch.where(bits < 0, -(bits & 0x7FFF), bits)


def _bf16_ulp(b):
    """The bf16 ulp of each element of b (0 at 0), as float32."""
    import torch

    _, e = torch.frexp(b.float())
    return torch.where(b == 0, 0.0, torch.ldexp(torch.ones_like(b.float()),
                                                e - 8))


def _sum_bound(plain, args, kw, i: int):
    """n * SUM_BOUND * sum |products| for output i of a plain version's
    call: the float32 error bound of two sums of n products each. The
    sums of |products| come from the plain version on |args| (the floating
    arguments' absolute values); n is the weight's elements per output
    column (the products an output element sums)."""
    import torch

    absargs = [t.abs() if torch.is_tensor(t) and t.is_floating_point() else t
               for t in args]
    out = plain(*absargs, **kw)
    s = (out[i] if isinstance(out, tuple) else out).float()
    w = next(t for t in args if torch.is_tensor(t) and t.dim() == 3
             and t.dtype == torch.float32)
    return (w.numel() // s.shape[1]) * SUM_BOUND * s


def _bf16_gate(a, b, what: str, bound=None) -> float:
    """bf16 a and b: equal bit for bit on >= BF16_EQUAL_SHARE of the
    elements; one ulp apart at most on the rest or, where more, within one
    ulp plus bound() (a tensor of b's shape: the float32 sums' error
    bound). Returns the share of elements that are not bit-equal."""
    ulps = (_bf16_ordered(a) - _bf16_ordered(b)).abs()
    unequal = float((ulps != 0).float().mean()) if ulps.numel() else 0.0
    _require(unequal <= 1 - BF16_EQUAL_SHARE,
             f"{what}: bf16 bit-equal on {1 - unequal:.6f} of the elements "
             f"(>= {BF16_EQUAL_SHARE})")
    far = ulps > 1
    n_far = int(far.sum())
    if n_far:
        _require(bound is not None,
                 f"{what}: {n_far} elements more than one ulp apart and no "
                 f"float32 sum bound to hold them to")
        diff = (a.float() - b.float()).abs()[far]
        room = (_bf16_ulp(b)[far] + bound()[far])
        worst = float((diff / room).max())
        _require(worst <= 1.0,
                 f"{what}: {n_far} elements more than one ulp apart, up to "
                 f"{worst:.3g} x one ulp + the float32 sum bound")
    return unequal


def _close(a, b, what: str, bound=None):
    """(error relative to b's max, max abs error, share not bit-equal or
    None) of a kernel's output a against its plain version's b, gated: a
    bf16 output by _bf16_gate (``bound`` as there), a float32 one within
    REL_TOL of the max."""
    import torch

    if a.dtype == torch.bfloat16:
        unequal = _bf16_gate(a, b, what, bound)
        diff = float((a.float() - b.float()).abs().max())
        scale = float(b.float().abs().max())
        _require(scale > 0, f"{what}: the plain version is not all zero")
        return diff / scale, diff, unequal
    return _rel_err(a, b, what), float((a - b).abs().max()), None


def _rte_rre(t_est, t_gt):
    r = t_est[:3, :3].T @ t_gt[:3, :3]
    cos = np.clip((np.trace(r) - 1.0) / 2.0, -1.0, 1.0)
    return (float(np.linalg.norm(t_est[:3, 3] - t_gt[:3, 3])),
            float(np.degrees(np.arccos(cos))))


def _records(*names) -> dict:
    return {k: dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, bytes=0, flops=0)
            for k in names}


def _note_unequal(r: dict, unequal) -> None:
    """Keep the largest share of bf16 elements not bit-equal."""
    if unequal is not None:
        r["bf16_unequal_share"] = max(r.get("bf16_unequal_share", 0.0),
                                      unequal)


def _counted_rows(dev, launch, expected: int, what: str) -> int:
    """The rows that the gather-GEMM launches of launch() multiply, as the
    kernels count them (a launch of its own, not a timed one); required
    equal to ``expected``, compacted_rows' count from the map."""
    from gcl_tpu_torch.kernels import counted_gather_rows

    with counted_gather_rows(dev) as counter:
        launch()
    rows = int(counter.item())
    _require(rows == expected, f"{what}: the kernel multiplied {rows} rows, "
                               f"the map's compacted count is {expected}")
    return rows


def _counted_dw(dev, launch, matched: int, what: str):
    """(staged rows, blocks) of the split-K dW launches of launch(), as the
    kernel counts them (a launch of its own, not a timed one): required at
    least the ``matched`` pairs and at most 1.05 x them plus 8 rows per
    block that staged (the last stage of each block rounded up to 8)."""
    from gcl_tpu_torch.kernels import counted_dw_rows

    with counted_dw_rows(dev) as counter:
        launch()
    staged, blocks = (int(v) for v in counter.tolist())
    _require(matched <= staged <= 1.05 * matched + 8 * blocks,
             f"{what}: the dW staged {staged} rows in {blocks} blocks for "
             f"{matched} matched pairs")
    return staged, blocks


def _add_work(r: dict, mult: int, matched: float, executed: float) -> None:
    """Add mult launches' matched and executed gather-GEMM operations."""
    r["gemm_flops"] = r.get("gemm_flops", 0) + mult * matched
    r["exec_flops"] = r.get("exec_flops", 0) + mult * executed


def _runner(rec: dict):
    """run(name, args, ...): kernel ``name`` and its plain version on the
    same inputs; checks the outputs (float32 within REL_TOL of the plain
    tensor's max, bf16 by _bf16_gate, integers equal), times both with CUDA
    events and adds
    ``mult`` launches' worth of time, bytes and matched operations to
    rec[name]. Returns (the kernel's output, worst relative error, ms,
    plain ms)."""
    import torch

    from gcl_tpu_torch.kernels import KERNELS

    def run(name, args, mult=1, n_bytes=0, flops=0, outs=lambda o: o,
            kw=None):
        fn, plain = KERNELS[name]
        kw = kw or {}
        got = fn(*args, **kw)
        torch.cuda.synchronize()
        ref = plain(*args, **kw)
        torch.cuda.synchronize()
        errs = []
        for i, (a, b) in enumerate(zip(outs(got), outs(ref))):
            if a.dtype == torch.int32:
                _require(torch.equal(a, b), f"{name} output {i}: equal "
                                            f"integers")
                errs.append((0.0, 0.0))
            else:
                rel, diff, unequal = _close(
                    a, b, f"{name} output {i}",
                    lambda i=i: _sum_bound(plain, args, kw, i))
                _note_unequal(rec[name], unequal)
                errs.append((rel, diff))
        del ref
        ms = _ms(lambda: fn(*args, **kw), 3)
        pms = _ms(lambda: plain(*args, **kw), 3)
        r = rec[name]
        r["max_abs_err"] = max([r["max_abs_err"]] + [e[1] for e in errs])
        r["ms"] += mult * ms
        r["plain_ms"] += mult * pms
        r["bytes"] += mult * n_bytes
        r["flops"] += mult * flops
        return got, max(e[0] for e in errs), ms, pms

    return run


def _k3_convs() -> dict:
    """{(map key, in stride, out stride, Cin, Cout): count} over the 20
    k = 3 convs of the train step's ResUNetFatBN."""
    from gcl_tpu_torch import bench
    from gcl_tpu_torch.models.common import SparseConv

    convs = {}
    for m in bench.bench_model(SEED, "cpu").modules():
        if isinstance(m, SparseConv) and m.spec.kernel_size == 3:
            sig = (m.spec.key, m.spec.in_stride, m.spec.out_stride, m.in_ch,
                   m.out_ch)
            convs[sig] = convs.get(sig, 0) + 1
    _require(sum(convs.values()) == 20, f"20 k=3 convs, got {convs}")
    return convs


def _bounds(rec: dict, what: str, bf16: bool = False) -> None:
    """Give every record its bound and print it (``bf16``: the products'
    bound is the bf16 tensor-core rate)."""
    for name, r in rec.items():
        tc = name in PRODUCTS
        products = ("bf16" if bf16 else "split_tf32") if tc else None
        r["bound_ms"], r["bound_by"] = _bound(r["bytes"], r["flops"],
                                              products)
        line = (f"{name} per {what}: kernel {r['ms']:.3f} ms, plain "
                f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.3f} ms by "
                f"{r['bound_by']} ({r['bytes'] / 1e6:.1f} MB, "
                f"{r['flops'] / 1e9:.2f} GFLOP matched), max_abs_err "
                f"{r['max_abs_err']:.3g}")
        if tc and not bf16:
            line += (f"; split-TF32 bound {r['bound_ms']:.3f} ms, CUDA-core "
                     f"FP32 bound {_bound(r['bytes'], r['flops'])[0]:.3f} ms")
        if "bf16_unequal_share" in r:
            line += (f"; bf16 outputs not bit-equal to the plain version's: "
                     f"{r['bf16_unequal_share']:.3g} of the elements at most")
        if "exec_flops" in r:
            line += (f"; the gather-GEMM{' (dX)' if name == 'K7' else ''} "
                     f"executed {r['exec_flops'] / 1e9:.2f} GFLOP, counted by "
                     f"the kernel ({r['exec_flops'] / r['gemm_flops']:.3f} x "
                     f"its matched {r['gemm_flops'] / 1e9:.2f})")
        print(line)


def train_kernel_checks(dev, dtype=None) -> dict:
    """Phase 5: every kernel of the train step against its plain version
    at the step's shapes, with features of ``dtype`` (float32 by default;
    bf16 for phase 9). Returns {K: {max_abs_err, ms, plain_ms, bytes,
    flops}} summed over the step's launches of that kernel."""
    import torch

    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    form = "bf16" if bf16 else "float32"

    from gcl_tpu_torch import bench
    from gcl_tpu_torch.core.coords import lookup
    from gcl_tpu_torch.core.kernel_maps import build_graph
    from gcl_tpu_torch.data.device_pipeline import voxelize_per_cloud
    from gcl_tpu_torch.kernels import (KERNELS, c1z_unpack_bits,
                                       compacted_rows, counted_scalar_keys)

    points, pmask, _, _ = bench.bench_batch(SEED, BATCH, N_POINTS, dev)
    n_clouds = BATCH * bench.N_CLOUDS
    specs, cfg = bench.bench_config(BATCH, NV_CAP)
    vox = voxelize_per_cloud(points.reshape(n_clouds, N_POINTS, 3),
                             pmask.reshape(n_clouds, N_POINTS),
                             cfg.voxel_size, NV_CAP)
    flat = vox.flatten()
    graph = build_graph(flat.coords, flat.mask, specs, cfg.level_caps,
                        n_clouds)
    torch.cuda.synchronize()
    print(f"train levels ({form} kernels): " + ", ".join(
        f"s{s} {lv.coords.shape[0]} rows / {lv.skeys.shape[0]} valid"
        for s, lv in sorted(graph.levels.items())))

    rec = _records("K2", "K3", "K4", "K5", "K6", "K7", "K9")
    run = _runner(rec)
    convs = _k3_convs()
    two_pass = dict(k7_ms=0.0, k6_rev_ms=0.0, k8_ms=0.0, convs=[])
    work = dict(matched=0, k6=0, k7_dx=0, pairs=0, k7_dw_staged=0,
                k8_staged=0)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    for (key, s_in, s_out, cin, cout), mult in sorted(convs.items()):
        lv_in, lv_out = graph.levels[s_in], graph.levels[s_out]
        cmap = graph.maps[key]
        x = (torch.randn(lv_in.coords.shape[0], cin, generator=gen)
             .to(dev) * lv_in.mask[:, None]).to(dtype)
        g = (torch.randn(lv_out.coords.shape[0], cout, generator=gen)
             .to(dev) * lv_out.mask[:, None]).to(dtype)
        w = torch.randn(27, cin, cout, generator=gen).to(dev) / (27 * cin) ** .5
        matched, ex6 = compacted_rows(
            lookup(lv_in.skeys, lv_in.srow, cmap.qkey) >= 0)
        rmatched, ex7 = compacted_rows(
            lookup(lv_out.skeys, lv_out.srow, cmap.rqkey) >= 0)
        _require(matched == rmatched > 0,
                 f"{key}: forward and reverse maps hold the same pairs "
                 f"({matched} vs {rmatched})")
        # operations: 2 x rows x Cin x Cout, matched and executed (the rows
        # the gather-GEMM counts: compacted per (64-row tile, offset) and
        # rounded to 16)
        mm = 2 * cin * cout
        fwd_args = (x, w, cmap.qkey, lv_in.skeys, lv_in.srow)
        bwd_args = (x, g, w, cmap.rqkey, lv_out.skeys, lv_out.srow)
        ex6 = _counted_rows(dev, lambda: KERNELS["K6"][0](*fwd_args), ex6,
                            f"K6 {key}")
        ex7 = _counted_rows(dev, lambda: KERNELS["K7"][0](*bwd_args), ex7,
                            f"K7 {key} dX")
        st7, bl7 = _counted_dw(dev, lambda: KERNELS["K7"][0](*bwd_args),
                               matched, f"K7 {key} dW")
        out, e6, ms6, p6 = run(
            "K6", fwd_args, mult, flops=mm * matched,
            n_bytes=_nbytes(*fwd_args) + 4 * g.numel(), outs=lambda o: (o,))
        (dx, dw), e7, ms7, p7 = run(
            "K7", bwd_args, mult, flops=2 * mm * matched,
            n_bytes=_nbytes(*bwd_args) + _nbytes(x, w))
        _add_work(rec["K6"], mult, mm * matched, mm * ex6)
        _add_work(rec["K7"], mult, mm * matched, mm * ex7)
        work["matched"] += mult * mm * matched
        work["pairs"] += mult * matched
        work["k6"] += mult * mm * ex6
        work["k7_dx"] += mult * mm * ex7
        _require(torch.equal(out, KERNELS["K6"][0](*fwd_args)),
                 f"K6 {key} repeats bit for bit")
        if bf16 and (cin, cout) == (128, 128) and s_in == 1:
            _cancellation(*fwd_args, out, KERNELS["K6"][1](*fwd_args),
                          f"K6 {key} {cin}->{cout}")
        # the two-pass backward beside it: dX = K6 through the reverse map
        # with flipped, transposed weights, dW = K8 over the forward map
        k6, k8 = KERNELS["K6"][0], KERNELS["K8"][0]
        wt = w.flip(0).transpose(1, 2).contiguous()
        rev_args = (g, wt, cmap.rqkey, lv_out.skeys, lv_out.srow)
        dw_args = (x, g, cmap.qkey, lv_in.skeys, lv_in.srow)
        dx2, dw2 = k6(*rev_args), k8(*dw_args)
        st8, bl8 = _counted_dw(dev, lambda: k8(*dw_args), matched,
                               f"K8 {key} over the implicit map")
        work["k7_dw_staged"] += mult * st7
        work["k8_staged"] += mult * st8
        dx_bound = lambda: _sum_bound(KERNELS["K6"][1], rev_args, {}, 0)
        e2 = max(_close(dx, dx2, f"K7 {key} dX against K6 through the "
                                 f"reverse map", dx_bound)[0],
                 _close(dx2, dx, f"{key} two-pass dX against K7",
                        dx_bound)[0])
        e8 = max(_rel_err(dw2, KERNELS["K8"][1](*dw_args),
                          f"K8 {key} over the implicit map against plain"),
                 _rel_err(dw2, dw, f"{key} two-pass dW against K7"),
                 _rel_err(dw, dw2, f"K7 {key} dW against K8"))
        ms6r, ms8 = _ms(lambda: k6(*rev_args), 3), _ms(lambda: k8(*dw_args), 3)
        two_pass["k7_ms"] += mult * ms7
        two_pass["k6_rev_ms"] += mult * ms6r
        two_pass["k8_ms"] += mult * ms8
        two_pass["convs"].append(dict(
            conv=f"{key} {cin}->{cout}", count=mult, k7_ms=ms7,
            k6_rev_ms=ms6r, k8_ms=ms8, k7_plain_ms=p7, k6_ms=ms6))
        print(f"{key} {cin}->{cout} x{mult} ({matched} pairs): GFLOP per "
              f"launch matched {mm * matched / 1e9:.2f}, executed K6 "
              f"{mm * ex6 / 1e9:.2f} ({ex6 / matched:.3f} x), K7 dX "
              f"{mm * ex7 / 1e9:.2f} ({ex7 / matched:.3f} x) + dW "
              f"{mm * matched / 1e9:.2f}; "
              f"K6 rel_err {e6:.3g} {ms6:.3f} ms (plain {p6:.3f}); "
              f"K7 rel_err {e7:.3g} {ms7:.3f} ms (plain {p7:.3f}); two-pass "
              f"{ms6r + ms8:.3f} ms (K6 reverse {ms6r:.3f} + K8 {ms8:.3f}), "
              f"dX rel_err {e2:.3g}, dW rel_err {e8:.3g}; dW staged rows K7 "
              f"{st7} ({st7 / matched:.4f} x, {bl7} blocks), K8 {st8} "
              f"({st8 / matched:.4f} x, {bl8} blocks)")
        del x, g, w, wt, out, dx, dw, dx2, dw2

    # the explicit tables of this batch (blocked levels): K10's equal the
    # rows that the implicit maps' keys resolve to (K10 has no features:
    # checked once, in the float32 pass)
    if not bf16:
        ge = build_graph(flat.coords, flat.mask, specs, cfg.level_caps,
                         n_clouds, method="explicit")
        _require(sorted(ge.kmaps) == sorted(graph.maps)
                 and len(ge.kmaps) == 11,
                 f"11 tables for the 11 implicit maps, got {sorted(ge.kmaps)}")
        for key, kmap in ge.kmaps.items():
            lv_in = graph.levels[int(key.split("->")[0][1:])]
            _require(torch.equal(kmap, lookup(lv_in.skeys, lv_in.srow,
                                              graph.maps[key].qkey)),
                     f"explicit table {key} equals the implicit map's rows")
        print(f"explicit tables at {n_clouds} clouds equal the implicit "
              f"maps' rows: {len(ge.kmaps)} geometries")
        del ge

    # the Cin == 1 kernels on conv1 (k = 5, 1 -> 32)
    lv = graph.levels[1]
    c1 = graph.maps["s1->s1/k5d1"]
    n = lv.coords.shape[0]
    w1 = torch.randn(125, 1, 32, generator=gen).to(dev)
    g1 = (torch.randn(n, 32, generator=gen).to(dev)
          * lv.mask[:, None]).to(dtype)
    x1 = torch.randn(n, 1, generator=gen).to(dev).to(dtype)
    fn2, plain2 = KERNELS["K2"]
    k2_args = (c1.c1z, lv.skeys, w1, dtype)
    out, sbits = fn2(*k2_args)
    torch.cuda.synchronize()
    ref, ref_bits = plain2(*k2_args)
    torch.cuda.synchronize()
    if bf16:
        _note_unequal(rec["K2"], _close(
            out, ref, "K2", lambda: _sum_bound(plain2, k2_args, {}, 0))[2])
    else:
        torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    _require(torch.equal(sbits, ref_bits), "K2 sbits equal the plain's")
    bits = c1z_unpack_bits(sbits, 125)
    present = int(bits.sum())
    rec["K2"].update(
        max_abs_err=float((out.float() - ref.float()).abs().max()),
        ms=_ms(lambda: fn2(*k2_args), 3),
        plain_ms=_ms(lambda: plain2(*k2_args), 3),
        bytes=_k2_bytes(*k2_args[:3], out, sbits), flops=present * 32,
        **_k2_windows(dev, *k2_args, form))
    dw3, e3, ms3, _ = run("K3", (sbits, g1, 125), flops=present * 32,
                          n_bytes=_nbytes(sbits, g1, w1),
                          outs=lambda o: (o,))
    # K3's yardstick: one cuBLAS product of the bits, unpacked to the
    # features' type beforehand (not timed), by g; the port never calls it
    bits_t = bits.to(dtype)
    lib3 = torch.mm(bits_t.T, g1).float()
    lib3_err = float((lib3 - dw3[:, 0]).abs().max()) / float(
        dw3.abs().max())
    if not bf16:
        _require(lib3_err <= REL_TOL, f"K3's cuBLAS yardstick agrees with "
                                      f"K3 within {REL_TOL}: {lib3_err}")
    rec["K3"].update(library_ms=_ms(lambda: torch.mm(bits_t.T, g1), 3),
                     library_call=f"torch.mm(bits^T, g), bits [N, 125] "
                                  f"unpacked to {form} beforehand")
    print(f"K3 ({form}): {ms3:.4f} ms; cuBLAS yardstick torch.mm(bits^T, "
          f"g) {rec['K3']['library_ms']:.4f} ms (bits unpacked beforehand; "
          f"output {lib3.numel()} values, max rel diff to K3 {lib3_err:.3g})")
    del bits_t, lib3, dw3
    # K4 / K5: a dense random x for the function itself; then the train
    # step's case, x zero off the jittered centre clouds and those rows
    # flagged, which is what the step launches and what is timed. The keys
    # each launch stages (a launch of its own) must equal the window table
    # of the rows it flags, in both cases.
    geo = (c1.c1z, lv.skeys, lv.srow)
    sel = ((torch.remainder(lv.coords[:, 0], bench.N_CLOUDS) == 0)
           & lv.mask).to(torch.float32)
    xs = (x1.float() * sel[:, None]).to(dtype)
    for xk, flag, case in ((x1, None, "dense"), (xs, sel, "gated")):
        for k, args in (("K4", (xk, w1, *geo, flag)),
                        ("K5", (xk, g1, *geo, 125, flag))):
            rec[k][f"staged_keys_per_flagged_row_{case}"] = _window_keys(
                counted_scalar_keys(dev), lambda: KERNELS[k][0](*args),
                c1.c1z, lv.skeys, 5, flag, f"{k} {case} ({form})")
    run("K4", (x1, w1, *geo), mult=0, outs=lambda o: (o,))
    run("K5", (x1, g1, *geo, 125), mult=0, outs=lambda o: (o,))
    # the gated launches' bytes: K4 writes every row of out, K5 all of dW
    # (W's size); both read only what the flagged rows need
    sel_pairs = int((bits * sel[:, None].to(torch.int32)).sum())
    gated_reads = dict(K4=_flagged_bytes(c1.c1z, lv.skeys, sel, 5, xs),
                       K5=_flagged_bytes(c1.c1z, lv.skeys, sel, 5, xs, g1))
    gated, e4, _, _ = run(
        "K4", (xs, w1, *geo, sel), flops=2 * sel_pairs * 32,
        n_bytes=(_nbytes(w1) + n * w1.shape[2] * xs.element_size()
                 + gated_reads["K4"]), outs=lambda o: (o,))
    _require(torch.equal(gated, KERNELS["K4"][0](xs, w1, *geo, None)),
             "K4 with the row flag equals K4 without it, bit for bit")
    _, e5, _, _ = run(
        "K5", (xs, g1, *geo, 125, sel), flops=2 * sel_pairs * 32,
        n_bytes=_nbytes(w1) + gated_reads["K5"],
        outs=lambda o: (o,))
    _rel_err(KERNELS["K5"][0](xs, g1, *geo, 125, sel),
             KERNELS["K5"][0](xs, g1, *geo, 125, None),
             "K5 with the row flag against K5 without it")
    # K9: conv1's dX of a dense upstream gradient (with the weights rounded
    # to the features' type, as ScalarConv's backward hands them), and in
    # float32 as the adjoint of K4 (in bf16 both sides round to bf16); the
    # keys it stages, with and without a row flag (which gates the rows of
    # g it gathers, not its windows), equal to the unflagged window table's
    # sum; and with the step's row flag against its plain version (not
    # timed)
    w9 = w1.to(dtype).float()
    for flag, case in ((None, "dense"), (sel, "gated")):
        rec["K9"][f"staged_keys_per_valid_row_{case}"] = _window_keys(
            counted_scalar_keys(dev),
            lambda: KERNELS["K9"][0](g1, w9, *geo, flag), c1.c1z, lv.skeys,
            5, None, f"K9 {case} ({form})")
    run("K9", (g1, w9, *geo, sel), mult=0, outs=lambda o: (o,))
    dx, e9, _, _ = run("K9", (g1, w9, *geo), flops=2 * present * 32,
                       n_bytes=(_nbytes(g1, w9, x1, lv.skeys, lv.srow)
                                + _aux_bytes(c1.c1z)),
                       outs=lambda o: (o,))
    adj = float("nan")
    if not bf16:
        fwd = KERNELS["K4"][0](x1, w1, *geo)
        lhs, rhs = float((fwd * g1).sum()), float((x1 * dx).sum())
        adj = abs(lhs - rhs) / float((fwd.abs() * g1.abs()).sum())
        _require(adj <= REL_TOL, f"<K4(x), g> = <x, K9(g)> within {REL_TOL} "
                                 f"of sum |K4(x)| |g|: {lhs} vs {rhs}")
    # and the way a caller reaches it: ScalarConv's backward, asked for dX
    from gcl_tpu_torch.core.sparse_ops import ScalarConv
    from gcl_tpu_torch.kernels import launch_counts, reset_launch_counts
    reset_launch_counts()
    xr = x1.clone().requires_grad_()
    wr = w1.clone().requires_grad_()
    ScalarConv.apply(xr, wr, *geo, None).backward(g1)
    torch.cuda.synchronize()
    rec["K9"]["launches"] = launch_counts()["K9"]
    _require(launch_counts() == {**{k: 0 for k in KERNELS}, "K4": 1, "K5": 1,
                                 "K9": 1},
             f"ScalarConv's backward with dX: K4 1, K5 1, K9 1, got "
             f"{launch_counts()}")
    _require(torch.equal(xr.grad, dx), "ScalarConv's dX is K9's")
    print(f"conv1 k5 1->32 ({form}; {present} present pairs, {sel_pairs} on "
          f"the centre clouds): K3 rel_err {e3:.3g}, K4 gated {e4:.3g}, "
          f"K5 gated {e5:.3g}, K9 {e9:.3g} (adjoint identity {adj:.3g}); "
          f"gated bytes K4 {rec['K4']['bytes'] / 1e6:.3f} MB, K5 "
          f"{rec['K5']['bytes'] / 1e6:.3f} MB, of which reads of the flagged "
          f"rows and windows {gated_reads['K4'] / 1e6:.3f} / "
          f"{gated_reads['K5'] / 1e6:.3f} MB")
    _bounds(rec, f"train step ({form})", bf16)
    print(f"work of the 20 k=3 convs per train step ({form}): matched "
          f"{work['matched'] / 1e9:.1f} GFLOP a direction; executed, as the "
          f"kernels count it, K6 {work['k6'] / 1e9:.1f} "
          f"({work['k6'] / work['matched']:.3f} x), K7 dX "
          f"{work['k7_dx'] / 1e9:.1f} ({work['k7_dx'] / work['matched']:.3f} "
          f"x) + dW {work['matched'] / 1e9:.1f} matched")
    print(f"dW rows staged by the split-K core per train step ({form}), as "
          f"it counts "
          f"them: K7 {work['k7_dw_staged']} "
          f"({work['k7_dw_staged'] / work['pairs']:.4f} x the "
          f"{work['pairs']} matched pairs), K8 over the forward map "
          f"{work['k8_staged']} ({work['k8_staged'] / work['pairs']:.4f} x)")
    _require(work["k6"] <= 1.4 * work["matched"]
             and work["k7_dx"] <= 1.4 * work["matched"],
             f"K6 and K7's dX multiply at most 1.4 x the matched work: {work}")
    print(f"backward of the 20 k=3 convs per train step ({form}): K7 (dX + "
          f"dW) "
          f"{two_pass['k7_ms']:.3f} ms; two passes "
          f"{two_pass['k6_rev_ms'] + two_pass['k8_ms']:.3f} ms (K6 through "
          f"the reverse map {two_pass['k6_rev_ms']:.3f} + K8 "
          f"{two_pass['k8_ms']:.3f})")
    rec["K7"]["two_pass"] = two_pass
    return rec


def _k2_windows(dev, aux, skeys, w, dtype, what: str) -> dict:
    """K2's key windows: the keys the forward's blocks stage, as
    _window_keys counts them; returns them a valid row."""
    from gcl_tpu_torch.kernels import KERNELS, counted_occupancy_keys

    side = round(w.shape[0] ** (1 / 3))
    return dict(staged_keys_per_valid_row=_window_keys(
        counted_occupancy_keys(dev),
        lambda: KERNELS["K2"][0](aux, skeys, w, dtype), aux, skeys, side,
        None, f"K2 {what}"))


def _window_keys(counted, launch, aux, skeys, side: int, row_sel,
                 what: str) -> float:
    """The keys that a launch of K2, K4 or K5 (launch(): one of its own,
    not a timed one) stages, as the kernel counts the copies its threads
    issue inside ``counted`` (kernels.counted_occupancy_keys or
    counted_scalar_keys on the card), required equal to the sum of the
    plain torch window table of the rows it flags (row_sel; None: every
    row); returns them a flagged valid row."""
    from gcl_tpu_torch.kernels import occupancy_windows

    win = occupancy_windows(aux, skeys, side, row_sel)
    with counted as counter:
        launch()
    staged, in_table = int(counter.item()), int(win[1].sum())
    _require(staged == in_table, f"{what}: staged {staged} keys, the window "
                                 f"table sums to {in_table}")
    rows = aux[:, 1] > -(1 << 19)
    if row_sel is not None:
        rows = rows & (row_sel > 0)
    rows = int(rows.sum())
    print(f"{what}: staged {staged} keys = the window table's sum, "
          f"{staged / rows:.4f} a flagged valid row ({rows} rows, {side} dx "
          f"windows a row)")
    return staged / rows


def _cancellation(x, w, qkey, skeys, srow, out, ref, what: str) -> None:
    """Where a bf16 K6 launch and its plain version sit more than one ulp
    apart, against the float64 sum of the same products: how many elements
    each is more than one ulp from the float64 value rounded to bf16, and
    how far the sums cancel there (sum |products| / |sum|)."""
    import torch

    from gcl_tpu_torch.core.coords import lookup

    rows = lookup(skeys, srow, qkey).long()
    n_in = x.shape[0]
    idx = torch.where(rows < 0, n_in, rows)
    xp = torch.cat([x, x.new_zeros((1, x.shape[1]))]).double()
    wd = w.to(x.dtype).double()
    truth = torch.zeros(out.shape, dtype=torch.float64, device=out.device)
    mag = torch.zeros_like(truth)
    for k in range(w.shape[0]):
        truth += xp[idx[k]] @ wd[k]
        mag += xp[idx[k]].abs() @ wd[k].abs()
    t16 = truth.to(torch.bfloat16)

    def far(a, b):
        return (_bf16_ordered(a) - _bf16_ordered(b)).abs() > 1

    apart = far(out, ref)
    ratio = (mag / truth.abs().clamp_min(1e-300))[apart]
    print(f"bf16 cancellation, {what} ({out.numel()} outputs): kernel vs "
          f"plain more than one ulp apart at {int(apart.sum())}, sum "
          f"|products| / |sum| there {float(ratio.min()):.3g} at least; "
          f"more than one ulp from the float64 sum: kernel "
          f"{int(far(out, t16).sum())}, plain {int(far(ref, t16).sum())}"
          if int(apart.sum()) else
          f"bf16 cancellation, {what}: no element more than one ulp apart")


def _captured(name: str, fn):
    """Run fn() and return (its result, the arguments of the first call it
    made to kernels.radius_topk.<name>)."""
    from gcl_tpu_torch.kernels import radius_topk

    seen = []
    real = getattr(radius_topk, name)
    setattr(radius_topk, name, lambda *a: seen.append(a) or real(*a))
    try:
        out = fn()
    finally:
        setattr(radius_topk, name, real)
    _require(len(seen) == 1, f"one call of {name}, got {len(seen)}")
    return out, seen[0]


def _topk_work(arrays, kn: int):
    """(bytes, float operations) of one windowed_cell_topk call: every
    input read and every output written once; 8 operations (3 subtracts,
    3 multiplies, 2 adds) for each target in a probed cell of its query,
    counted from this call's keys."""
    import torch

    tkey_s, trow_s, txyz_s, pbase, qxyz, r2 = arrays
    out_bytes = pbase.numel() * kn * 8
    runs = torch.tensor([0, 1 << 10, 1 << 20, (1 << 20) + (1 << 10)],
                        device=pbase.device, dtype=torch.int64)
    ok = pbase != 0x7FFFFFFF
    key0 = (pbase.long()[..., None] + runs).reshape(pbase.shape[0], -1)
    keys = tkey_s.long()
    n = (torch.searchsorted(keys, key0 + 2) - torch.searchsorted(keys, key0))
    cand = int((n.reshape(*pbase.shape, 4).sum(-1) * ok).sum())
    return _nbytes(*arrays) + out_bytes, 8 * cand, cand


def group_kernel_checks(dev) -> dict:
    """Phase 6: K1 and K11 against their plain versions, the grid groups
    against the brute-force ones, at the train step's shapes."""
    import torch

    from gcl_tpu_torch import bench
    from gcl_tpu_torch.data import device_pipeline as dp
    from gcl_tpu_torch.kernels import (KERNELS, counted_topk_keys,
                                       launch_counts, reset_launch_counts,
                                       topk_windows)
    from gcl_tpu_torch.kernels.radius_topk import RUNS, cross_chunk_ties

    k, cell = 5, bench.SEARCH_CELL
    points, pmask, transforms, radius = bench.bench_batch(SEED, BATCH,
                                                          N_POINTS, dev)
    b, c = BATCH, bench.N_CLOUDS
    vox = dp.voxelize_per_cloud(points.reshape(b * c, N_POINTS, 3),
                                pmask.reshape(b * c, N_POINTS), 0.3, NV_CAP)
    vox_b = dp.VoxelizedClouds(vox.coords.reshape(b, c, NV_CAP, 4),
                               vox.mask.reshape(b, c, NV_CAP),
                               vox.xyz.reshape(b, c, NV_CAP, 3))
    rec = {}

    # K1 at the step's shapes: the arrays the step's group search hands it
    (idx, hit, qperm), arrays = _captured(
        "windowed_cell_topk_packed",
        lambda: dp._grid_searches(vox_b, transforms, radius, k, cell))
    arrays = arrays[:6]
    fn, plain = KERNELS["K1"]
    rows, d2 = fn(*arrays, k)
    torch.cuda.synchronize()
    prows, pd2 = plain(*arrays, k)
    torch.cuda.synchronize()
    _require(torch.equal(rows, prows), "K1 rows equal the plain version's")
    _require(_bit_equal(d2, pd2), "K1 d2 equals the plain version's bit "
                                  "for bit")
    n_bytes, flops, cand = _topk_work(arrays, k)
    rec["K1"] = dict(max_abs_err=0.0, ms=_ms(lambda: fn(*arrays, k), 10),
                     plain_ms=_ms(lambda: plain(*arrays, k), 1),
                     bytes=n_bytes, flops=flops)
    s_n, t_n = arrays[0].shape
    # the targets K1's blocks stage, as the kernel counts its copies (a
    # launch of its own), equal to the plain torch window table's sum
    win = topk_windows(arrays[0], arrays[3])
    with counted_topk_keys(dev) as counter:
        fn(*arrays, k)
    staged, in_table = int(counter.item()), int(win[1].sum())
    _require(staged == in_table, f"K1 staged {staged} targets, the window "
                                 f"table sums to {in_table}")
    n_valid = int((arrays[3] != 0x7FFFFFFF).sum())
    rec["K1"]["staged_keys_per_valid_query"] = staged / n_valid
    # the nearest one-call library form covers the searches only:
    # torch.searchsorted of the 4 Q run starts of each search (int64 keys
    # made beforehand, not timed)
    keys64 = arrays[0].long()
    starts = (arrays[3].long()[..., None] + torch.tensor(
        RUNS, device=dev)).reshape(s_n, -1).contiguous()
    rec["K1"].update(
        library_ms=_ms(lambda: torch.searchsorted(keys64, starts), 10),
        library_call="torch.searchsorted of the 4 Q run starts of each "
                     "search (the searches only)")
    print(f"K1 S={s_n} T=Q={t_n} kn={k}: rows equal, d2 bit for bit; "
          f"{cand} candidates ({cand / rows[..., 0].numel():.1f} a query), "
          f"{int((rows >= 0).sum())} neighbours; staged {staged} targets = "
          f"the window table's sum, {staged / n_valid:.4f} a valid query "
          f"({n_valid}); kernel {rec['K1']['ms']:.4f} ms, plain "
          f"{rec['K1']['plain_ms']:.1f} ms, torch.searchsorted of the run "
          f"starts alone {rec['K1']['library_ms']:.4f} ms")

    # the grid search against the brute-force one, group by group
    bidx, bhit = [], []
    for i in range(b):
        aligned = dp._aligned(vox_b.xyz[i], transforms[i])
        bi, bh = dp.radius_knn(vox_b.xyz[i, 0], vox_b.mask[i, 0], aligned,
                               vox_b.mask[i], radius[i], k, 1024)
        where = qperm[i][None, :, None].expand(c, -1, k)   # to slot order
        bidx.append(torch.gather(bi, 1, where))
        bhit.append(torch.gather(bh, 1, where))
    bidx, bhit = torch.stack(bidx), torch.stack(bhit)        # [B, C, Nv, k]
    live = torch.gather(vox_b.mask[:, 0], 1, qperm)[:, None, :].expand(
        b, c, NV_CAP)
    same_count = hit.sum(-1) == bhit.sum(-1)
    # hits come sorted by distance in both: equal sets are equal rows
    # wherever both hit, up to the order of ties
    gset = torch.where(hit, idx, -1).sort(-1)[0]
    bset = torch.where(bhit, bidx, -1).sort(-1)[0]
    same_rows = (gset == bset).all(-1)
    share_count = float(same_count[live].float().mean())
    share_rows = float(same_rows[live].float().mean())
    share_groups = float(same_rows.all(1)[live[:, 0]].float().mean())
    print(f"grid search against brute force over {int(live.sum())} (search, "
          f"query) pairs: equal hit counts {share_count:.6f}, equal row "
          f"sets {share_rows:.6f}; groups with equal member sets "
          f"{share_groups:.6f}")
    _require(share_count >= 0.99, f"hit counts agree on 99%, got "
                                  f"{share_count}")
    grid_ms = _ms(lambda: dp.batch_colocation_groups(
        vox_b, transforms, radius, k=k, cell=cell), 3)
    brute_ms = _ms(lambda: dp.batch_colocation_groups(
        vox_b, transforms, radius, k=k, chunk=1024), 1)
    rec["K1"]["brute_force_search_ms"] = brute_ms
    rec["K1"]["grid_search_ms"] = grid_ms
    print(f"groups of the batch: grid search {grid_ms:.2f} ms (sorts, K1, "
          f"tables), brute-force search {brute_ms:.2f} ms")

    # K11: T > 2^19 targets in one search, through the entry point, at Q =
    # 4096 queries (the main measurement) and at Q = 18,432 (one whole
    # centre cloud, the row's second shape)
    n_copy = (1 << 19) // NV_CAP + 4       # 32 clouds of 18,432 voxels
    shift = torch.arange(n_copy, device=dev, dtype=torch.float32) * 0.11
    clouds = vox.xyz[torch.arange(n_copy, device=dev) % (b * c)]
    targets = (clouds + shift[:, None, None]).reshape(1, -1, 3)
    t_mask = vox.mask[torch.arange(n_copy, device=dev) % (b * c)].reshape(
        1, -1)
    r11 = torch.full((1,), 0.45, device=dev)
    fn, plain = KERNELS["K11"]
    for q_n in (4096, NV_CAP):
        queries, q_mask = vox.xyz[:1, :q_n], vox.mask[:1, :q_n]
        reset_launch_counts()
        (idx11, hit11), arrays = _captured(
            "windowed_cell_topk_exact",
            lambda: dp.batched_grid_radius_knn(queries, q_mask, targets,
                                               t_mask, r11, k, cell))
        torch.cuda.synchronize()
        launches11 = launch_counts()["K11"]
        _require(launch_counts() == {**{kk: 0 for kk in KERNELS}, "K11": 1},
                 f"the large-T search launches K11 once and nothing else, "
                 f"got {launch_counts()}")
        arrays = arrays[:6]
        rows, d2 = fn(*arrays, k)
        torch.cuda.synchronize()
        prows, pd2 = plain(*arrays, k)
        torch.cuda.synchronize()
        _require(torch.equal(rows, prows),
                 f"K11 Q={q_n} rows equal the plain version's")
        _require(_bit_equal(d2, pd2),
                 f"K11 Q={q_n} d2 equals the plain version's")
        _require(int(hit11.sum()) > q_n // 2,
                 "the large-T search finds neighbours")
        n_bytes, flops, cand = _topk_work(arrays, k)
        shape = dict(queries=q_n, ms=_ms(lambda: fn(*arrays, k), 10),
                     plain_ms=_ms(lambda: plain(*arrays, k), 1),
                     bytes=n_bytes, flops=flops, launches=launches11)
        shape["bound_ms"], shape["bound_by"] = _bound(n_bytes, flops)
        print(f"K11 S=1 Q={q_n} T={arrays[0].shape[1]} kn={k}: rows and d2 "
              f"equal; {cand} candidates, {int(hit11.sum())} neighbours; "
              f"kernel {shape['ms']:.4f} ms, plain {shape['plain_ms']:.1f} "
              f"ms, bound {shape['bound_ms']:.4f} ms by {shape['bound_by']}")
        if q_n == 4096:
            rec["K11"] = dict(max_abs_err=0.0, **shape)
            rec["K11"].pop("queries")
            tie_arrays = arrays
        else:
            rec["K11"]["second_shape"] = shape
    # ties that enter a window chunk after another chunk has filled the
    # slots (gcl_tpu's order: the last tie entered first), through the
    # wrapper on the Q = 4096 search's arrays
    first = int(torch.nonzero(tie_arrays[3][0] != 0x7FFFFFFF)[0, 0])
    tie_arrays, pos = cross_chunk_ties(tie_arrays, first)
    rows, d2 = fn(*tie_arrays, k)
    torch.cuda.synchronize()
    prows, pd2 = plain(*tie_arrays, k)
    _require(torch.equal(rows, prows) and _bit_equal(d2, pd2),
             "K11 on the cross-chunk ties equals its plain version")
    _require(torch.equal(rows[0, first],
                         tie_arrays[1][0, pos + 2100:pos + 2105].flip(0)),
             "K11's cross-chunk ties come out in gcl_tpu's order")
    rec["K11"]["cross_chunk_ties"] = "rows and d2 equal to the plain version"
    print(f"K11 cross-chunk ties (query {first}, targets from sorted "
          f"position {pos}): rows {rows[0, first].tolist()} equal the plain "
          f"version's, the last tie entered first")
    for name in ("K1", "K11"):
        r = rec[name]
        r["bound_ms"], r["bound_by"] = _bound(r["bytes"], r["flops"])
        print(f"{name}: bound {r['bound_ms']:.4f} ms by {r['bound_by']} "
              f"({r['bytes'] / 1e6:.1f} MB, {r['flops'] / 1e9:.3f} GFLOP)")
    return rec


def _products_ms(x, g, kmap, dw) -> float:
    """Device ms of the products of K8's function alone: its matched x and
    g rows gathered beforehand (not timed), then one cuBLAS float32 product
    x_k^T g_k per offset (TF32 off: the CUDA cores' float32 rate). A
    yardstick of the same products in another arithmetic than K8's split
    TF32 on the tensor cores, so it does not split K8's time into products
    and gathering; the port never calls it. Its sum is held to K8's dW
    within REL_TOL of the max."""
    import torch

    k, i = (kmap >= 0).nonzero(as_tuple=True)
    counts = (kmap >= 0).sum(1).tolist()
    xs = x[kmap[k, i].long()].split(counts)
    gs = g[i].split(counts)
    del k, i

    def products():
        return [a.T @ b for a, b in zip(xs, gs)]

    _rel_err(torch.stack(products()), dw, "the gathered products against K8")
    return _ms(products, 3)


def explicit_kernel_checks(dev, dtype=None) -> dict:
    """Phase 7: K10, K12 and K8 against their plain versions at the shapes
    of the explicit-route train step (8 x 7 clouds), with features of
    ``dtype`` (float32 by default; bf16 for phase 10, which leaves out K10:
    it has no features). Returns their records, summed over the step's
    launches of each."""
    import torch

    from gcl_tpu_torch import bench
    from gcl_tpu_torch.core.coords import kernel_offsets, key64
    from gcl_tpu_torch.core.kernel_maps import (ConvSpec, build_graph,
                                                two_word_query_keys)
    from gcl_tpu_torch.core.sparse_ops import sparse_conv
    from gcl_tpu_torch.data.device_pipeline import voxelize_per_cloud
    from gcl_tpu_torch.kernels import (KERNELS, compacted_rows,
                                       counted_join_keys, join_windows,
                                       launch_counts, reset_launch_counts)

    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    form = "bf16" if bf16 else "float32"
    batch = BATCH_EXPLICIT
    points, pmask, _, _ = bench.bench_batch(SEED, batch, N_POINTS, dev)
    n_clouds = batch * bench.N_CLOUDS
    specs, cfg = bench.bench_config(batch, NV_CAP)
    vox = voxelize_per_cloud(points.reshape(n_clouds, N_POINTS, 3),
                             pmask.reshape(n_clouds, N_POINTS),
                             cfg.voxel_size, NV_CAP)
    flat = vox.flatten()
    del points, pmask, vox
    reset_launch_counts()
    graph = build_graph(flat.coords, flat.mask, specs, cfg.level_caps,
                        n_clouds)
    torch.cuda.synchronize()
    _require(not graph.maps and len(graph.kmaps) == 11
             and launch_counts()["K10"] == 11,
             f"{n_clouds} clouds take the explicit route: 11 tables by 11 "
             f"K10 launches, got {sorted(graph.kmaps)}, {launch_counts()}")
    print(f"explicit levels at {n_clouds} clouds ({form} kernels): " +
          ", ".join(f"s{s} {lv.coords.shape[0]} rows / "
                    f"{int(lv.mask.sum())} valid"
                    for s, lv in sorted(graph.levels.items())))

    rec = _records("K8", "K12") if bf16 else _records("K8", "K10", "K12")
    run = _runner(rec)

    def strides(key):                      # "s1->s2/k3d1" -> (1, 2, 3)
        a, b = key.split("/")[0].split("->")
        return int(a[1:]), int(b[1:]), int(key.split("/k")[1][0])

    # K10, geometry by geometry: the kernel against the plain version, the
    # keys its blocks stage against the plain torch window table's sum,
    # and torch.searchsorted alone over the fused keys (the nearest
    # one-call library counterpart: K10's plain version fuses the two
    # words into an int64, searches, then compares)
    join = dict(valid=0, staged=0)
    for key in sorted(graph.kmaps) if not bf16 else ():
        s_in, s_out, ksize = strides(key)
        sp = ConvSpec("geometry", s_in, s_out, ksize)
        lv = graph.levels[s_in]
        qhi, qlo = two_word_query_keys(
            graph.levels[s_out], s_in,
            kernel_offsets(ksize) * sp.offset_scale)
        args = (lv.key_hi, lv.key_lo, lv.perm, qhi, qlo)
        kmap, _, ms, pms = run("K10", args, outs=lambda o: (o,),
                               n_bytes=_nbytes(*args) + 4 * qhi.numel())
        _require(torch.equal(kmap, graph.kmaps[key]),
                 f"K10 {key}: the graph's table")
        found = int((kmap >= 0).sum())
        _require(found > 0, f"K10 {key} finds rows")
        with counted_join_keys(dev) as counter:
            KERNELS["K10"][0](*args)
        staged = int(counter.item())
        in_table = int(join_windows(*args[:2], qhi, qlo)[1].sum())
        _require(staged == in_table,
                 f"K10 {key}: staged {staged} keys, the window table sums "
                 f"to {in_table}")
        keys64, q64 = key64(lv.key_hi, lv.key_lo), key64(qhi, qlo)
        lib_ms = _ms(lambda: torch.searchsorted(keys64, q64), 3)
        del keys64, q64
        valid = int((qhi != 0x7FFFFFFF).sum())
        join["valid"] += valid
        join["staged"] += staged
        rec["K10"]["library_ms"] = rec["K10"].get("library_ms", 0.0) + lib_ms
        print(f"K10 {key}: {qhi.shape[0]} x {qhi.shape[1]} queries, "
              f"{valid} valid, {found} found, {lv.key_hi.shape[0]} keys: "
              f"equal to plain; kernel {ms:.3f} ms, plain {pms:.3f} ms, "
              f"torch.searchsorted alone {lib_ms:.3f} ms; staged {staged} "
              f"keys = the table's sum ({staged / max(valid, 1):.4f} a "
              f"valid query)")
        del qhi, qlo, kmap, args
    if not bf16:
        _require(rec["K10"]["ms"] < rec["K10"]["library_ms"],
                 f"K10 ({rec['K10']['ms']:.3f} ms a step) beats "
                 f"torch.searchsorted alone over the same keys "
                 f"({rec['K10']['library_ms']:.3f} ms)")
        rec["K10"]["staged_keys_per_valid_query"] = (join["staged"]
                                                     / join["valid"])
        print(f"K10 per explicit train step: {rec['K10']['ms']:.3f} ms, "
              f"{join['staged']} keys staged for {join['valid']} valid "
              f"queries ({join['staged'] / join['valid']:.4f} a query; "
              f"equal to the window tables' sums), torch.searchsorted "
              f"alone {rec['K10']['library_ms']:.3f} ms")

    # K12 (forward, and the dX of the two-pass backward through the reverse
    # table) and K8 over the tables, conv by conv
    convs = dict(_k3_convs())
    convs[("s1->s1/k5d1", 1, 1, 1, 32)] = 1                      # conv1
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    for (key, s_in, s_out, cin, cout), mult in sorted(convs.items()):
        lv_in, lv_out = graph.levels[s_in], graph.levels[s_out]
        kmap = graph.kmaps[key]
        kvol = kmap.shape[0]
        rev = graph.kmaps[f"s{s_out}->s{s_in}/{key.split('/')[1]}"]
        x = (torch.randn(lv_in.coords.shape[0], cin, generator=gen)
             .to(dev) * lv_in.mask[:, None]).to(dtype)
        g = (torch.randn(lv_out.coords.shape[0], cout, generator=gen)
             .to(dev) * lv_out.mask[:, None]).to(dtype)
        w = (torch.randn(kvol, cin, cout, generator=gen).to(dev)
             / (kvol * cin) ** .5)
        matched, ex12 = compacted_rows(kmap >= 0)
        rmatched, ex12r = compacted_rows(rev >= 0)
        _require(matched == rmatched > 0,
                 f"{key}: forward and reverse tables hold the same pairs")
        flops = 2 * matched * cin * cout
        k12 = KERNELS["K12"][0]
        ex12 = _counted_rows(dev, lambda: k12(x, w, kmap), ex12, f"K12 {key}")
        out, e12, ms12, p12 = run(
            "K12", (x, w, kmap), mult, flops=flops, outs=lambda o: (o,),
            n_bytes=_nbytes(x, w, kmap) + 4 * g.numel())
        _add_work(rec["K12"], mult, flops, 2 * ex12 * cin * cout)
        dw, e8, ms8, p8 = run(
            "K8", (x, g, kmap), mult, flops=flops, outs=lambda o: (o,),
            n_bytes=_nbytes(x, g, kmap, w))
        st8, bl8 = _counted_dw(dev, lambda: KERNELS["K8"][0](x, g, kmap),
                               matched, f"K8 {key} over the table")
        b8 = _bound(_nbytes(x, g, kmap, w), flops,
                    "bf16" if bf16 else "split_tf32")[0]
        # the float32 yardstick only: cuBLAS float32 on the CUDA cores
        mm_ms = None if bf16 else _products_ms(x, g, kmap, dw)
        rec["K8"].setdefault("convs", []).append(dict(
            conv=f"{key} {cin}->{cout}", count=mult, ms=ms8, plain_ms=p8,
            bound_ms=b8, products_ms=mm_ms, matched=matched, staged=st8,
            blocks=bl8))
        line = (f"{key} {cin}->{cout} x{mult} ({matched} pairs): GFLOP per "
                f"launch matched {flops / 1e9:.2f}, executed K12 "
                f"{2 * ex12 * cin * cout / 1e9:.2f} ({ex12 / matched:.3f} x)"
                f", through the reverse table "
                f"{2 * ex12r * cin * cout / 1e9:.2f} ({ex12r / matched:.3f} "
                f"x); K12 rel_err "
                f"{e12:.3g} {ms12:.3f} ms (plain {p12:.3f}); K8 rel_err "
                f"{e8:.3g} {ms8:.3f} ms (plain {p8:.3f}, bound {b8:.3f}), "
                f"staged {st8} rows ({st8 / matched:.4f} x, {bl8} blocks)")
        if mm_ms is not None:
            line += (f", the products alone {mm_ms:.3f} ms (yardstick: cuBLAS "
                     f"float32 on the CUDA cores, on rows gathered "
                     f"beforehand)")
        if kvol == 27:  # conv1's input takes no gradient: no dX in the step
            wt = w.flip(0).transpose(1, 2).contiguous()
            ex12r = _counted_rows(dev, lambda: k12(g, wt, rev), ex12r,
                                  f"K12 {key} through the reverse table")
            dx, ex, msx, px = run(
                "K12", (g, wt, rev), mult, flops=flops, outs=lambda o: (o,),
                n_bytes=_nbytes(g, wt, rev, x))
            _add_work(rec["K12"], mult, flops, 2 * ex12r * cin * cout)
            # against the scatter-add backward (the table has no twin there)
            xr = x.clone().requires_grad_()
            sparse_conv(xr, w, kmap, None).backward(g)
            es = _close(dx, xr.grad, f"{key} dX through the reverse table "
                                     f"against the scatter-add",
                        lambda: _sum_bound(KERNELS["K12"][1], (g, wt, rev),
                                           {}, 0))[0]
            line += (f"; dX through the reverse table rel_err {ex:.3g} "
                     f"{msx:.3f} ms (plain {px:.3f}), against the "
                     f"scatter-add {es:.3g}")
            del wt, dx, xr
        print(line)
        del x, g, w, out, dw
    _bounds(rec, f"explicit train step ({form})", bf16)
    convs8 = rec["K8"]["convs"]
    products = ("" if bf16 else
                f"; the products alone "
                f"{sum(c['count'] * c['products_ms'] for c in convs8):.3f} "
                f"ms (cuBLAS float32 on the CUDA cores on pre-gathered rows, "
                f"a yardstick)")
    print(f"K8 per explicit train step ({form}; "
          f"{sum(c['count'] for c in convs8)} launches): kernel "
          f"{rec['K8']['ms']:.3f} ms, plain {rec['K8']['plain_ms']:.3f}, "
          f"bound {rec['K8']['bound_ms']:.3f}{products}; rows staged "
          f"{sum(c['count'] * c['staged'] for c in convs8)} for "
          f"{sum(c['count'] * c['matched'] for c in convs8)} matched pairs")
    return rec


# launches per train step, worked out from the model: one group search;
# implicit route: conv1 = K2 (presence) + K4 (eps), its dW = K3 + K5, 20 k=3
# convs forward (K6) and backward (K7); explicit route: a join per distinct
# geometry (11), conv1 and the 20 k=3 convs forward plus the 20 dX (conv1's
# input takes no gradient) through K12, 21 dW through K8
LAUNCHES = {
    "implicit": {"K1": 1, "K2": 1, "K3": 1, "K4": 1, "K5": 1, "K6": 20,
                 "K7": 20},
    "explicit": {"K1": 1, "K8": 21, "K10": 11, "K12": 41}}


def train_step_checks(dev, gpu: str, batch_size: int, route: str,
                      compare: bool = True, dtype=None) -> dict:
    """Phases 6 and 8 (float32) and 11 (``dtype`` bf16): the train step at
    full width and ``batch_size`` x 7 clouds, with the grid group search,
    on ``route`` ('implicit' or 'explicit'). With ``compare``: a
    kernel-path step against a plain-path step and a step with every launch
    held to its plain version, three timed steps and a timed plain-path
    step (in float32 on the implicit route also the plain path against
    itself with nudged weights and a step with the brute-force group
    search; in bf16 a plain-path float32 step, the measure of the loss
    tolerance); without: the launch counts and one timed step. Returns the
    launch counts of one step."""
    import torch

    from gcl_tpu_torch import bench
    from gcl_tpu_torch.kernels import (KERNELS, launch_counts,
                                       reset_launch_counts)
    from gcl_tpu_torch.losses.gcl import LossDraws
    from gcl_tpu_torch.models.weights import gradients_by_name
    from gcl_tpu_torch.train.steps import StepDraws

    dtype = dtype or torch.float32
    bf16 = dtype == torch.bfloat16
    form = "bf16" if bf16 else "float32"
    tag = f"{batch_size} x {bench.N_CLOUDS} clouds, {route} route, {form}"
    want = {**{k: 0 for k in KERNELS}, **LAUNCHES[route]}
    batch = bench.bench_batch(SEED, batch_size, N_POINTS, dev)
    n_rows = batch_size * bench.N_CLOUDS * NV_CAP
    gen = torch.Generator(device=dev).manual_seed(SEED)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    draws = StepDraws(
        sample_gate_u=rand(batch_size),
        jitter=(rand(), torch.randn((n_rows, 1), generator=gen, device=dev)),
        loss=LossDraws(rand(256 * batch_size), rand(256 * batch_size),
                       rand(256 * batch_size)))
    lr = 0.1
    runs = {}
    in_step_errs, in_step_unequal = {}, {}
    names = ("kernel",)
    if compare:
        names += ("plain", "checked")
        if bf16:
            names += ("plain_float32",)
        elif route == "implicit":
            names += ("plain_nudged",)
    for name in names:
        model = bench.bench_model(SEED, dev)
        if name == "plain_nudged":  # weights moved by 1e-7 of themselves
            with torch.no_grad():
                for p in model.parameters():
                    p.mul_(1 + 1e-7 * torch.randn(p.shape, generator=gen,
                                                  device=dev))
        before = {k: v.clone() for k, v in model.state_dict().items()}
        _, step = bench.bench_step(
            model, batch_size, NV_CAP, graph=route,
            compute_dtype=torch.float32 if name == "plain_float32" else dtype)
        reset_launch_counts()
        ctx = {"kernel": contextlib.nullcontext(),
               "checked": checked_path(in_step_errs, in_step_unequal)
               }.get(name) or plain_path()
        with ctx:
            metrics = step(lr, *batch, draws=draws)
            torch.cuda.synchronize()
        runs[name] = dict(model=model, step=step, before=before,
                          metrics={k: float(v) for k, v in metrics.items()},
                          grads={k: g.clone() for k, g in
                                 gradients_by_name(model).items()},
                          launches=launch_counts())
    launches = runs["kernel"]["launches"]
    print(f"launches per train step ({tag}): {launches}")
    _require(launches == want, f"launches per step {want}, got {launches}")
    model, step = runs["kernel"]["model"], runs["kernel"]["step"]
    if not compare:
        t0 = time.perf_counter()
        metrics = step(lr, *batch, generator=gen)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        _require(all(bool(torch.isfinite(v)) for v in metrics.values()),
                 f"finite metrics, got {metrics}")
        n_vox = float(metrics["num_valid_voxels"])
        print(f"train step ({tag}), kernel path: step_time_s {dt:.4f} (1 "
              f"step after a warm-up), {n_vox / dt:.1f} voxel/s, loss "
              f"{float(metrics['loss']):.6f}, num_groups "
              f"{int(metrics['num_groups'])}, voxels_per_step {int(n_vox)} "
              f"on {gpu}")
        return launches
    _require(not any(runs["plain"]["launches"].values()),
             "the plain path launches no kernel")
    mk, mp = runs["kernel"]["metrics"], runs["plain"]["metrics"]
    print(f"first step, kernel path: {mk}")
    print(f"first step, plain path:  {mp}")
    terms = ("loss", "pos_loss", "finest_loss", "neg_loss")
    if bf16:
        # the loss's tolerance, measured: bf16 moves the plain path's loss
        # terms from float32 by drift; two bf16 paths that round the same
        # products once, summed in another order, may differ by twice that
        # (their difference grows from one-ulp flips through 23 convs into
        # bf16's own noise)
        m32 = runs["plain_float32"]["metrics"]
        print(f"first step, plain path, float32: {m32}")
        drift = max(abs(mp[t] - m32[t]) for t in terms)
        gap = max(abs(mk[t] - mp[t]) for t in terms)
        print(f"loss terms, kernel path vs plain path in bf16: {gap:.3g} at "
              f"most; the tolerance, twice the plain path's bf16-vs-float32 "
              f"drift {drift:.3g}: {2 * drift:.3g}")
        _require(gap <= 2 * drift,
                 f"loss terms of the bf16 kernel and plain paths within "
                 f"{2 * drift} (twice bf16's drift from float32), got {gap}")
    else:
        _require(abs(mk["loss"] - mp["loss"]) <= 1e-4,
                 f"loss of kernel and plain path within 1e-4: {mk['loss']} "
                 f"vs {mp['loss']}")

    def worst_gradient(a, b):
        worst = ("", 0.0)
        for pname, ga in runs[a]["grads"].items():
            gb = runs[b]["grads"][pname]
            err = float((ga - gb).abs().max()) / float(gb.abs().max())
            worst = max(worst, (pname, err), key=lambda t: t[1])
        return worst

    # Gradients. Inside one step every launch of every kernel is held to
    # its plain version on the same inputs (checked_path: REL_TOL, and the
    # bf16 gate for bf16 outputs). Between a whole kernel-path step and a
    # whole plain-path step the gradients cannot be held that tightly:
    # their features differ by rounding, and a ReLU whose input lies within
    # that rounding of zero opens in one path and stays shut in the other,
    # which moves a channel's gradient by percents of the tensor's max. In
    # float32 the plain path shows the same against itself with its
    # weights moved by 1e-7 of themselves, printed beside it as the
    # yardstick, and the two paths are held to 0.1 of each tensor's max;
    # in bf16 the yardstick is the plain path's bf16-vs-float32 gap.
    print(f"kernel vs plain inside the step, worst rel_err per kernel: "
          f"{ {k: float(f'{v:.3g}') for k, v in sorted(in_step_errs.items())} }")
    if bf16:
        print(f"  bf16 outputs inside the step not bit-equal to the plain "
              f"version's, largest share per kernel: "
              f"{ {k: float(f'{v:.3g}') for k, v in sorted(in_step_unequal.items())} }")
    _require(sorted(in_step_errs) == sorted(k for k, n in want.items() if n),
             f"every kernel of the step was checked inside it: "
             f"{in_step_errs}")
    free = worst_gradient("kernel", "plain")
    print(f"gradients of whole steps over {len(runs['kernel']['grads'])} "
          f"tensors, worst error relative to the tensor's max: kernel path "
          f"vs plain path {free[1]:.3g} ({free[0]})")
    if "plain_nudged" in runs:
        nudged = worst_gradient("plain_nudged", "plain")
        print(f"  the yardstick: plain path with weights moved by 1e-7 vs "
              f"plain path {nudged[1]:.3g} ({nudged[0]})")
    if "plain_float32" in runs:
        gap32 = worst_gradient("plain", "plain_float32")
        print(f"  the yardstick: plain path in bf16 vs in float32 "
              f"{gap32[1]:.3g} ({gap32[0]})")
    else:
        _require(free[1] <= 0.1, f"gradient of {free[0]} on the kernel path "
                                 f"within 0.1 of its max, got {free[1]}")

    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):  # the first step above was the warm-up
        t0 = time.perf_counter()
        metrics = step(lr, *batch, generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        _require(all(bool(torch.isfinite(v)) for v in metrics.values()),
                 f"finite metrics, got {metrics}")
        _require(float(metrics["num_groups"]) > 0, "groups were found")
    peak = torch.cuda.max_memory_allocated()
    brute = route == "implicit" and not bf16
    if brute:
        # the same step with the brute-force group search, beside it
        brute_model = bench.bench_model(SEED, dev)
        _, brute_step = bench.bench_step(brute_model, batch_size, NV_CAP,
                                         search="brute_force",
                                         compute_dtype=dtype)
        brute_step(lr, *batch, generator=gen)  # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        brute_metrics = brute_step(lr, *batch, generator=gen)
        torch.cuda.synchronize()
        brute_dt = time.perf_counter() - t0
        del brute_model, brute_step
    with plain_path():
        t0 = time.perf_counter()
        runs["plain"]["step"](lr, *batch, generator=gen)
        torch.cuda.synchronize()
        plain_dt = time.perf_counter() - t0
    after = model.state_dict()
    for mname, module in model.named_modules():
        own = [f"{mname}.{p}" for p, _ in module.named_parameters(
            recurse=False)]
        _require(not own or any(
            not torch.equal(after[k], runs["kernel"]["before"][k])
            for k in own), f"a parameter of {mname} changed")
    dt = sorted(times)[1]
    n_vox = float(metrics["num_valid_voxels"])
    print(f"train step ({tag}), kernel path: step_time_s {dt:.4f} (min "
          f"{min(times):.4f}, max {max(times):.4f}; 3 steps after a "
          f"warm-up), {n_vox / dt:.1f} voxel/s, loss "
          f"{float(metrics['loss']):.6f}, num_groups "
          f"{int(metrics['num_groups'])}, voxels_per_step {int(n_vox)} "
          f"on {gpu}")
    if brute:
        print(f"train step ({tag}), kernel path, brute-force group search: "
              f"step_time_s {brute_dt:.4f} (1 step after a warm-up), "
              f"num_groups {int(brute_metrics['num_groups'])}")
    print(f"train step ({tag}), plain path: step_time_s {plain_dt:.4f} (1 "
          f"step after a warm-up), {n_vox / plain_dt:.1f} voxel/s")
    print(f"peak device memory over the timed steps ({tag}): "
          f"{peak / 2**30:.2f} GiB")
    return launches


def _rigid(deg: float, shift) -> np.ndarray:
    """A rotation about z by ``deg`` and a shift, 4 x 4 float32."""
    c, s = np.cos(np.radians(deg)), np.sin(np.radians(deg))
    t = np.eye(4, dtype=np.float32)
    t[:2, :2] = [[c, -s], [s, c]]
    t[:3, 3] = shift
    return t


def _fcgf_register(extract, pts, pmask, rng, gen, n_hyp, marks=None):
    """One FCGF evaluation pair as eval_kitti registers it: features of
    both clouds (one extract call), N_KEY points of each drawn by ``rng``,
    find_nn, then RANSAC with ``n_hyp`` hypotheses from ``gen``. With
    ``marks`` (a list), appends a host time after a synchronize at the end
    of each stage: voxelize, graph, U-Net, find_nn, RANSAC."""
    import torch
    from gcl_tpu_torch.core.kernel_maps import build_graph
    from gcl_tpu_torch.data.device_pipeline import voxelize_per_cloud
    from gcl_tpu_torch.eval_kitti import random_sample
    from gcl_tpu_torch.reg.matching import find_nn
    from gcl_tpu_torch.reg.ransac import ransac_pose

    def mark():
        if marks is not None:
            torch.cuda.synchronize()
            marks.append(time.perf_counter())

    mark()
    with torch.inference_mode():
        vox = voxelize_per_cloud(pts, pmask, extract.voxel_size,
                                 extract.nv_cap)
        mark()
        flat = vox.flatten()
        graph = build_graph(flat.coords, flat.mask, extract.conv_specs,
                            extract.level_caps, n_clouds=2)
        mark()
        f = extract.model(graph, flat.feats).reshape(2, extract.nv_cap, -1)
        mark()
        side = []
        for c in (0, 1):
            m = vox.mask[c]
            x, fc = random_sample(vox.xyz[c][m].cpu().numpy(),
                                  f[c][m].cpu().numpy(), N_KEY, rng)
            side.append((torch.from_numpy(x).to(pts.device),
                         torch.from_numpy(fc).to(pts.device)))
        nn, _ = find_nn(side[0][1], side[1][1])
        mark()
        t_est, _, _ = ransac_pose(side[0][0], side[1][0][nn], 0.3,
                                  generator=gen, num_hypotheses=n_hyp,
                                  sample_size=4, edge_length_ratio=0.9)
        t_est = t_est.cpu().numpy()
        mark()
    return t_est, f


def fcgf_eval_checks(dev, gpu: str) -> dict:
    """Phase 4b, the FCGF evaluation pair: ResUNetFatBNEXP at full width
    (seeded weights) on two N_POINTS-point scans, the second a known rigid
    transform of the first, then feature-NN RANSAC, then eval_kitti.main on
    a synthetic mini-KITTI. Returns the exp_* fields of the K2 and K6
    rows."""
    import os
    import tempfile

    import torch
    from gcl_tpu_torch import eval_kitti, infer
    from gcl_tpu_torch.config import default_config
    from gcl_tpu_torch.core.coords import lookup
    from gcl_tpu_torch.core.kernel_maps import build_graph
    from gcl_tpu_torch.data import pairs
    from gcl_tpu_torch.data.device_pipeline import voxelize_per_cloud
    from gcl_tpu_torch.data.synthetic import (generate_synthetic_kitti,
                                              synth_lidar, write_split_files)
    from gcl_tpu_torch.kernels import (KERNELS, c1z_unpack_bits,
                                       compacted_rows, launch_counts,
                                       occupancy_conv_fwd,
                                       occupancy_conv_fwd_plain,
                                       reset_launch_counts,
                                       sparse_conv_implicit_fwd,
                                       sparse_conv_implicit_fwd_plain)
    from gcl_tpu_torch.models.common import SparseConv
    from gcl_tpu_torch.models.resunet import ResUNetFatBNEXP
    from gcl_tpu_torch.train.checkpoint import save_checkpoint

    model = infer.serving_model(SEED, dev, ResUNetFatBNEXP)
    extract = infer.serving_extractor(model, NV_CAP)
    rng = np.random.RandomState(SEED + 12)
    scan = synth_lidar(rng, N_POINTS)
    t_gt = _rigid(10.0, [2.0, -1.0, 0.1])
    moved = scan @ t_gt[:3, :3].T + t_gt[:3, 3]
    pts = torch.from_numpy(np.stack([scan, moved])).to(dev)
    pmask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    vox = voxelize_per_cloud(pts, pmask, extract.voxel_size, NV_CAP)
    flat = vox.flatten()
    graph = build_graph(flat.coords, flat.mask, extract.conv_specs,
                        extract.level_caps, 2)
    torch.cuda.synchronize()
    print("EXP levels: " + ", ".join(
        f"s{s} {lv.coords.shape[0]} rows / {lv.skeys.shape[0]} valid"
        for s, lv in sorted(graph.levels.items())))

    # K6 on the six k = 5 convs at their real widths: within REL_TOL of
    # the plain version's max, timed, its bound, and the rows it
    # multiplies (counted by the kernel, equal to compacted_rows' count)
    # against the matched rows. No 1.4x gate here: a stride-3 conv's
    # offsets match a 64-row tile sparsely (a transposed 27 -> 9 conv only
    # where (out + 9 off) % 27 == 0 on every axis), and the compacted list
    # of each (tile, offset) is rounded up to 16 rows
    g = torch.Generator(device="cpu").manual_seed(SEED + 12)
    k5 = []
    for m in model.modules():
        if not (isinstance(m, SparseConv) and m.spec.kernel_size == 5
                and m.spec.in_stride != m.spec.out_stride):
            continue
        key, s_in = m.spec.key, m.spec.in_stride
        lv = graph.levels[s_in]
        x = (torch.randn(lv.coords.shape[0], m.in_ch, generator=g).to(dev)
             * lv.mask[:, None])
        w = (torch.randn(125, m.in_ch, m.out_ch, generator=g).to(dev)
             / (125 * m.in_ch) ** .5)
        args = (x, w, graph.maps[key].qkey, lv.skeys, lv.srow)
        out = sparse_conv_implicit_fwd(*args)
        torch.cuda.synchronize()
        ref = sparse_conv_implicit_fwd_plain(*args)
        err = _rel_err(out, ref, f"K6 EXP {key}")
        ms = _ms(lambda: sparse_conv_implicit_fwd(*args), REPS)
        pms = _ms(lambda: sparse_conv_implicit_fwd_plain(*args), 2)
        matched, executed = compacted_rows(
            lookup(lv.skeys, lv.srow, args[2]) >= 0)
        _counted_rows(dev, lambda: sparse_conv_implicit_fwd(*args),
                      executed, f"K6 EXP {key}")
        flops = 2 * matched * m.in_ch * m.out_ch
        bound = _bound(_nbytes(*args, out), flops, "split_tf32")
        k5.append(dict(conv=m.spec.name, key=key, cin=m.in_ch,
                       cout=m.out_ch, rel_err=err,
                       max_abs_err=float((out - ref).abs().max()), ms=ms,
                       plain_ms=pms, bound_ms=bound[0], bound_by=bound[1],
                       matched_rows=matched, executed_rows=executed,
                       executed_over_matched=executed / max(matched, 1)))
        print(f"K6 EXP {m.spec.name} {key} {m.in_ch}->{m.out_ch}: rel_err "
              f"{err:.3g} kernel {ms:.3f} ms plain {pms:.3f} ms bound "
              f"{bound[0]:.4f} ms ({bound[1]}); rows matched {matched} "
              f"executed {executed} ({executed / max(matched, 1):.2f}x)")
    _require(len(k5) == 6, f"six k = 5 strided / transposed convs, got "
                           f"{len(k5)}")

    c1 = graph.maps["s1->s1/k5d1"]
    w1 = torch.randn(125, 1, 32, generator=g).to(dev)
    k2_args = (c1.c1z, graph.levels[1].skeys, w1)
    out, sbits = occupancy_conv_fwd(*k2_args)
    torch.cuda.synchronize()
    ref, ref_bits = occupancy_conv_fwd_plain(*k2_args)
    _require(torch.equal(sbits, ref_bits), "K2 EXP sbits equal")
    k2_err = float((out - ref).abs().max())
    _require(k2_err <= 1e-5, f"K2 EXP within 1e-5, got {k2_err}")
    k2_ms = _ms(lambda: occupancy_conv_fwd(*k2_args), REPS)
    k2_plain_ms = _ms(lambda: occupancy_conv_fwd_plain(*k2_args), 2)
    k2_bound = _bound(_k2_bytes(*k2_args, out, sbits),
                      32 * int(c1z_unpack_bits(sbits, 125).sum()))
    print(f"K2 EXP conv1: max_abs_err {k2_err:.3g} kernel {k2_ms:.4f} ms "
          f"plain {k2_plain_ms:.3f} ms bound {k2_bound[0]:.4f} ms "
          f"({k2_bound[1]})")

    # the extract call: exactly 1 K2 and 20 K6 launches, every launch held
    # to its plain version inside it, features within 1e-3 of the plain
    # path's
    reset_launch_counts()
    _, feats = extract(pts, pmask)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"EXP launches per extract call: {launches}")
    _require(launches == {**{k: 0 for k in KERNELS}, "K2": 1, "K6": 20},
             f"1 K2 and 20 K6 launches per extract call, got {launches}")
    errs = {}
    with checked_path(errs):
        extract(pts, pmask)
    with plain_path():
        _, feats_plain = extract(pts, pmask)
    feat_err = float((feats - feats_plain).abs().max())
    print(f"EXP features kernel vs plain path: max_abs_err {feat_err:.3g}; "
          f"every launch against its plain version: {errs}")
    _require(feat_err < 1e-3, f"EXP features within 1e-3, got {feat_err}")

    # registration: the self pair within RTE < 2 m, RRE < 5 deg; the
    # transformed pair reported (random weights: no gate)
    gen = torch.Generator().manual_seed(SEED)
    self_pts = torch.stack([pts[0], pts[0]])
    t_self, _ = _fcgf_register(extract, self_pts, pmask,
                               np.random.RandomState(0), gen, N_HYP)
    rte, rre = _rte_rre(t_self, np.eye(4))
    print(f"EXP self pair, find_nn + RANSAC 131,072: RTE {rte:.4g} m "
          f"RRE {rre:.4g} deg")
    _require(rte < 2.0 and rre < 5.0,
             f"EXP self pair within RTE < 2 m, RRE < 5 deg: {rte}, {rre}")
    t_pair, _ = _fcgf_register(extract, pts, pmask,
                               np.random.RandomState(0), gen, N_HYP)
    rte_p, rre_p = _rte_rre(t_pair, t_gt)
    print(f"EXP pair moved 10 deg / 2.2 m: RTE {rte_p:.4g} m RRE "
          f"{rre_p:.4g} deg (random weights: reported, not gated)")

    # pairs/s, kernel and plain alternating, a synchronize after each;
    # stage times on the kernel path
    times = {"kernel": [], "plain": []}
    stages = []
    for _ in range(2):
        for name in ("kernel", "plain"):
            ctx = plain_path() if name == "plain" else contextlib.nullcontext()
            with ctx:
                marks = []
                _fcgf_register(extract, pts, pmask,
                               np.random.RandomState(0), gen, N_HYP, marks)
                times[name].append(marks[-1] - marks[0])
                if name == "kernel":
                    stages.append(np.diff(marks) * 1e3)
    stage_ms = dict(zip(("voxelize", "graph", "unet", "find_nn", "ransac"),
                        np.mean(stages, axis=0).tolist()))
    pps = {k: 1.0 / float(np.mean(v)) for k, v in times.items()}
    print(f"FCGF evaluation pair: kernel {pps['kernel']:.3f} pairs/s, plain "
          f"{pps['plain']:.3f} pairs/s (2 pairs each, alternating) on {gpu}; "
          f"stage ms (kernel path): {json.dumps(stage_ms)}")

    # the entry point end to end: a synthetic mini-KITTI, a run directory
    # with the port's checkpoint of this model, 3 pairs through RANSAC
    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "kitti")
        generate_synthetic_kitti(root, n_drives=1, n_frames=30, step=2.0)
        write_split_files(os.path.join(root, "config"), 1)
        pairs.PairComplementKittiDataset.DATA_FILES = {
            p: os.path.join(root, "config", f"{p}_kitti.txt")
            for p in ("train", "val", "test")}
        save_dir = os.path.join(tmp, "run")
        run_cfg = dict(model="ResUNetFatBNEXP", model_n_out=32,
                       conv1_kernel_size=5, voxel_size=0.3,
                       voxel_capacity=8192, point_capacity=16384,
                       complement_pair_dist=2.0, num_complement_one_side=1,
                       pair_min_dist=3, pair_max_dist=10)
        os.makedirs(save_dir)
        with open(os.path.join(save_dir, "config.json"), "w") as f:
            json.dump(run_cfg, f)
        save_checkpoint(os.path.join(save_dir, "best_val_checkpoint.pth"),
                        epoch=1, state_dict=model.state_dict(),
                        optimizer=None, config=run_cfg, best_val=0.0,
                        best_val_epoch=1, best_val_metric="feat_match_ratio")
        config = default_config()
        config.update(run_cfg)
        config.update(save_dir=save_dir, kitti_root=root, test_phase="test",
                      test_num_thread=0, use_RANSAC=True,
                      ransac_hypotheses=N_HYP, rte_thresh=2.0,
                      rre_thresh=5.0)
        t0 = time.perf_counter()
        res = eval_kitti.main(config, device="cuda", max_pairs=3)
        print(f"eval_kitti.main, 3 synthetic pairs: "
              f"{time.perf_counter() - t0:.2f} s")
    _require(len(res["transforms"]) == 3, "eval_kitti ran 3 pairs")
    _require(all(np.isfinite(res[k]) for k in ("rr", "rte", "rre")),
             f"eval_kitti: finite RR, RTE, RRE, got {res}")

    k6 = dict(exp_launches=launches["K6"], exp_k5_convs=k5,
              exp_max_abs_err=max(r["max_abs_err"] for r in k5),
              exp_ms=sum(r["ms"] for r in k5),
              exp_plain_ms=sum(r["plain_ms"] for r in k5),
              exp_bound_ms=sum(r["bound_ms"] for r in k5),
              exp_executed_over_matched=(
                  sum(r["executed_rows"] * r["cin"] * r["cout"] for r in k5)
                  / sum(r["matched_rows"] * r["cin"] * r["cout"]
                        for r in k5)),
              exp_pairs_per_s=pps, exp_stage_ms=stage_ms,
              exp_eval_kitti={k: res[k] for k in ("rr", "rte", "rre")})
    k2 = dict(exp_launches=launches["K2"], exp_max_abs_err=k2_err,
              exp_ms=k2_ms, exp_plain_ms=k2_plain_ms,
              exp_bound_ms=k2_bound[0], exp_bound_by=k2_bound[1])
    return {"K6": k6, "K2": k2}


# the FCGF train step: scripts/train_fcgf_kitti.sh's settings at full width
FCGF_BATCH = 4       # pairs a step
FCGF_NV = 24576      # voxel_capacity, gcl_tpu/config.py's default
FCGF_LAUNCHES = {"K2": 2, "K4": 2, "K6": 40, "K3": 2, "K5": 2, "K7": 40}


def _fcgf_config(**overrides):
    """The run config of scripts/train_fcgf_kitti.sh (its flags over the
    defaults of gcl_tpu_torch/config.py), with ``overrides``."""
    from gcl_tpu_torch.config import default_config

    cfg = default_config(
        dataset="PairComplementKittiDataset",
        train_dataset="PairComplementKittiDataset",
        trainer="HardestContrastiveLossTrainer", model="ResUNetFatBNEXP",
        model_n_out=32, conv1_kernel_size=5, lr=0.1,
        batch_size=FCGF_BATCH, voxel_size=0.3, use_random_scale=True,
        use_random_rotation=True, weight_decay=1e-4, hit_ratio_thresh=0.3,
        complement_pair_dist=10, num_complement_one_side=3,
        use_old_pose=True, pair_min_dist=5, pair_max_dist=20)
    cfg.update(overrides)
    return cfg


def _fcgf_batch(dev):
    """FCGF_BATCH synthetic pairs: bench_infer.py's 65,536-point scans,
    each second scan a known rigid transform (trans: cloud 0 -> cloud 1) of
    the first. (points0, pmask0, points1, pmask1, trans, radius)."""
    import torch
    from gcl_tpu_torch.data.synthetic import synth_lidar

    rng = np.random.RandomState(SEED + 13)
    p0, p1, trans = [], [], []
    for i in range(FCGF_BATCH):
        scan = synth_lidar(rng, N_POINTS)
        t = _rigid(5.0 + 10.0 * i, [1.0 + i, -0.5 * i, 0.1])
        p0.append(scan)
        p1.append(scan @ t[:3, :3].T + t[:3, 3])
        trans.append(t)
    pmask = np.ones((FCGF_BATCH, N_POINTS), bool)
    return tuple(torch.from_numpy(np.asarray(a, dtype)).to(dev) for a, dtype
                 in ((np.stack(p0), np.float32), (pmask, bool),
                     (np.stack(p1), np.float32), (pmask, bool),
                     (np.stack(trans), np.float32),
                     (np.full(FCGF_BATCH, 0.3 * 1.5), np.float32)))


def _fcgf_draws(dev, n_rows: int):
    """The random numbers of one FCGF step (both sides' jitter gates and
    noise, the loss's selections), drawn once for every path."""
    import torch
    from gcl_tpu_torch.losses.pairs import PairLossDraws
    from gcl_tpu_torch.train.steps import PairDraws, StepDraws

    gen = torch.Generator(device=dev).manual_seed(SEED + 13)

    def rand(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    sides = [StepDraws(rand(FCGF_BATCH), (rand(), torch.randn(
        (n_rows, 1), generator=gen, device=dev))) for _ in range(2)]
    return PairDraws(*sides, PairLossDraws(
        pos=rand(1024 * FCGF_BATCH), hn0=rand(256 * FCGF_BATCH),
        hn1=rand(256 * FCGF_BATCH)))


def fcgf_kernel_checks(dev, gpu: str) -> dict:
    """Phase 11a: the kernels of the FCGF step at its geometry (side 0 of
    the batch): K7 on EXP's six k = 5 strided and transposed convs and its
    14 k = 3 convs at their real widths, K3, K4 and K5 at its conv1 with
    the step's row flag. Returns {K: fcgf_* fields} per step (both
    sides)."""
    import torch
    from gcl_tpu_torch.core.coords import lookup
    from gcl_tpu_torch.core.kernel_maps import build_graph
    from gcl_tpu_torch.data.device_pipeline import voxelize_per_cloud
    from gcl_tpu_torch.kernels import (KERNELS, c1z_unpack_bits,
                                       compacted_rows)
    from gcl_tpu_torch.models.common import SparseConv
    from gcl_tpu_torch.models.resunet import ResUNetFatBNEXP
    from gcl_tpu_torch.train.trainer import step_config

    cfg = step_config(_fcgf_config(), FCGF_BATCH * FCGF_NV)
    specs = ResUNetFatBNEXP.conv_specs(5)
    points, pmask = _fcgf_batch(dev)[:2]
    vox = voxelize_per_cloud(points, pmask, cfg.voxel_size, FCGF_NV)
    flat = vox.flatten()
    graph = build_graph(flat.coords, flat.mask, specs, cfg.level_caps,
                        FCGF_BATCH)
    torch.cuda.synchronize()
    print("FCGF levels (side 0): " + ", ".join(
        f"s{s} {lv.coords.shape[0]} rows / {lv.skeys.shape[0]} valid"
        for s, lv in sorted(graph.levels.items())))

    rec = _records("K3", "K4", "K5", "K7")
    run = _runner(rec)
    model = ResUNetFatBNEXP(1, 32, conv1_kernel_size=5)
    convs = {}
    for m in model.modules():
        if isinstance(m, SparseConv) and m.spec.kernel_size in (3, 5) \
                and m.spec.key != "s1->s1/k5d1":
            sig = (m.spec.key, m.spec.kernel_size, m.spec.name, m.in_ch,
                   m.out_ch)
            convs[sig] = convs.get(sig, 0) + 1
    _require(sum(convs.values()) == 20, f"20 EXP convs on K6 / K7, {convs}")
    gen = torch.Generator(device="cpu").manual_seed(SEED + 13)
    per_conv, work = [], {3: [0, 0], 5: [0, 0]}
    for (key, ks, name, cin, cout), mult in sorted(convs.items()):
        s_in, s_out = (int(t[1:]) for t in key.split("/")[0].split("->"))
        lv_in, lv_out = graph.levels[s_in], graph.levels[s_out]
        kvol = ks ** 3
        x = (torch.randn(lv_in.coords.shape[0], cin, generator=gen).to(dev)
             * lv_in.mask[:, None])
        g = (torch.randn(lv_out.coords.shape[0], cout, generator=gen).to(dev)
             * lv_out.mask[:, None])
        w = (torch.randn(kvol, cin, cout, generator=gen).to(dev)
             / (kvol * cin) ** .5)
        rqkey = graph.maps[key].rqkey
        args = (x, g, w, rqkey, lv_out.skeys, lv_out.srow)
        matched, executed = compacted_rows(
            lookup(lv_out.skeys, lv_out.srow, rqkey) >= 0)
        _require(matched > 0, f"K7 FCGF {key}: matched pairs")
        executed = _counted_rows(dev, lambda: KERNELS["K7"][0](*args),
                                 executed, f"K7 FCGF {key} dX")
        staged, blocks = _counted_dw(dev, lambda: KERNELS["K7"][0](*args),
                                     matched, f"K7 FCGF {key} dW")
        mm = 2 * cin * cout
        # both sides of the step launch it: 2 * mult launches
        _, err, ms, pms = run("K7", args, 2 * mult, flops=2 * mm * matched,
                              n_bytes=_nbytes(*args) + _nbytes(x, w))
        work[ks][0] += 2 * mult * mm * matched
        work[ks][1] += 2 * mult * mm * executed
        bound = _bound(_nbytes(*args) + _nbytes(x, w), 2 * mm * matched,
                       "split_tf32")
        per_conv.append(dict(
            conv=name, key=key, count=mult, cin=cin, cout=cout,
            rel_err=err, ms=ms, plain_ms=pms, bound_ms=bound[0],
            bound_by=bound[1], matched_rows=matched, dx_executed_rows=executed,
            dx_executed_over_matched=executed / matched,
            dw_staged_rows=staged, dw_blocks=blocks))
        print(f"K7 FCGF {name} {key} {cin}->{cout} x{mult}: rel_err "
              f"{err:.3g} kernel {ms:.3f} ms plain {pms:.3f} ms bound "
              f"{bound[0]:.4f} ms ({bound[1]}); dX rows matched {matched} "
              f"executed {executed} ({executed / matched:.2f}x); dW staged "
              f"{staged} ({staged / matched:.4f}x, {blocks} blocks)")
        del x, g, w
    for ks, (m_ops, e_ops) in sorted(work.items()):
        print(f"K7 FCGF dX at the k = {ks} convs per step: executed / "
              f"matched {e_ops / m_ops:.3f} by operations")
    _require(work[3][1] <= 1.4 * work[3][0],
             f"K7's dX at EXP's k = 3 convs multiplies at most 1.4 x the "
             f"matched work: {work[3]}")

    # conv1 (k = 5, 1 -> 32): K3 on K2's bitmasks, K4 and K5 with the
    # step's row flag (every valid row: each sample's gate open)
    lv = graph.levels[1]
    c1 = graph.maps["s1->s1/k5d1"]
    n = lv.coords.shape[0]
    w1 = torch.randn(125, 1, 32, generator=gen).to(dev)
    g1 = torch.randn(n, 32, generator=gen).to(dev) * lv.mask[:, None]
    sel = lv.mask.to(torch.float32)
    xs = torch.randn(n, 1, generator=gen).to(dev) * 0.01 * sel[:, None]
    _, sbits = KERNELS["K2"][0](c1.c1z, lv.skeys, w1, torch.float32)
    bits = c1z_unpack_bits(sbits, 125)
    present = int(bits.sum())
    _, e3, _, _ = run("K3", (sbits, g1, 125), mult=2, flops=present * 32,
                      n_bytes=_nbytes(sbits, g1, w1), outs=lambda o: (o,))
    bits_t = bits.to(torch.float32)
    rec["K3"]["library_ms"] = 2 * _ms(lambda: torch.mm(bits_t.T, g1), 3)
    del bits_t
    geo = (c1.c1z, lv.skeys, lv.srow)
    sel_pairs = int((bits * sel[:, None].to(torch.int32)).sum())
    _, e4, _, _ = run(
        "K4", (xs, w1, *geo, sel), mult=2, flops=2 * sel_pairs * 32,
        n_bytes=(_nbytes(w1) + n * 32 * 4
                 + _flagged_bytes(c1.c1z, lv.skeys, sel, 5, xs)),
        outs=lambda o: (o,))
    _, e5, _, _ = run(
        "K5", (xs, g1, *geo, 125, sel), mult=2, flops=2 * sel_pairs * 32,
        n_bytes=_nbytes(w1) + _flagged_bytes(c1.c1z, lv.skeys, sel, 5, xs,
                                             g1),
        outs=lambda o: (o,))
    print(f"FCGF conv1 k5 1->32 ({present} present pairs): K3 rel_err "
          f"{e3:.3g}, K4 {e4:.3g}, K5 {e5:.3g}")
    _bounds(rec, "FCGF step (float32, K3 / K4 / K5 / K7 only)")
    rec["K7"]["convs"] = per_conv
    rec["K7"]["dx_executed_over_matched"] = {
        f"k{ks}": e_ops / m_ops for ks, (m_ops, e_ops) in work.items()}
    return rec


def fcgf_step_checks(dev, gpu: str) -> dict:
    """Phases 11b and 11c: the FCGF train step at full width in float32
    (kernel path against the plain path from the same weights and draws,
    a step with every launch held to its plain version, the exact launch
    counts, 3 timed steps, a timed plain-path step, peak memory) and one
    bf16 step (the same launch counts, every launch against its plain bf16
    version, loss terms within twice the plain path's bf16-vs-float32
    drift). Returns {"launches", "bf16_launches", "step_time_s",
    "pairs_per_s", "plain_step_time_s", "peak_gib", "loss"}."""
    import dataclasses

    import torch
    from gcl_tpu_torch import infer
    from gcl_tpu_torch.kernels import (KERNELS, launch_counts,
                                       reset_launch_counts)
    from gcl_tpu_torch.models.resunet import ResUNetFatBNEXP
    from gcl_tpu_torch.models.weights import gradients_by_name
    from gcl_tpu_torch.train.steps import make_pair_train_step
    from gcl_tpu_torch.train.trainer import step_config

    config = _fcgf_config()
    cfg32 = step_config(config, FCGF_BATCH * FCGF_NV)
    _require(abs(cfg32.search_cell - 1.08) < 1e-9
             and cfg32.jitter_mode == "input" and cfg32.corr_k == 8,
             f"the FCGF step's settings: {cfg32}")
    loss_cfg = dict(config)
    specs = ResUNetFatBNEXP.conv_specs(5)
    batch = _fcgf_batch(dev)
    draws = _fcgf_draws(dev, FCGF_BATCH * FCGF_NV)
    want = {**{k: 0 for k in KERNELS}, **FCGF_LAUNCHES}
    lr = config.lr

    def new_step(dtype=torch.float32):
        model = infer.serving_model(SEED, dev, ResUNetFatBNEXP)
        _, step = make_pair_train_step(
            model, specs, dataclasses.replace(cfg32, compute_dtype=dtype),
            "hardest_contrastive", loss_cfg)
        return model, step

    runs, errs, unequal = {}, {}, {}
    for name, dtype, ctx in (
            ("kernel", torch.float32, contextlib.nullcontext()),
            ("plain", torch.float32, plain_path()),
            ("checked", torch.float32, checked_path(errs)),
            ("bf16_checked", torch.bfloat16, checked_path(errs, unequal)),
            ("bf16_plain", torch.bfloat16, plain_path())):
        model, step = new_step(dtype)
        before = {k: v.clone() for k, v in model.state_dict().items()}
        reset_launch_counts()
        with ctx:
            metrics = step(lr, *batch, draws=draws)
            torch.cuda.synchronize()
        runs[name] = dict(model=model, step=step, before=before,
                          metrics={k: float(v) for k, v in metrics.items()},
                          grads={k: g.clone() for k, g in
                                 gradients_by_name(model).items()},
                          launches=launch_counts())
        print(f"FCGF step, {name}: {runs[name]['metrics']}")
    for name in ("kernel", "checked", "bf16_checked"):
        got = runs[name]["launches"]
        print(f"FCGF launches per step ({name}): "
              f"{ {k: v for k, v in got.items() if v} }")
        _require(got == want, f"FCGF launches per step {FCGF_LAUNCHES}, "
                              f"{name}: {got}")
    for name in ("plain", "bf16_plain"):
        _require(not any(runs[name]["launches"].values()),
                 "the plain path launches no kernel")
    mk, mp = runs["kernel"]["metrics"], runs["plain"]["metrics"]
    _require(abs(mk["loss"] - mp["loss"]) <= 1e-4,
             f"FCGF loss of kernel and plain path within 1e-4: {mk['loss']} "
             f"vs {mp['loss']}")
    _require(mk["num_pos_pairs"] == mp["num_pos_pairs"] > 0,
             f"positives found, equal on both paths: {mk} {mp}")
    _require(sorted(k for k in errs) == sorted(FCGF_LAUNCHES),
             f"every kernel of the FCGF step checked inside it: {errs}")
    print(f"FCGF kernel vs plain inside the step, worst rel_err per kernel "
          f"(float32 and bf16 launches): "
          f"{ {k: float(f'{v:.3g}') for k, v in sorted(errs.items())} }; "
          f"bf16 outputs not bit-equal, largest share: "
          f"{ {k: float(f'{v:.3g}') for k, v in sorted(unequal.items())} }")
    worst = ("", 0.0)
    for pname, ga in runs["kernel"]["grads"].items():
        gb = runs["plain"]["grads"][pname]
        err = float((ga - gb).abs().max()) / float(gb.abs().max())
        worst = max(worst, (pname, err), key=lambda t: t[1])
    print(f"FCGF gradients, kernel path vs plain path: worst {worst[1]:.3g} "
          f"of the tensor's max ({worst[0]})")
    _require(worst[1] <= 0.1, f"FCGF gradient of {worst[0]} within 0.1 of "
                              f"its max, got {worst[1]}")
    terms = ("loss", "pos_loss", "neg_loss")
    m16, p16 = runs["bf16_checked"]["metrics"], runs["bf16_plain"]["metrics"]
    drift = max(abs(p16[t] - mp[t]) for t in terms)
    gap = max(abs(m16[t] - p16[t]) for t in terms)
    print(f"FCGF bf16 loss terms, kernel vs plain path: {gap:.3g} at most; "
          f"twice the plain path's bf16-vs-float32 drift {drift:.3g}: "
          f"{2 * drift:.3g}")
    _require(gap <= 2 * drift, f"FCGF bf16 loss terms within {2 * drift}, "
                               f"got {gap}")

    model, step = runs["kernel"]["model"], runs["kernel"]["step"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        metrics = step(lr, *batch, generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        _require(all(np.isfinite(float(v)) for v in metrics.values()),
                 f"FCGF: finite metrics, got {metrics}")
        _require(float(metrics["num_pos_pairs"]) > 0, "FCGF: positives")
    peak = torch.cuda.max_memory_allocated()
    after = model.state_dict()
    for mname, module in model.named_modules():
        own = [f"{mname}.{p}" for p, _ in module.named_parameters(
            recurse=False)]
        _require(not own or any(
            not torch.equal(after[k], runs["kernel"]["before"][k])
            for k in own), f"FCGF: a parameter of {mname} changed")
    with plain_path():
        t0 = time.perf_counter()
        runs["plain"]["step"](lr, *batch, generator=gen)
        torch.cuda.synchronize()
        plain_dt = time.perf_counter() - t0
    dt = sorted(times)[1]
    print(f"FCGF train step ({FCGF_BATCH} pairs, float32), kernel path: "
          f"step_time_s {dt:.4f} (min {min(times):.4f}, max "
          f"{max(times):.4f}; 3 steps after a warm-up), "
          f"{FCGF_BATCH / dt:.3f} pairs/s, loss {float(metrics['loss']):.6f}, "
          f"positives {int(metrics['num_pos_pairs'])}, valid voxels "
          f"{int(metrics['num_valid_voxels'])}; plain path step_time_s "
          f"{plain_dt:.4f} ({FCGF_BATCH / plain_dt:.3f} pairs/s); peak "
          f"device memory {peak / 2**30:.2f} GiB, on {gpu}")
    return dict(launches=runs["kernel"]["launches"],
                bf16_launches=runs["bf16_checked"]["launches"],
                step_time_s=dt, pairs_per_s=FCGF_BATCH / dt,
                plain_step_time_s=plain_dt, peak_gib=peak / 2 ** 30,
                loss=float(metrics["loss"]))


def fcgf_entry_checks() -> None:
    """Phase 11d: python -m gcl_tpu_torch.train's main on the card on a
    synthetic mini-KITTI in a temporary directory at a small
    voxel_capacity: HardestContrastiveLossTrainer (ResUNetFatBNEXP) for an
    epoch with validation, then a resume for one more epoch; then
    FinestContrastiveLossTrainer (ResUNetFatBN) for an epoch of two
    iterations. Finite losses and the run files; RR is no gate."""
    import os
    import tempfile

    from gcl_tpu_torch.data import colocation, pairs
    from gcl_tpu_torch.data.synthetic import (generate_synthetic_kitti,
                                              write_split_files)
    from gcl_tpu_torch.train import __main__ as entry

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "kitti")
        generate_synthetic_kitti(root, n_drives=1, n_frames=50, step=3.0)
        write_split_files(os.path.join(root, "config"), 1)
        files = {p: os.path.join(root, "config", f"{p}_kitti.txt")
                 for p in ("train", "val", "test")}
        pairs.PairComplementKittiDataset.DATA_FILES = files
        colocation.ColocationKittiDataset.DATA_FILES = files
        small = ["--kitti_root", root, "--voxel_size", "0.3",
                 "--point_capacity", "16384", "--voxel_capacity", "4096",
                 "--nghb_point_capacity", "16384", "--use_old_pose", "false",
                 "--train_num_thread", "0", "--val_num_thread", "0",
                 "--stat_freq", "1", "--max_epoch", "1"]
        run = os.path.join(tmp, "fcgf")
        fcgf = ["--trainer", "HardestContrastiveLossTrainer", "--model",
                "ResUNetFatBNEXP", "--conv1_kernel_size", "5",
                "--train_dataset", "PairComplementKittiDataset",
                "--out_dir", run, "--batch_size", "2", "--pair_min_dist",
                "3", "--pair_max_dist", "10", "--complement_pair_dist", "3",
                "--num_complement_one_side", "2", "--val_max_iter", "2"]
        for argv, what in ((small + fcgf, "FCGF epoch"),
                           (["--resume_dir", run], "FCGF resumed epoch")):
            t0 = time.perf_counter()
            config, device = entry.parse_config(argv)
            trainer = entry.main(config, device)
            with open(os.path.join(run, "scalars.jsonl")) as f:
                losses = [json.loads(line)["value"] for line in f
                          if '"train/loss"' in line]
            print(f"python -m gcl_tpu_torch.train, {what}: "
                  f"{time.perf_counter() - t0:.2f} s, train/loss so far "
                  f"{losses}, best {config.best_val_metric} "
                  f"{trainer.best_val}")
            _require(len(losses) > 0 and np.isfinite(losses).all(),
                     f"{what}: finite train losses, got {losses}")
            for f in ("checkpoint.pth", "config.json",
                      "best_val_checkpoint.pth"):
                _require(os.path.exists(os.path.join(run, f)),
                         f"{what} wrote {f}")
        _require(trainer.start_epoch == 1, "resumed at the saved epoch")
        gcl = os.path.join(tmp, "gcl")
        t0 = time.perf_counter()
        config, device = entry.parse_config(small + [
            "--trainer", "FinestContrastiveLossTrainer", "--model",
            "ResUNetFatBN", "--train_dataset", "ColocationKittiDataset",
            "--out_dir", gcl, "--batch_size", "1", "--num_neighborhood",
            "2", "--min_dist", "3", "--max_dist", "18", "--test_valid",
            "false"])
        real = entry.make_data_loader

        def two_samples(*a, **kw):
            loader = real(*a, **kw)
            loader.dataset.files = loader.dataset.files[:2]
            return loader

        entry.make_data_loader = two_samples
        try:
            entry.main(config, device)
        finally:
            entry.make_data_loader = real
        with open(os.path.join(gcl, "scalars.jsonl")) as f:
            losses = [json.loads(line)["value"] for line in f
                      if '"train/loss"' in line]
        print(f"python -m gcl_tpu_torch.train, GCL epoch of 2 iterations: "
              f"{time.perf_counter() - t0:.2f} s, train/loss {losses}")
        _require(len(losses) == 2 and np.isfinite(losses).all()
                 and os.path.exists(os.path.join(gcl, "checkpoint.pth")),
                 f"GCL epoch: two finite losses and a checkpoint, {losses}")


# data parallel on the one card (phase 12): two ranks over gloo share it
DP_RANKS = 2
DP_JOIN_S = 900.0   # a rank that hangs fails the run after this
GCL_STEP_LAUNCHES = {"K1": 1, "K2": 1, "K3": 1, "K4": 1, "K5": 1, "K6": 20,
                     "K7": 20}


def _dp_case(kind: str, rank: int, world_size: int, dev):
    """(model, per-shard grad_fn, shard, full batch, per-shard batch size,
    StepConfig, lr) of a data-parallel case on this rank: 'gcl', root
    bench.py's bf16 GCL step (4 x 7 clouds, 2 x 7 a rank), or 'fcgf',
    phase 11's float32 FCGF pair step (4 pairs, 2 a rank)."""
    from gcl_tpu_torch import bench, infer
    from gcl_tpu_torch.losses.gcl import GCLLossConfig
    from gcl_tpu_torch.models.resunet import ResUNetFatBNEXP
    from gcl_tpu_torch.train.steps import make_gcl_grad_fn, make_pair_grad_fn
    from gcl_tpu_torch.train.trainer import step_config

    if kind == "gcl":
        per = BATCH // world_size
        model = bench.bench_model(SEED, dev)
        specs, cfg = bench.bench_config(per, NV_CAP)
        grad_fn = make_gcl_grad_fn(
            model, specs, cfg, GCLLossConfig(block_finest_gradient=False),
            "finest", max_pos_cluster=256 * per, max_hn_samples=256 * per,
            pos_weight=1.0, finest_weight=1.0, neg_weight=1.0)
        full = bench.bench_batch(SEED, BATCH, N_POINTS, dev)
        lr = 0.1
    else:
        per = FCGF_BATCH // world_size
        config = _fcgf_config(batch_size=per)
        cfg = step_config(config, per * FCGF_NV)
        model = infer.serving_model(SEED, dev, ResUNetFatBNEXP)
        grad_fn = make_pair_grad_fn(model, ResUNetFatBNEXP.conv_specs(5), cfg,
                                    "hardest_contrastive", dict(config))
        full = _fcgf_batch(dev)
        lr = config.lr
    shard = tuple(a[rank * per:(rank + 1) * per] for a in full)
    return model, grad_fn, shard, full, per, cfg, lr


def _flat(tensors):
    import torch

    return torch.cat([t.detach().reshape(-1).float() for t in tensors])


def _dp_rank_case(kind: str, rank: int, world_size: int, dev) -> dict:
    """One data-parallel case on this rank (phase 12): the lifted grad_fn
    once, with the shard's unreduced gradients and BN statistics captured
    inside it, against their mean over the ranks; on rank 0 the same two
    shards and draws in one process; a step with every launch held to its
    plain version; 3 timed SGD steps, after which the parameters of the
    ranks must be equal bit for bit."""
    import torch
    import torch.distributed as dist
    from gcl_tpu_torch.kernels import launch_counts, reset_launch_counts
    from gcl_tpu_torch.parallel import fold_in, make_global_grad_fn
    from gcl_tpu_torch.train.steps import (make_optimizer,
                                           make_train_step_from_grad)

    model, grad_fn, shard, full, per, cfg, lr = _dp_case(
        kind, rank, world_size, dev)
    start = {k: v.clone() for k, v in model.state_dict().items()}
    params = [p for p in model.parameters()]
    bufs = [b for b in model.buffers() if b.is_floating_point()]
    inner = {}

    def spy(*a, **kw):
        m = grad_fn(*a, **kw)
        inner.update(grads=_flat(p.grad for p in params), bufs=_flat(bufs),
                     loss=float(m["loss"]))
        return m

    lifted = make_global_grad_fn(spy, model)
    seed = SEED + 7
    reset_launch_counts()
    metrics = lifted(*shard,
                     generator=torch.Generator(device=dev).manual_seed(seed))
    torch.cuda.synchronize()
    launches = launch_counts()
    out = {"launches": launches, "loss": float(metrics["loss"]),
           "shard_loss": inner["loss"]}
    for what, got in (("grads", _flat(p.grad for p in params)),
                      ("bufs", _flat(bufs))):
        parts = [torch.empty_like(inner[what]).cpu()
                 for _ in range(world_size)]
        dist.all_gather(parts, inner[what].cpu())
        mean = sum(parts) / world_size
        out[f"{what}_reduce_err"] = float(
            (got.cpu() - mean).abs().max() / mean.abs().max())
        out[f"{what}_rank_spread"] = float(
            (parts[0] - parts[1]).abs().max() / mean.abs().max())
    if rank == 0:
        # the same two shards and draws, one after the other, here
        alone = []
        for r in range(world_size):
            model.load_state_dict(start)
            gen = fold_in(torch.Generator(device=dev).manual_seed(seed), r)
            m = grad_fn(*(a[r * per:(r + 1) * per] for a in full),
                        generator=gen)
            alone.append(float(m["loss"]))
        torch.cuda.synchronize()
        out["one_process_loss"] = sum(alone) / world_size
        out["one_process_shard_losses"] = alone
    model.load_state_dict(start)
    errs, unequal = {}, {}
    with checked_path(errs, unequal):
        lifted(*shard, generator=torch.Generator(device=dev).manual_seed(1))
        torch.cuda.synchronize()
    out["checked"] = {k: float(v) for k, v in errs.items()}
    out["bf16_unequal"] = {k: float(v) for k, v in unequal.items()}

    model.load_state_dict(start)
    opt = make_optimizer(model.parameters(), cfg)
    step = make_train_step_from_grad(opt, lifted)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    times = []
    for _ in range(3):
        dist.barrier()
        t0 = time.perf_counter()
        m = step(lr, *shard, generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        _require(np.isfinite(float(m["loss"])), f"{kind} rank {rank}: "
                                                f"finite loss")
    flat = _flat(model.parameters()).cpu()
    parts = [torch.empty_like(flat) for _ in range(world_size)]
    dist.all_gather(parts, flat)
    out["params_bit_equal"] = all(_bit_equal(parts[0], p) for p in parts)
    out["params_moved"] = bool((flat != _flat(
        start[k] for k, _ in model.named_parameters()).cpu()).any())
    out["step_time_s"] = times
    out["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    return out


def dp_rank_checks(rank: int, world_size: int, out_path: str,
                   device: str) -> None:
    """Phase 12a on one rank (spawned; every rank on ``device``, the one
    card, over gloo): the bf16 GCL step and the float32 FCGF step, written
    to out_path % rank."""
    import torch

    dev = torch.device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", dev.index or 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {kind: _dp_rank_case(kind, rank, world_size, dev)
           for kind in ("gcl", "fcgf")}
    with open(out_path % rank, "w") as f:
        json.dump(out, f)


def dp_checks(dev, gpu: str) -> dict:
    """Phase 12: data parallelism on the one card. (a) two ranks on cuda:0
    over gloo (NCCL refuses two ranks on one device) run root bench.py's
    bf16 GCL step at 4 x 7 clouds (2 x 7 a rank) and phase 11's float32
    FCGF step at 4 pairs (2 a rank): each rank's reduced gradients and BN
    statistics equal the mean of both ranks' unreduced ones, the averaged
    loss equals the one-process steps on the same two shards and draws
    within 1e-4, every launch inside a step holds against its plain
    version, the launches per rank a step are exact, and after 3 steps
    the parameters are bit-equal across the ranks; (b) python -m
    gcl_tpu_torch.bench --data_parallel at world size 1 on NCCL against
    the plain bench at 4 x 7 bf16, in turns; (c) an FCGF trainer epoch of
    2 iterations under --data_parallel true --num_devices 1; (d) the same
    epoch under torchrun --nproc_per_node 1 with --distributed_init true
    (NCCL over env://). Returns the numbers for the kernels line and
    PERF.md."""
    import os
    import signal
    import subprocess
    import tempfile

    import torch
    from gcl_tpu_torch import bench
    from gcl_tpu_torch.kernels import launch_counts, reset_launch_counts
    from gcl_tpu_torch.parallel import spawn

    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        spawn(dp_rank_checks, DP_RANKS,
              (os.path.join(tmp, "rank%d.json"), str(dev)), backend="gloo",
              join_timeout=DP_JOIN_S)
        ranks = []
        for r in range(DP_RANKS):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
    print(f"data parallel, {DP_RANKS} ranks on one card (gloo): "
          f"{time.perf_counter() - t0:.1f} s with the ranks' start")
    want = {"gcl": GCL_STEP_LAUNCHES, "fcgf": FCGF_LAUNCHES}
    for kind in ("gcl", "fcgf"):
        for r, out in enumerate(ranks):
            o = out[kind]
            got = {k: v for k, v in o["launches"].items() if v}
            print(f"DP {kind} rank {r}: launches {got}; reduced gradients "
                  f"vs the mean of the ranks' unreduced ones "
                  f"{o['grads_reduce_err']:.3g} of the max (the ranks' own "
                  f"differ by {o['grads_rank_spread']:.3g}), BN statistics "
                  f"{o['bufs_reduce_err']:.3g} (ranks {o['bufs_rank_spread']:.3g}); "
                  f"loss {o['loss']:.6f} (its shard's {o['shard_loss']:.6f}); "
                  f"worst rel_err inside the checked step "
                  f"{ {k: float(f'{v:.3g}') for k, v in o['checked'].items()} }; "
                  f"3 steps {[round(t, 4) for t in o['step_time_s']]} s; "
                  f"params bit-equal {o['params_bit_equal']}; peak "
                  f"{o['peak_gib']:.2f} GiB")
            _require(got == want[kind], f"DP {kind} rank {r}: launches "
                                        f"{want[kind]}, got {got}")
            _require(o["grads_reduce_err"] <= 1e-6
                     and o["bufs_reduce_err"] <= 1e-6,
                     f"DP {kind} rank {r}: reduced = mean of the ranks' "
                     f"unreduced gradients and statistics: {o}")
            _require(o["grads_rank_spread"] > 0,
                     f"DP {kind}: the ranks' shards differ")
            _require(sorted(o["checked"]) == sorted(want[kind]),
                     f"DP {kind} rank {r}: every kernel checked in the "
                     f"step, {o['checked']}")
            _require(o["params_bit_equal"] and o["params_moved"],
                     f"DP {kind} rank {r}: parameters moved and bit-equal "
                     f"across the ranks after 3 steps")
        one, got = ranks[0][kind]["one_process_loss"], ranks[0][kind]["loss"]
        _require(ranks[1][kind]["loss"] == got,
                 f"DP {kind}: the ranks' averaged losses equal")
        print(f"DP {kind}: averaged loss {got:.6f}, one process on the same "
              f"shards and draws {one:.6f} (shards "
              f"{ranks[0][kind]['one_process_shard_losses']})")
        _require(abs(got - one) <= 1e-4, f"DP {kind}: loss within 1e-4 of "
                                         f"the one-process steps")
        res[kind] = dict(launches=ranks[0][kind]["launches"],
                         step_time_s=sorted(
                             ranks[0][kind]["step_time_s"])[1],
                         peak_gib=max(o[kind]["peak_gib"] for o in ranks))

    # (b) the benchmark at world size 1 on NCCL beside the plain one
    common = ["--batch_size", str(BATCH), "--iters", "5", "--reps", "3",
              "--seed", str(SEED), "--points", str(N_POINTS), "--nv",
              str(NV_CAP), "--device", dev.type]
    n_steps = 1 + 5 * 3
    bench_out = {"plain": [], "data_parallel": []}
    for name in ("plain", "data_parallel", "data_parallel", "plain"):
        reset_launch_counts()
        out = bench.main(common + (["--data_parallel"]
                                   if name == "data_parallel" else []))
        torch.cuda.synchronize()
        got = {k: v for k, v in launch_counts().items() if v}
        _require(got == {k: n_steps * v for k, v in
                         GCL_STEP_LAUNCHES.items()},
                 f"bench {name}: {n_steps} steps' launches, got {got}")
        _require(out["data_parallel"] == (1 if name == "data_parallel"
                                          else 0), f"bench {name}: {out}")
        bench_out[name].append(out["step_time_s"])
        torch.cuda.empty_cache()
    print(f"bench 4 x 7 bf16 step_time_s (medians of 3 x 5 steps, run "
          f"plain, DP, DP, plain): plain {bench_out['plain']}, data "
          f"parallel at world size 1 (NCCL) {bench_out['data_parallel']}, "
          f"on {gpu}")
    res["bench"] = bench_out

    # (c) a trainer epoch of 2 iterations, data-parallel on one card
    from gcl_tpu_torch.data import pairs
    from gcl_tpu_torch.data.synthetic import (generate_synthetic_kitti,
                                              write_split_files)
    from gcl_tpu_torch.train import __main__ as entry

    with tempfile.TemporaryDirectory() as tmp:
        root = os.path.join(tmp, "kitti")
        generate_synthetic_kitti(root, n_drives=1, n_frames=32, step=3.0)
        write_split_files(os.path.join(root, "config"), 1)
        pairs.PairComplementKittiDataset.DATA_FILES = {
            p: os.path.join(root, "config", f"{p}_kitti.txt")
            for p in ("train", "val", "test")}
        run = os.path.join(tmp, "run")
        argv = [
            "--kitti_root", root, "--trainer",
            "HardestContrastiveLossTrainer", "--model", "ResUNetFatBNEXP",
            "--conv1_kernel_size", "5", "--train_dataset",
            "PairComplementKittiDataset", "--batch_size", "2",
            "--voxel_size", "0.3", "--point_capacity", "16384",
            "--voxel_capacity", "4096", "--nghb_point_capacity", "16384",
            "--use_old_pose", "false", "--pair_min_dist", "3",
            "--pair_max_dist", "10", "--complement_pair_dist", "3",
            "--num_complement_one_side", "2", "--val_max_iter", "1",
            "--train_num_thread", "0", "--val_num_thread", "0",
            "--stat_freq", "1", "--max_epoch", "1", "--data_parallel",
            "true", "--num_devices", "1", "--device", dev.type]
        config, device = entry.parse_config(argv + ["--out_dir", run])
        t0 = time.perf_counter()
        reset_launch_counts()
        trainer = entry.main(config, device)
        torch.cuda.synchronize()
        got = launch_counts()
        with open(os.path.join(run, "scalars.jsonl")) as f:
            losses = [json.loads(line)["value"] for line in f
                      if '"train/loss"' in line]
        print(f"python -m gcl_tpu_torch.train --data_parallel true "
              f"--num_devices 1: {time.perf_counter() - t0:.2f} s, "
              f"train/loss {losses}, launches "
              f"{ {k: v for k, v in got.items() if v} }")
        _require(trainer.data_parallel and trainer.n_shards == 1,
                 "the trainer ran as the one rank of a process group")
        _require(len(losses) == 2 and np.isfinite(losses).all()
                 and os.path.exists(os.path.join(run, "checkpoint.pth")),
                 f"DP trainer epoch: 2 finite losses and a checkpoint, "
                 f"{losses}")
        # 2 steps of both sides' backward; validation runs no backward
        _require(got["K7"] == 2 * FCGF_LAUNCHES["K7"]
                 and got["K3"] == 2 * FCGF_LAUNCHES["K3"]
                 and got["K5"] == 2 * FCGF_LAUNCHES["K5"],
                 f"DP trainer epoch: the 2 steps' backward launches, {got}")
        res["trainer_launches"] = got

        # (d) the same epoch under torchrun --distributed_init true: the
        # env:// rendezvous on NCCL, cuda:LOCAL_RANK, the kernel library
        # loaded behind build_kernels_once's barrier
        run_tr = os.path.join(tmp, "torchrun")
        t0 = time.perf_counter()
        proc = subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", "1", "-m", "gcl_tpu_torch.train", *argv,
             "--out_dir", run_tr, "--distributed_init", "true"],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, start_new_session=True,
            env={**os.environ, "PYTHONPATH": os.pathsep.join(
                p for p in (os.path.dirname(os.path.abspath(__file__)),
                            os.environ.get("PYTHONPATH")) if p)})
        try:
            out, _ = proc.communicate(timeout=DP_JOIN_S)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.communicate()
            raise
        _require(proc.returncode == 0,
                 f"torchrun --distributed_init true: exit "
                 f"{proc.returncode}\n{out[-3000:]}")
        with open(os.path.join(run_tr, "scalars.jsonl")) as f:
            losses_tr = [json.loads(line)["value"] for line in f
                         if '"train/loss"' in line]
        print(f"torchrun --nproc_per_node 1 -m gcl_tpu_torch.train "
              f"--distributed_init true: {time.perf_counter() - t0:.2f} s "
              f"with the process's start, train/loss {losses_tr}")
        _require("Data-parallel rank 0 of 1" in out
                 and "on cuda:0" in out,
                 "torchrun: the trainer ran as rank 0 of 1 on cuda:0")
        _require(len(losses_tr) == 2 and np.isfinite(losses_tr).all()
                 and os.path.exists(os.path.join(run_tr, "checkpoint.pth")),
                 f"torchrun epoch: 2 finite losses and a checkpoint, "
                 f"{losses_tr}")
        res["torchrun_losses"] = losses_tr
    return res


# the zoo on the card (phase 13): the FCGF step of phase 11 with V2 and the
# instance-norm ResUNetIN2E at their full published widths
ZOO = {"ResUNetFatBNEXP_V2": 22, "ResUNetIN2E": 20}   # convs on K6 / K7
V2_EXTRA = ("conv1_extra", "conv1_tr_extra")


def zoo_kernel_checks(dev, gpu: str) -> dict:
    """Phase 13a: K6 and K7 at V2's conv1_extra (1 -> 5, k = 5, dilation
    5, 32 -> 32) and conv1_tr_extra (5 -> 1, dilation 4, 160 -> 128) on
    the FCGF batch's side 0: against their plain versions, timed, bounds,
    the rows each gather-GEMM executes against the matched rows (counted
    by the kernel), K7's dW staged rows. Returns {conv: numbers}."""
    import torch
    from gcl_tpu_torch.core.coords import lookup
    from gcl_tpu_torch.core.kernel_maps import build_graph
    from gcl_tpu_torch.data.device_pipeline import voxelize_per_cloud
    from gcl_tpu_torch.kernels import KERNELS, compacted_rows
    from gcl_tpu_torch.models.resunet import ResUNetFatBNEXP_V2
    from gcl_tpu_torch.train.trainer import step_config

    config = _fcgf_config(model="ResUNetFatBNEXP_V2")
    cfg = step_config(config, FCGF_BATCH * FCGF_NV)
    specs = ResUNetFatBNEXP_V2.conv_specs(5)
    points, pmask = _fcgf_batch(dev)[:2]
    flat = voxelize_per_cloud(points, pmask, cfg.voxel_size,
                              FCGF_NV).flatten()
    graph = build_graph(flat.coords, flat.mask, specs, cfg.level_caps,
                        FCGF_BATCH)
    torch.cuda.synchronize()
    print("V2 levels (FCGF side 0): " + ", ".join(
        f"s{s} {lv.coords.shape[0]} rows / {lv.skeys.shape[0]} valid"
        for s, lv in sorted(graph.levels.items())))
    model = ResUNetFatBNEXP_V2(1, 32, conv1_kernel_size=5)
    rec = _records("K6", "K7")
    run = _runner(rec)
    gen = torch.Generator(device="cpu").manual_seed(SEED + 17)
    out = {}
    for name in V2_EXTRA:
        conv = getattr(model, name)
        sp, cin, cout = conv.spec, conv.in_ch, conv.out_ch
        lv_in, lv_out = graph.levels[sp.in_stride], graph.levels[sp.out_stride]
        x = (torch.randn(lv_in.coords.shape[0], cin, generator=gen).to(dev)
             * lv_in.mask[:, None])
        g = (torch.randn(lv_out.coords.shape[0], cout, generator=gen).to(dev)
             * lv_out.mask[:, None])
        w = torch.randn(125, cin, cout, generator=gen).to(dev) / (
            125 * cin) ** .5
        cmap = graph.maps[sp.key]
        fwd = (x, w, cmap.qkey, lv_in.skeys, lv_in.srow)
        bwd = (x, g, w, cmap.rqkey, lv_out.skeys, lv_out.srow)
        mm = 2 * cin * cout
        r = {"key": sp.key, "cin": cin, "cout": cout}
        for k, args, skeys, srow, keys, n_bytes in (
                ("K6", fwd, lv_in.skeys, lv_in.srow, cmap.qkey,
                 _nbytes(*fwd) + lv_out.coords.shape[0] * cout * 4),
                ("K7", bwd, lv_out.skeys, lv_out.srow, cmap.rqkey,
                 _nbytes(*bwd) + _nbytes(x, w))):
            matched, executed = compacted_rows(lookup(skeys, srow, keys) >= 0)
            _require(matched > 0, f"{k} at V2's {name}: matched rows")
            executed = _counted_rows(dev, lambda: KERNELS[k][0](*args),
                                     executed, f"{k} at V2's {name}")
            flops = (1 if k == "K6" else 2) * mm * matched
            _, err, ms, pms = run(k, args, 1, n_bytes=n_bytes, flops=flops,
                                  outs=(lambda o: (o,)) if k == "K6"
                                  else (lambda o: o))
            bound = _bound(n_bytes, flops, "split_tf32")
            r[k] = dict(rel_err=err, ms=ms, plain_ms=pms, bound_ms=bound[0],
                        bound_by=bound[1], matched_rows=matched,
                        executed_rows=executed,
                        executed_over_matched=executed / matched)
            if k == "K7":
                r[k]["dw_staged_rows"], r[k]["dw_blocks"] = _counted_dw(
                    dev, lambda: KERNELS["K7"][0](*bwd), matched,
                    f"K7 at V2's {name} dW")
            print(f"{k} at V2's {name} {sp.key} {cin}->{cout}: rel_err "
                  f"{err:.3g} kernel {ms:.3f} ms plain {pms:.3f} ms bound "
                  f"{bound[0]:.4f} ms ({bound[1]}); rows matched {matched} "
                  f"executed {executed} ({executed / matched:.2f}x), on "
                  f"{gpu}")
        out[name] = r
        del x, g, w
    return out


def zoo_step_checks(dev, gpu: str, name: str) -> dict:
    """Phase 13b: phase 11's float32 FCGF step with ``name`` at its full
    published widths: a kernel-path and a plain-path step from the same
    weights and draws (loss within 1e-4, gradients within 0.1 of each
    tensor's max), a step with every launch held to its plain version, the
    launches exactly K2 2, K4 2, K3 2, K5 2 and K6 = K7 = 2 x its convs, 3
    timed steps and the peak memory."""
    import torch
    from gcl_tpu_torch import infer
    from gcl_tpu_torch.kernels import (KERNELS, launch_counts,
                                       reset_launch_counts)
    from gcl_tpu_torch.models import load_model
    from gcl_tpu_torch.models.weights import gradients_by_name
    from gcl_tpu_torch.train.steps import make_pair_train_step
    from gcl_tpu_torch.train.trainer import step_config

    config = _fcgf_config(model=name)
    cfg = step_config(config, FCGF_BATCH * FCGF_NV)
    cls = load_model(name)
    batch = _fcgf_batch(dev)
    draws = _fcgf_draws(dev, FCGF_BATCH * FCGF_NV)
    n = ZOO[name]
    want = {**{k: 0 for k in KERNELS}, "K2": 2, "K4": 2, "K3": 2, "K5": 2,
            "K6": 2 * n, "K7": 2 * n}
    runs, errs = {}, {}
    for path, ctx in (("kernel", contextlib.nullcontext()),
                      ("plain", plain_path()),
                      ("checked", checked_path(errs))):
        model = infer.serving_model(SEED, dev, cls)
        opt, step = make_pair_train_step(model, cls.conv_specs(5), cfg,
                                         "hardest_contrastive", dict(config))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launch_counts()
        with ctx:
            m = step(config.lr, *batch, draws=draws)
            torch.cuda.synchronize()
        runs[path] = dict(model=model, step=step, launches=launch_counts(),
                          metrics={k: float(v) for k, v in m.items()},
                          grads={k: g.clone() for k, g in
                                 gradients_by_name(model).items()})
        print(f"{name} FCGF step, {path}: {runs[path]['metrics']}")
    for path in ("kernel", "checked"):
        _require(runs[path]["launches"] == want,
                 f"{name} launches per step {path}: "
                 f"{ {k: v for k, v in runs[path]['launches'].items() if v} }")
    _require(not any(runs["plain"]["launches"].values()),
             "the plain path launches no kernel")
    _require(sorted(errs) == sorted(k for k, v in want.items() if v),
             f"{name}: every kernel checked inside the step, {errs}")
    mk, mp = runs["kernel"]["metrics"], runs["plain"]["metrics"]
    _require(abs(mk["loss"] - mp["loss"]) <= 1e-4 and mk["num_pos_pairs"]
             == mp["num_pos_pairs"] > 0,
             f"{name}: loss within 1e-4 and equal positives, {mk} {mp}")
    worst = max(((float((g - runs["plain"]["grads"][k]).abs().max())
                  / float(runs["plain"]["grads"][k].abs().max()), k)
                 for k, g in runs["kernel"]["grads"].items()))
    print(f"{name}: worst rel_err inside the checked step "
          f"{ {k: float(f'{v:.3g}') for k, v in sorted(errs.items())} }; "
          f"gradients kernel vs plain path: worst {worst[0]:.3g} of the "
          f"tensor's max ({worst[1]})")
    _require(worst[0] <= 0.1, f"{name}: gradients within 0.1, {worst}")
    step = runs["kernel"]["step"]
    gen = torch.Generator(device=dev).manual_seed(SEED)
    times = []
    for _ in range(3):
        t0 = time.perf_counter()
        m = step(config.lr, *batch, generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        _require(np.isfinite(float(m["loss"])), f"{name}: finite loss")
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    dt = sorted(times)[1]
    print(f"{name} FCGF train step ({FCGF_BATCH} pairs, float32): "
          f"step_time_s {dt:.4f} (min {min(times):.4f}, max "
          f"{max(times):.4f}), {FCGF_BATCH / dt:.3f} pairs/s, peak device "
          f"memory {peak:.2f} GiB, on {gpu}")
    return dict(launches=runs["kernel"]["launches"], step_time_s=dt,
                pairs_per_s=FCGF_BATCH / dt, peak_gib=peak,
                loss=mk["loss"], checked=errs)


# the entry points (phase 14): the demo, the ETH evaluation, the SC2-PCR
# benchmark, each through its main on the card
ETH_VOXEL = 0.05
ETH_KEYPOINTS = 5000
SC2_PAIRS = 4
SC2_SHARED = 0.7     # rows whose descriptor the partner row shares


def _k3_signatures(model) -> dict:
    """{(map key, in stride, Cin, Cout): convs} of the model's k = 3
    convs, the convs that run on K6."""
    from gcl_tpu_torch.models.common import SparseConv

    convs = {}
    for m in model.modules():
        if isinstance(m, SparseConv) and m.spec.kernel_size == 3:
            sig = (m.spec.key, m.spec.in_stride, m.in_ch, m.out_ch)
            convs[sig] = convs.get(sig, 0) + 1
    return convs


def _one_cloud_graph(model, xyz: np.ndarray, voxel: float, dev):
    """The graph extract_features builds for one cloud: capacity N rounded
    up to 4096, default_level_caps(n_cap, strides, 0.7)."""
    import torch
    from gcl_tpu_torch.core.kernel_maps import build_graph, default_level_caps
    from gcl_tpu_torch.data.device_pipeline import voxelize_per_cloud

    n_cap = -(-len(xyz) // 4096) * 4096
    specs = type(model).conv_specs(model.conv1.spec.kernel_size)
    strides = sorted({s for sp in specs for s in (sp.in_stride,
                                                  sp.out_stride)})
    pts = torch.zeros((1, n_cap, 3), device=dev)
    pts[0, :len(xyz)] = torch.from_numpy(np.asarray(xyz, np.float32))
    pmask = torch.zeros((1, n_cap), dtype=torch.bool, device=dev)
    pmask[0, :len(xyz)] = True
    flat = voxelize_per_cloud(pts, pmask, voxel, n_cap).flatten()
    return build_graph(flat.coords, flat.mask, specs,
                       default_level_caps(n_cap, strides, 0.7), 1)


def _geometry_kernels(model, xyz: np.ndarray, voxel: float, dev,
                      what: str) -> dict:
    """K6 on each k = 3 conv of the model and K2 on its conv1 at the graph
    of one cloud, with random features and weights at the real widths:
    within REL_TOL of the plain version's max (K2's bits equal), times
    of both (CUDA events) and the bound, K6 summed over the convs by
    multiplicity. Returns {"K6": {...}, "K2": {...}}."""
    import torch
    from gcl_tpu_torch.core.coords import lookup
    from gcl_tpu_torch.kernels import (c1z_unpack_bits, occupancy_conv_fwd,
                                       occupancy_conv_fwd_plain,
                                       sparse_conv_implicit_fwd,
                                       sparse_conv_implicit_fwd_plain)

    graph = _one_cloud_graph(model, xyz, voxel, dev)
    print(f"{what} levels: " + ", ".join(
        f"s{s} {lv.coords.shape[0]} rows / {lv.skeys.shape[0]} valid"
        for s, lv in sorted(graph.levels.items())))
    g = torch.Generator(device="cpu").manual_seed(SEED + 14)
    k6 = dict(max_abs_err=0.0, ms=0.0, plain_ms=0.0, n_bytes=0, flops=0)
    for (key, s_in, cin, cout), mult in sorted(
            _k3_signatures(model).items()):
        lv = graph.levels[s_in]
        x = (torch.randn(lv.coords.shape[0], cin, generator=g).to(dev)
             * lv.mask[:, None])
        w = torch.randn(27, cin, cout, generator=g).to(dev) / (27 * cin) ** .5
        args = (x, w, graph.maps[key].qkey, lv.skeys, lv.srow)
        out = sparse_conv_implicit_fwd(*args)
        ref = sparse_conv_implicit_fwd_plain(*args)
        _rel_err(out, ref, f"K6 {what} {key}")
        k6["max_abs_err"] = max(k6["max_abs_err"],
                                float((out - ref).abs().max()))
        k6["ms"] += mult * _ms(lambda: sparse_conv_implicit_fwd(*args), REPS)
        k6["plain_ms"] += mult * _ms(
            lambda: sparse_conv_implicit_fwd_plain(*args), 2)
        matched = int((lookup(lv.skeys, lv.srow, args[2]) >= 0).sum())
        k6["n_bytes"] += mult * _nbytes(*args, out)
        k6["flops"] += mult * 2 * matched * cin * cout
    k6["bound_ms"], k6["bound_by"] = _bound(k6.pop("n_bytes"),
                                            k6.pop("flops"), "split_tf32")
    k = model.conv1.spec.kernel_size
    c1 = graph.maps[f"s1->s1/k{k}d1"]
    w1 = torch.randn(k ** 3, 1, model.conv1.out_ch, generator=g).to(dev)
    k2_args = (c1.c1z, graph.levels[1].skeys, w1)
    out, sbits = occupancy_conv_fwd(*k2_args)
    ref, ref_bits = occupancy_conv_fwd_plain(*k2_args)
    _require(torch.equal(sbits, ref_bits), f"K2 {what}: sbits equal")
    _rel_err(out, ref, f"K2 {what}")
    k2 = dict(max_abs_err=float((out - ref).abs().max()),
              ms=_ms(lambda: occupancy_conv_fwd(*k2_args), REPS),
              plain_ms=_ms(lambda: occupancy_conv_fwd_plain(*k2_args), 2))
    k2["bound_ms"], k2["bound_by"] = _bound(
        _k2_bytes(*k2_args, out, sbits),
        model.conv1.out_ch * int(c1z_unpack_bits(sbits, k ** 3).sum()))
    for name, r in (("K6", k6), ("K2", k2)):
        print(f"{name} at {what}: max_abs_err {r['max_abs_err']:.3g} "
              f"kernel {r['ms']:.4f} ms plain {r['plain_ms']:.3f} ms bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    return {"K6": k6, "K2": k2}


def _counted(fn):
    """(fn's result, the kernel launches it made): the counts set to 0
    just before and read just after."""
    import torch
    from gcl_tpu_torch.kernels import launch_counts, reset_launch_counts

    reset_launch_counts()
    out = fn()
    torch.cuda.synchronize()
    return out, launch_counts()


def _launches(model, clouds: int) -> dict:
    """The launches of ``clouds`` extract calls: K2 once (conv1) and K6
    once a k = 3 conv, each a cloud; no other kernel."""
    from gcl_tpu_torch.kernels import KERNELS

    n6 = sum(_k3_signatures(model).values())
    return {**{k: 0 for k in KERNELS}, "K2": clouds, "K6": clouds * n6}


def demo_checks(dev, gpu: str, tmp: str) -> dict:
    """Phase 14a: python -m gcl_tpu_torch.demo's main with ResUNetBN2C(1,
    32, conv1 k = 5) and seeded weights, on the default synthetic scan and
    on an N_POINTS-point scan written as a KITTI .bin."""
    import os

    import torch
    from gcl_tpu_torch import demo
    from gcl_tpu_torch.data.synthetic import synth_lidar
    from gcl_tpu_torch.train import import_torch
    from gcl_tpu_torch.utils import visualization
    from gcl_tpu_torch.utils.misc import extract_features
    from gcl_tpu_torch.utils.pointcloud import read_ply_xyz

    scan = os.path.join(tmp, "scan.bin")
    pts = synth_lidar(np.random.RandomState(SEED), N_POINTS)
    np.concatenate([pts, np.zeros((len(pts), 1), np.float32)],
                   1).astype(np.float32).tofile(scan)
    model = demo.demo_model("ResUNetBN2C", 32, 5, None).to(dev)
    real_tsne = visualization.embed_tsne
    embedded = []

    def kept(data):
        embedded.append(real_tsne(data))
        return embedded[-1]

    visualization.embed_tsne = kept
    out = {}
    try:
        for name, path in (("synthetic", None), ("scan_65536", scan)):
            xyz = demo.read_cloud(path)
            ply = os.path.join(tmp, f"demo_{name}.ply")
            argv = ["--output", ply] + (["--input", path] if path else [])
            stats, launches = _counted(lambda: demo.main(argv))
            want = _launches(model, 1)
            _require(launches == want, f"demo {name}: launches {want}, got "
                                       f"{launches}")
            errs = {}
            with checked_path(errs):
                extract_features(model, xyz, voxel_size=0.3, device=dev)
            _require(set(errs) == {"K2", "K6"},
                     f"demo {name}: K2 and K6 checked, got {errs}")
            v, f = extract_features(model, xyz, voxel_size=0.3, device=dev)
            _require(np.array_equal(read_ply_xyz(ply), v.cpu().numpy()),
                     f"demo {name}: the .ply's points are the voxels' "
                     f"representative points")
            t = embedded[-1]
            _require(t.shape == (len(v),) and bool(torch.isfinite(t).all())
                     and float(t.min()) >= 0.0 and float(t.max()) <= 1.0,
                     f"demo {name}: a finite embedding within [0, 1]")
            if path is None:  # the weights in ME's layout and back
                me = os.path.join(tmp, "me.pth")
                torch.save({"state_dict": import_torch.export_state_dict(
                    model.state_dict())}, me)
                back = demo.demo_model("ResUNetBN2C", 32, 5, None)
                back.load_state_dict(import_torch.load_torch_checkpoint(
                    me)[0])
                _, f2 = extract_features(back.to(dev), xyz, voxel_size=0.3,
                                         device=dev)
                _require(torch.equal(f2, f), "demo: the weights brought "
                         "back from ME's layout give the same features")
            r = dict(n_points=stats["n_points"], n_voxels=stats["n_voxels"],
                     extract_ms=stats["extract_ms"],
                     tsne_ms=stats["tsne_ms"], launches=launches,
                     checked=errs,
                     kernels=_geometry_kernels(model, xyz, 0.3, dev,
                                               f"demo {name}"))
            print(f"demo {name}: N {r['n_points']} points, "
                  f"{r['n_voxels']} voxels; extract {r['extract_ms']:.1f} "
                  f"ms, t-SNE + PLY {r['tsne_ms']:.1f} ms on {gpu}; "
                  f"launches {launches}; every launch against its plain "
                  f"version: {errs}")
            out[name] = r
    finally:
        visualization.embed_tsne = real_tsne
    return out


def _eth_scene(root: str) -> dict:
    """One ETH-layout scene (gazebo_summer) of three N_POINTS-point
    fragments with ETH_KEYPOINTS keypoint indices each (the same rows):
    fragment 0 random in a 4 m cube about the origin, every point at
    least a tenth of a voxel from a voxel face (65,536 points, ~61,500
    voxels); fragment 1 fragment 0 moved by whole voxels
    of the coarsest level (16, 8, 8 voxels at stride 8: the same voxels,
    the same features); fragment 2 fragment 0 under a 10 deg / 0.5 m
    rigid transform. gt.log holds the pairs 0-1 and 0-2. Returns their
    gt (fragment id2 into id1's frame)."""
    import os

    from gcl_tpu_torch.utils.pointcloud import write_ply_xyz

    rng = np.random.RandomState(SEED + 15)
    cells = rng.randint(-40, 40, (N_POINTS, 3))
    frac = rng.uniform(0.1, 0.9, (N_POINTS, 3))
    x0 = (cells + frac) * ETH_VOXEL
    x1 = (cells + [16, 8, 8] + frac) * ETH_VOXEL
    t2 = _rigid(10.0, [0.5, 0.0, 0.0])
    x2 = x0 @ t2[:3, :3].T + t2[:3, 3]
    shift = np.eye(4)
    shift[:3, 3] = -np.array([16, 8, 8]) * ETH_VOXEL
    gts = {"0_1": shift, "0_2": np.linalg.inv(t2)}
    scene = os.path.join(root, "gazebo_summer")
    os.makedirs(os.path.join(scene, "Keypoints"))
    kp = rng.choice(N_POINTS, ETH_KEYPOINTS, replace=False)
    for i, x in enumerate((x0, x1, x2)):
        write_ply_xyz(os.path.join(scene, f"Hokuyo_{i}.ply"),
                      x.astype(np.float32))
        np.savetxt(os.path.join(scene, "Keypoints",
                                f"Hokuyo_{i}_Keypoints.txt"), kp, fmt="%d")
    with open(os.path.join(scene, "gt.log"), "w") as f:
        for pair, gt in gts.items():
            f.write("\t".join(pair.split("_")) + "\t3\n")
            for r in range(4):
                f.write("\t".join(repr(float(v)) for v in gt[r]) + "\n")
    return gts


def eth_checks(dev, gpu: str, tmp: str) -> dict:
    """Phase 14b: python -m gcl_tpu_torch.eval_eth's main on one synthetic
    scene with ResUNetFatBN(1, 32, conv1 k = 5) at full width, seeded
    weights, voxel ETH_VOXEL."""
    import os

    from gcl_tpu_torch import eval_eth, infer
    from gcl_tpu_torch.train.checkpoint import save_checkpoint
    from gcl_tpu_torch.utils.misc import extract_features
    from gcl_tpu_torch.utils.pointcloud import read_ply_xyz

    root = os.path.join(tmp, "eth")
    gts = _eth_scene(root)
    model = infer.serving_model(SEED, dev)
    ckpt = os.path.join(tmp, "eth.pth")
    save_checkpoint(ckpt, epoch=0, state_dict=model.state_dict(),
                    optimizer=None, config={}, best_val=0.0,
                    best_val_epoch=0, best_val_metric="x")
    x0 = read_ply_xyz(os.path.join(root, "gazebo_summer", "Hokuyo_0.ply"))
    res, launches = _counted(lambda: eval_eth.main(
        ["--eth_root", root, "--checkpoint", ckpt],
        scenes=["gazebo_summer"]))
    want = _launches(model, 2 * len(gts))
    _require(launches == want, f"ETH: launches {want}, got {launches}")
    errs = {}
    with checked_path(errs):
        extract_features(model, x0, voxel_size=ETH_VOXEL, device=dev)
    _require(set(errs) == {"K2", "K6"}, f"ETH: K2 and K6 checked, {errs}")
    pairs = {p["pair"]: p for p in res["scenes"]["gazebo_summer"]["pairs"]}
    _require(set(pairs) == set(gts), f"ETH pairs {sorted(gts)}")
    whole = pairs["0_1"]
    _require(whole["inlier_ratio"] == 1.0 and whole["registered"]
             and whole["rte"] < 0.3 and whole["rre"] < 15.0,
             f"ETH: the pair moved by whole voxels has inlier ratio 1 and "
             f"registers, got {whole}")
    stage_ms = {s: float(np.mean([p["stage_ms"][s] for p in pairs.values()]))
                for s in eval_eth.STAGES}
    out = dict(launches=launches, checked=errs, stage_ms=stage_ms,
               pairs={k: {f: p[f] for f in ("inlier_ratio", "rte", "rre",
                                            "registered", "n_mutual")}
                      for k, p in pairs.items()},
               kernels=_geometry_kernels(model, x0, ETH_VOXEL, dev,
                                         "ETH fragment"))
    print(f"ETH on {gpu}: launches {launches}; every launch against its "
          f"plain version: {errs}; pairs {json.dumps(out['pairs'])}; "
          f"stage ms a pair {json.dumps(stage_ms)} (the 10 deg / 0.5 m "
          f"pair reported, not gated: random weights)")
    return out


def sc2_benchmark_checks(gpu: str, tmp: str) -> dict:
    """Phase 14c: python -m gcl_tpu_torch.sc2_pcr.test_kitti's main at
    config_KITTI.json unchanged on SC2_PAIRS synthetic KITTI .npz pairs of
    N_KEY keypoints: the second cloud a rigid transform of the first,
    SC2_SHARED of the rows with their partner row's unit descriptor, the
    rest random unit vectors. RR must be 100."""
    import os

    from gcl_tpu_torch.data.synthetic import synth_lidar
    from gcl_tpu_torch.sc2_pcr import test_kitti

    rng = np.random.RandomState(SEED + 16)
    root = os.path.join(tmp, "sc2")
    os.makedirs(os.path.join(root, "fcgf_test"))
    for i in range(SC2_PAIRS):
        xyz0 = synth_lidar(rng, N_KEY)
        gt = _rigid(10.0 * (i + 1), [2.0 * i, 1.0, 0.2]).astype(np.float32)
        xyz1 = (xyz0 @ gt[:3, :3].T + gt[:3, 3]).astype(np.float32)
        f0 = rng.randn(N_KEY, 32)
        f1 = f0.copy()
        other = rng.rand(N_KEY) >= SC2_SHARED
        f1[other] = rng.randn(int(other.sum()), 32)
        f0, f1 = (f / np.linalg.norm(f, axis=1, keepdims=True)
                  for f in (f0, f1))
        np.savez(os.path.join(root, "fcgf_test", f"pair_{i}.npz"),
                 xyz0=xyz0, xyz1=xyz1, features0=f0.astype(np.float32),
                 features1=f1.astype(np.float32), gt_trans=gt)
    stats, launches = _counted(lambda: test_kitti.main(["--data_root",
                                                        root]))
    print(f"SC2-PCR benchmark, {SC2_PAIRS} pairs of {N_KEY} keypoints at "
          f"config_KITTI.json: {json.dumps(stats)} on {gpu}")
    _require(stats["RR"] == 100.0, f"SC2-PCR benchmark RR 100, got {stats}")
    return dict(stats, launches=launches)


# host native and the wrappers (phase 16)
NATIVE_POINTS = 120000
NATIVE_QUERIES = 20000
NUSC_LOGS, NUSC_FRAMES = 2, 150
WRAPPER_TIMEOUT_S = 600.0
# MISC_ARGS of the train wrapper: the colocation bands the 300 m synthetic
# logs fill (14 samples: 3 iterations of 4), one validation batch, every
# iteration's loss logged; both wrappers read in-process (a spawned loader
# worker takes ~9 s to start; (b) checks the pool in forked workers)
TRAIN_MISC = ("--min_dist 3 --max_dist 18 --val_max_iter 1 "
              "--train_num_thread 0 --val_num_thread 0 --stat_freq 1")
TEST_MISC = "--test_num_thread 0"


def _native_checks(gpu: str) -> dict:
    """Phase 16a: the host library built here, and each of its functions
    on a 120,000-point scan equal to its plain version; ms of both."""
    from gcl_tpu_torch import native

    _require(native.available(),
             f"the host library builds here: {native.build_error()}")
    rng = np.random.RandomState(SEED)
    pts = (rng.randn(NATIVE_POINTS, 3) * [20, 20, 2]).astype(np.float32)
    offsets = np.array([[dx, dy, dz] for dx in (-1, 0, 1)
                        for dy in (-1, 0, 1) for dz in (-1, 0, 1)], np.int32)
    vox = native.voxelize(pts, 0.3)
    cases = {
        "voxelize": (native.voxelize, native.voxelize_plain, (pts, 0.3)),
        "radius_knn": (native.radius_knn, native.radius_knn_plain,
                       (pts[:NATIVE_QUERIES], pts, 0.45, 5)),
        "kernel_map": (native.kernel_map, native.kernel_map_plain,
                       (vox[0], vox[0], offsets))}
    out, results = {}, {}
    for name, (fn, plain, args) in cases.items():
        t0 = time.perf_counter()
        got = fn(*args)
        t1 = time.perf_counter()
        want = plain(*args)
        t2 = time.perf_counter()
        got, want = ((g,) if isinstance(g, np.ndarray) else g
                     for g in (got, want))
        _require(all(a.dtype == b.dtype and np.array_equal(a, b)
                     for a, b in zip(got, want)),
                 f"native {name} equal to its plain version")
        out[name] = {"ms": (t1 - t0) * 1e3, "plain_ms": (t2 - t1) * 1e3}
        results[name] = got
    out["voxels"] = int(len(vox[0]))
    out["knn_hits"] = int(results["radius_knn"][1].sum())
    out["kernel_map_matches"] = int((results["kernel_map"][0] >= 0).sum())
    print(f"host library on {gpu}'s host: {NATIVE_POINTS} points -> "
          f"{out['voxels']} voxels; " + ", ".join(
              f"{k} {v['ms']:.2f} ms (plain {v['plain_ms']:.2f} ms)"
              for k, v in out.items() if isinstance(v, dict))
          + "; each equal to its plain version")
    return out


class _Seeded:
    """A dataset whose item i is drawn with np.random and its rotation
    generator seeded with i: the same sample in any process and order."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        self.ds.reset_seed(i)
        np.random.seed(i)
        return self.ds[i]


class _ServedFetches:
    """The pool's library with its fetches counted: one that returns a
    payload (n >= 0) was served by the pool."""

    def __init__(self, lib):
        self._lib, self.served = lib, 0

    def __getattr__(self, name):
        return getattr(self._lib, name)

    def gcl_reader_fetch(self, *args):
        n = self._lib.gcl_reader_fetch(*args)
        self.served += n >= 0
        return n


def _samples_equal(a, b) -> bool:
    return len(a) == len(b) and all(
        x.keys() == y.keys() and all(
            x[k] == y[k] if k == "meta" else
            (np.asarray(x[k]).dtype == np.asarray(y[k]).dtype
             and np.array_equal(x[k], y[k])) for k in x)
        for x, y in zip(a, b))


def _pool_checks(root: str) -> dict:
    """Phase 16b: ColocationNuscenesDataset("train") at the train
    wrapper's settings, iterated with the pool (0 workers), without it,
    and with the pool in 2 forked workers."""
    import torch.utils.data

    from gcl_tpu_torch.config import default_config
    from gcl_tpu_torch.data import colocation, kitti_io

    cfg = default_config(kitti_root=root, min_dist=3, max_dist=18,
                         num_neighborhood=6)
    ds = _Seeded(colocation.ColocationNuscenesDataset(
        "train", random_rotation=True, random_scale=True, config=cfg))

    def one_pass(workers: int):
        # forked workers (the port's own loader spawns them): each child
        # inherits this process's pool without its threads, and must build
        # its own (ScanPrefetcher._check_fork)
        loader = torch.utils.data.DataLoader(
            ds, batch_size=None, num_workers=workers,
            collate_fn=lambda s: s,
            multiprocessing_context="fork" if workers else None)
        return list(loader)

    reads = []
    real_read, real_hint = kitti_io.read_velodyne_bin, kitti_io.prefetch_scans

    def read(path):
        reads[-1].append(path)
        return real_read(path)

    def hint(paths):
        reads.append([])  # a sample hints before its first read
        real_hint(paths)

    pool = kitti_io._get_prefetcher()
    counted = _ServedFetches(pool._lib)
    pool._lib, kitti_io.read_velodyne_bin = counted, read
    kitti_io.prefetch_scans = hint
    t0 = time.perf_counter()
    try:
        with_pool = one_pass(0)
    finally:
        pool._lib, kitti_io.read_velodyne_bin = counted._lib, real_read
        kitti_io.prefetch_scans = real_hint
    t1 = time.perf_counter()
    kitti_io.prefetch_scans = lambda paths: None
    try:
        without = one_pass(0)
    finally:
        kitti_io.prefetch_scans = real_hint
    t2 = time.perf_counter()
    forked = one_pass(2)
    t3 = time.perf_counter()
    n_reads = sum(len(r) for r in reads)
    distinct = sum(len(set(r)) for r in reads)
    out = {"samples": len(with_pool), "scan_reads": n_reads,
           "distinct_scan_reads": distinct, "pool_served": counted.served,
           "pool_s": t1 - t0, "no_pool_s": t2 - t1,
           "forked_2_workers_s": t3 - t2}
    print(f"ColocationNuscenesDataset train: {json.dumps(out)}")
    _require(len(reads) == len(with_pool) >= 8,
             f"one hint a sample, {len(reads)} for {len(with_pool)}")
    _require(counted.served == distinct > 0,
             f"each sample's scans served by the pool: {out}")
    _require(_samples_equal(with_pool, without),
             "samples with the pool bit-equal to those without")
    _require(_samples_equal(with_pool, forked),
             "samples in 2 forked workers bit-equal to the in-process ones")
    return out


def _wrapper(argv, cwd: str, env: dict, log: str):
    """Run a wrapper as a subprocess; its output goes to ``log``. A failure
    prints the log's tail and fails the run."""
    import subprocess

    t0 = time.perf_counter()
    with open(log, "w") as f:
        rc = subprocess.run(argv, cwd=cwd, env=env, stdout=f,
                            stderr=subprocess.STDOUT,
                            timeout=WRAPPER_TIMEOUT_S).returncode
    wall = time.perf_counter() - t0
    with open(log) as f:
        lines = f.read().splitlines()
    if rc != 0:
        print("\n".join(lines[-40:]))
    _require(rc == 0, f"{' '.join(argv)} exits 0, got {rc}")
    return lines, wall


def host_native_checks(gpu: str, tmp: str) -> dict:
    """Phase 16: the host library, the nuScenes data path through the scan
    pool, and the nuScenes GCL train and test wrappers on the card."""
    import os
    import re

    from gcl_tpu_torch.data.synthetic import generate_synthetic_nuscenes

    repo = os.path.dirname(os.path.abspath(__file__))
    out = {"native": _native_checks(gpu)}
    root = os.path.join(tmp, "nuscenes")
    generate_synthetic_nuscenes(root, n_logs=NUSC_LOGS, n_frames=NUSC_FRAMES)
    out["pool"] = _pool_checks(root)

    # (c) the train wrapper at its defaults for one epoch
    run = os.path.join(tmp, "wrappers")
    os.makedirs(run)
    env = {**os.environ, "PYTHONPATH": repo, "NUSCENES_PATH": root,
           "MAX_EPOCH": "1"}
    scripts = os.path.join(repo, "gcl_tpu_torch", "scripts")
    lines, wall = _wrapper(["bash", os.path.join(scripts,
                                                 "train_gcl_nuscenes.sh"),
                            "", TRAIN_MISC], run, env,
                           os.path.join(tmp, "train_wrapper.log"))
    out_dir = lines[0]
    scheme = (r"\./outputs/Experiments/PairComplementNuscenesDataset-v0\.3/"
              r"FinestContrastiveLossTrainer/ResUNetFatBN/"
              r"SGD-lr1e-1-e1-b4i1-modelnout32/"
              r"\d{4}-\d\d-\d\d_\d\d-\d\d-\d\d")
    _require(re.fullmatch(scheme, out_dir) is not None,
             f"the root wrappers' OUT_DIR scheme, got {out_dir!r}")
    full = os.path.join(run, out_dir)
    stamp = out_dir.rsplit("/", 1)[1]
    for f in (f"log_{stamp}.txt", "checkpoint.pth", "config.json",
              "best_val_checkpoint.pth"):
        _require(os.path.exists(os.path.join(full, f)),
                 f"the train wrapper wrote {f}")
    with open(os.path.join(full, "scalars.jsonl")) as f:
        losses = [json.loads(line)["value"] for line in f
                  if '"train/loss"' in line]
    print(f"train_gcl_nuscenes.sh, 1 epoch: {wall:.1f} s wall, train/loss "
          f"{losses}, OUT_DIR {out_dir}")
    _require(2 <= len(losses) <= 6 and np.isfinite(losses).all(),
             f"2-6 finite train losses, got {losses}")
    out["train_wrapper"] = {"wall_s": wall, "iterations": len(losses),
                            "losses": losses, "out_dir": out_dir}

    # (d) the test wrapper on that run directory
    lines, wall = _wrapper(["bash", os.path.join(scripts,
                                                 "test_gcl_nuscenes.sh"),
                            out_dir, TEST_MISC], run, env,
                           os.path.join(tmp, "test_wrapper.log"))
    res = json.loads([line for line in lines
                      if line.startswith('{"rr"')][-1])
    print(f"test_gcl_nuscenes.sh: {wall:.1f} s wall, {json.dumps(res)}")
    _require(res["pairs"] >= 1 and np.isfinite([res["rte"], res["rre"]]).all()
             and res["device"] == "cuda",
             f"at least one pair, finite RTE / RRE on the card, got {res}")
    out["test_wrapper"] = {"wall_s": wall, **res}
    return out


class _PhaseClock:
    """Prints each phase's wall seconds, and the run's so far."""

    def __init__(self):
        self.start = self.last = time.perf_counter()

    def __call__(self, name: str) -> None:
        now = time.perf_counter()
        print(f"phase {name}: {now - self.last:.1f} s wall (run so far "
              f"{now - self.start:.1f} s)", flush=True)
        self.last = now


def main() -> None:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this smoke run needs a CUDA card")
    from gcl_tpu_torch import infer
    from gcl_tpu_torch.core.kernel_maps import build_graph
    from gcl_tpu_torch.data.device_pipeline import voxelize_per_cloud
    from gcl_tpu_torch.data.synthetic import synth_lidar
    from gcl_tpu_torch.core.coords import lookup
    from gcl_tpu_torch.kernels import (KERNELS, build, c1z_unpack_bits,
                                       launch_counts,
                                       occupancy_conv_fwd,
                                       occupancy_conv_fwd_plain,
                                       reset_launch_counts,
                                       sparse_conv_implicit_fwd,
                                       sparse_conv_implicit_fwd_plain)
    from gcl_tpu_torch.models.common import SparseConv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")

    gpu = infer.gpu_identity()
    print(f"card: {gpu}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    dev = torch.device("cuda")
    clock = _PhaseClock()
    clock("1 device")

    # 2. build
    t0 = time.perf_counter()
    build.load_library()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_info.get('seconds', 0.0):.2f} s)")
    for line in build.build_info.get("ptxas", "").splitlines():
        if "Compiling entry" in line:        # the kernel the lines below
            print(f"  ptxas: {line.split(chr(39))[1]}")  # are about
        elif "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")
    clock("2 build")

    # 3. K6 and K2 against their plain versions at the serving shapes
    rng = np.random.RandomState(SEED)
    pts = torch.from_numpy(np.stack([synth_lidar(rng, N_POINTS)
                                     for _ in range(2)])).to(dev)
    pmask = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    model = infer.serving_model(SEED, dev)
    extract = infer.serving_extractor(model, NV_CAP)
    specs = extract.conv_specs
    vox = voxelize_per_cloud(pts, pmask, extract.voxel_size, NV_CAP)
    flat = vox.flatten()
    graph = build_graph(flat.coords, flat.mask, specs, extract.level_caps, 2)
    torch.cuda.synchronize()
    print("levels: " + ", ".join(
        f"s{s} {lv.coords.shape[0]} rows / {lv.skeys.shape[0]} valid"
        for s, lv in sorted(graph.levels.items())))

    convs = {}
    for m in model.modules():
        if isinstance(m, SparseConv) and m.spec.kernel_size == 3:
            sig = (m.spec.key, m.spec.in_stride, m.in_ch, m.out_ch)
            convs[sig] = convs.get(sig, 0) + 1
    _require(sum(convs.values()) == 20, f"20 k=3 convs, got {convs}")
    g = torch.Generator(device="cpu").manual_seed(SEED)
    k6_err, k6_ms, k6_plain_ms = 0.0, 0.0, 0.0
    k6_bytes, k6_flops = 0, 0
    for (key, s_in, cin, cout), mult in sorted(convs.items()):
        lv = graph.levels[s_in]
        x = (torch.randn(lv.coords.shape[0], cin, generator=g)
             .to(dev) * lv.mask[:, None])
        w = torch.randn(27, cin, cout, generator=g).to(dev) / (27 * cin) ** .5
        args = (x, w, graph.maps[key].qkey, lv.skeys, lv.srow)
        out = sparse_conv_implicit_fwd(*args)
        torch.cuda.synchronize()
        ref = sparse_conv_implicit_fwd_plain(*args)
        torch.cuda.synchronize()
        err = float((out - ref).abs().max())
        torch.testing.assert_close(out, ref, rtol=1e-4, atol=1e-4)
        ms = _ms(lambda: sparse_conv_implicit_fwd(*args), 5)
        pms = _ms(lambda: sparse_conv_implicit_fwd_plain(*args), 5)
        print(f"K6 {key} {cin}->{cout} x{mult}: max_abs_err {err:.3g} "
              f"kernel {ms:.3f} ms plain {pms:.3f} ms")
        k6_err = max(k6_err, err)
        k6_ms += mult * ms
        k6_plain_ms += mult * pms
        matched = int((lookup(lv.skeys, lv.srow, args[2]) >= 0).sum())
        k6_bytes += mult * _nbytes(*args, out)
        k6_flops += mult * 2 * matched * cin * cout

    c1 = graph.maps["s1->s1/k5d1"]
    w1 = torch.randn(125, 1, 32, generator=g).to(dev)
    k2_args = (c1.c1z, graph.levels[1].skeys, w1)
    out, sbits = occupancy_conv_fwd(*k2_args)
    torch.cuda.synchronize()
    ref, ref_bits = occupancy_conv_fwd_plain(*k2_args)
    torch.cuda.synchronize()
    k2_err = float((out - ref).abs().max())
    torch.testing.assert_close(out, ref, rtol=0, atol=1e-5)
    _require(torch.equal(sbits, ref_bits),
             "K2 sbits equal the plain version's")
    _require(int(sbits.count_nonzero()) > 0, "K2 sets presence bits")
    k2_ms = _ms(lambda: occupancy_conv_fwd(*k2_args), 5)
    k2_plain_ms = _ms(lambda: occupancy_conv_fwd_plain(*k2_args), 5)
    print(f"K2 conv1 k5 1->32: max_abs_err {k2_err:.3g} kernel "
          f"{k2_ms:.3f} ms plain {k2_plain_ms:.3f} ms")
    k2_win = _k2_windows(dev, *k2_args, None, "at serving")
    k6_bound = _bound(k6_bytes, k6_flops, "split_tf32")
    k2_bound = _bound(_k2_bytes(*k2_args, out, sbits),
                      32 * int(c1z_unpack_bits(sbits, 125).sum()))
    print(f"bounds per serving pair: K6 {k6_bound[0]:.3f} ms by "
          f"{k6_bound[1]} (split TF32; CUDA-core FP32 "
          f"{_bound(k6_bytes, k6_flops)[0]:.3f} ms; {k6_bytes / 1e6:.1f} MB, "
          f"{k6_flops / 1e9:.2f} GFLOP), K2 {k2_bound[0]:.4f} ms by {k2_bound[1]}")
    clock("3 serving kernels")

    # 4. the serving slice
    matcher = infer.kitti_matcher(N_KEY)
    gen = torch.Generator().manual_seed(SEED)
    reset_launch_counts()
    t_est, _, feats = infer.register_pair(extract, matcher, pts, pmask,
                                          N_KEY, gen)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"launches per pair: {launches}")
    _require(launches == {**{k: 0 for k in KERNELS}, "K2": 1, "K6": 20},
             f"1 K2 and 20 K6 launches per pair, got {launches}")
    _require(bool(torch.isfinite(t_est).all())
             and bool(torch.isfinite(feats).all()),
             "finite transform and features")
    _require(feats.shape == (2, NV_CAP, 32),
             f"features [2, {NV_CAP}, 32], got {tuple(feats.shape)}")
    with plain_path():
        _, feats_plain = extract(pts, pmask)
        torch.cuda.synchronize()
    _require(occupancy_conv_fwd.launches == 1
             and sparse_conv_implicit_fwd.launches == 20,
             "the plain path launches no kernel")
    feat_err = float((feats - feats_plain).abs().max())
    print(f"features kernel vs plain path: max_abs_err {feat_err:.3g}")
    _require(feat_err < 1e-3, f"features within 1e-3, got {feat_err}")

    self_pts = torch.stack([pts[0], pts[0]])
    t_self, _, _ = infer.register_pair(extract, matcher, self_pts, pmask,
                                       N_KEY, gen)
    rte, rre = _rte_rre(t_self.cpu().numpy(), np.eye(4))
    print(f"self pair: RTE {rte:.4g} m RRE {rre:.4g} deg")
    _require(rte < 2.0 and rre < 5.0,
             f"self pair within RTE < 2 m, RRE < 5 deg, got {rte}, {rre}")
    shift = torch.tensor([3.0, 0.0, 0.0], device=dev)  # 10 voxels in x
    t_gt = np.eye(4)
    t_gt[0, 3] = 3.0
    t_sh, _, _ = infer.register_pair(
        extract, matcher, torch.stack([pts[0], pts[0] + shift]), pmask,
        N_KEY, gen)
    rte_s, rre_s = _rte_rre(t_sh.cpu().numpy(), t_gt)
    print(f"pair shifted 10 voxels in x: RTE {rte_s:.4g} m "
          f"RRE {rre_s:.4g} deg")

    def pair():
        infer.register_pair(extract, matcher, pts, pmask, N_KEY, gen)
        torch.cuda.synchronize()

    with plain_path():
        pair()  # warm-up of the plain path
    times = {"kernel": 0.0, "plain": 0.0}
    for _ in range(REPS):  # alternate the two paths pair by pair
        for name in ("kernel", "plain"):
            ctx = plain_path() if name == "plain" else contextlib.nullcontext()
            with ctx:
                t0 = time.perf_counter()
                pair()
                times[name] += time.perf_counter() - t0
    for name, tot in times.items():
        dt = tot / REPS
        print(f"{name} path: {1.0 / dt:.3f} pairs/s, {dt * 1e3:.2f} ms "
              f"per pair ({REPS} pairs after a warm-up) on {gpu}")
    clock("4 serving slice")

    # 4b. the FCGF evaluation pair: ResUNetFatBNEXP, feature-NN RANSAC,
    # eval_kitti end to end
    exp = fcgf_eval_checks(dev, gpu)
    torch.cuda.empty_cache()
    clock("4b FCGF evaluation pair")

    # 5. and 6. the train step's kernels, its group search, the step
    f32, bf16 = torch.float32, torch.bfloat16
    rec = train_kernel_checks(dev)
    rec.update(group_kernel_checks(dev))
    clock("5 train kernels")
    step_launches = train_step_checks(dev, gpu, BATCH, "implicit", dtype=f32)
    torch.cuda.empty_cache()
    clock("6 train step")
    # 7. and 8. the explicit route: its kernels at 8 x 7, the step there,
    # and the 4 x 7 step beside the implicit route's
    rec.update(explicit_kernel_checks(dev))
    torch.cuda.empty_cache()
    clock("7 explicit kernels")
    explicit_launches = train_step_checks(dev, gpu, BATCH_EXPLICIT,
                                          "explicit", dtype=f32)
    torch.cuda.empty_cache()
    train_step_checks(dev, gpu, BATCH, "explicit", compare=False, dtype=f32)
    torch.cuda.empty_cache()
    clock("8 explicit train steps")
    # 9.-11. the bf16 forms: the kernels at the 4 x 7 step's shapes, the
    # bf16 step there (the main path: root bench.py's compute type) on the
    # implicit route, the explicit route's kernels at 8 x 7, the bf16 step
    # there, and the bf16 4 x 7 step on the explicit route
    rec16 = train_kernel_checks(dev, bf16)
    torch.cuda.empty_cache()
    clock("9 bf16 kernels")
    step16 = train_step_checks(dev, gpu, BATCH, "implicit", dtype=bf16)
    torch.cuda.empty_cache()
    rec16.update(explicit_kernel_checks(dev, bf16))
    torch.cuda.empty_cache()
    explicit16 = train_step_checks(dev, gpu, BATCH_EXPLICIT, "explicit",
                                   dtype=bf16)
    torch.cuda.empty_cache()
    train_step_checks(dev, gpu, BATCH, "explicit", dtype=bf16)
    torch.cuda.empty_cache()
    clock("10 bf16 train steps")
    # 11. the FCGF train step: its kernels, the step in float32 and bf16,
    # the entry point
    fcgf_rec = fcgf_kernel_checks(dev, gpu)
    torch.cuda.empty_cache()
    clock("11a FCGF kernels")
    fcgf = fcgf_step_checks(dev, gpu)
    torch.cuda.empty_cache()
    clock("11b-c FCGF train steps")
    fcgf_entry_checks()
    torch.cuda.empty_cache()
    clock("11d the training entry point")
    # 12. data parallel on the one card: two gloo ranks, NCCL at world size
    # 1, a data-parallel trainer epoch
    dp = dp_checks(dev, gpu)
    torch.cuda.empty_cache()
    clock("12 data parallel")
    # 13. the zoo: V2's extra convs, the FCGF step with V2 and ResUNetIN2E
    v2_extra = zoo_kernel_checks(dev, gpu)
    torch.cuda.empty_cache()
    zoo = {}
    for name in ZOO:
        zoo[name] = zoo_step_checks(dev, gpu, name)
        torch.cuda.empty_cache()
    clock("13 the model zoo")
    # 14. the entry points: the demo, the ETH evaluation, the SC2-PCR benchmark
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        entry = {"demo": demo_checks(dev, gpu, tmp),
                 "eth": eth_checks(dev, gpu, tmp),
                 "sc2_benchmark": sc2_benchmark_checks(gpu, tmp)}
    torch.cuda.empty_cache()
    clock("14 the entry points")
    # 16. the host library, the nuScenes data path and the wrappers (the
    # in-process parts driven with the counts set to 0 just before)
    with tempfile.TemporaryDirectory() as tmp:
        host, host_launches = _counted(lambda: host_native_checks(gpu, tmp))
    _require(not any(host_launches.values()),
             f"no launch in phase 16's own process, got {host_launches}")
    clock("16 host native and the wrappers")

    conv, radius = "pallas_conv.py", "pallas_radius.py"
    table = [
        ("K6", "sparse_conv_implicit_fwd", "sparse_conv_fwd.cu", conv, 781),
        ("K7", "sparse_conv_implicit_bwd", "sparse_conv_bwd.cu", conv, 820),
        ("K2", "occupancy_conv_fwd", "occupancy_conv_fwd.cu", conv, 1024),
        ("K3", "occupancy_conv_dw", "occupancy_conv_dw.cu", conv, 1118),
        ("K4", "scalar_conv_fwd", "scalar_conv.cu", conv, 917),
        ("K5", "scalar_conv_dw", "scalar_conv.cu", conv, 973),
        ("K1", "windowed_cell_topk_packed", "radius_topk.cu", radius, 183),
        ("K11", "windowed_cell_topk_exact", "radius_topk.cu", radius, 136),
        ("K9", "scalar_conv_dx", "scalar_conv.cu", conv, 944),
        ("K8", "sparse_conv_dw", "sparse_conv_dw.cu", conv, 798),
        ("K10", "join_kmap", "join_kmap.cu", "pallas_join.py", 58),
        ("K12", "sparse_conv_table_fwd", "sparse_conv_fwd.cu", conv, 549)]
    # The main path is root bench.py's bf16 step: a conv kernel's row
    # carries its bf16 form's numbers and launches, and its float32 form's
    # under "float32". K1, K10 and K11 read coordinates and keys, not
    # features: one form, launched by both steps.
    # K9 and K11 are not on a train step's path: their launches are those
    # of the path that does reach them, driven above with the counts set
    # to 0 just before (ScalarConv's backward with dX; the large-T search).
    # K8, K10 and K12 are the explicit route's: their launches and times
    # are the 8 x 7 step's, the other rows' the 4 x 7 step's.
    explicit = f"train step {BATCH_EXPLICIT} x 7, explicit route"
    paths = {"K9": "ScalarConv backward with dX at conv1's shape",
             "K11": "batched_grid_radius_knn, T = 589,824",
             "K8": explicit, "K10": explicit, "K12": explicit}
    numbers = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by")
    kernels = []
    for k, name, src, jsrc, line in table:
        on_explicit = paths.get(k) == explicit
        r32 = rec[k]
        r = rec16.get(k, r32)
        f32_launches = r32.get("launches", (explicit_launches if on_explicit
                                            else step_launches)[k])
        row = {
            "name": f"{name} ({k})", "route": "cuda",
            "source": f"gcl_tpu_torch/csrc/{src}",
            "replaces": f"gcl_tpu/core/{jsrc}:{line}",
            "forms": (["float32", "bfloat16"] if k in rec16
                      else ["int32 keys"] if k == "K10" else ["float32"]),
            "launches": r.get("launches", (explicit16 if on_explicit
                                           else step16)[k]),
            **{key: r[key] for key in numbers},
            # one PyTorch call of the same function where there is a near
            # one: K3's cuBLAS product of the bits unpacked beforehand;
            # torch.searchsorted alone for K10 (over the fused int64 keys)
            # and for K1 (the run starts, the searches only); else null
            "library_ms": r.get("library_ms"),
            "path": paths.get(k, f"train step {BATCH} x 7, implicit route"),
            "train_step_launches": step16[k],
            "explicit_step_launches": explicit16[k]}
        if k in rec16:
            row["bf16_unequal_share"] = r.get("bf16_unequal_share", 0.0)
            row["float32"] = {
                "launches": f32_launches,
                **{key: r32[key] for key in numbers},
                "library_ms": r32.get("library_ms"),
                "train_step_launches": step_launches[k],
                "explicit_step_launches": explicit_launches[k]}
        if "library_call" in r:
            row["library_call"] = r["library_call"]
        kernels.append(row)
    kernels[6].update(
        brute_force_search_ms=rec["K1"]["brute_force_search_ms"],
        grid_search_ms=rec["K1"]["grid_search_ms"])
    kernels[0]["float32"].update(
        serving_launches=launches["K6"], serving_max_abs_err=k6_err,
        serving_ms=k6_ms, serving_plain_ms=k6_plain_ms,
        serving_bound_ms=k6_bound[0])
    kernels[0]["float32"].update(exp["K6"])
    kernels[2]["float32"].update(exp["K2"])
    kernels[2]["float32"].update(
        serving_launches=launches["K2"], serving_max_abs_err=k2_err,
        serving_ms=k2_ms, serving_plain_ms=k2_plain_ms,
        serving_bound_ms=k2_bound[0],
        **{f"serving_{k}": v for k, v in k2_win.items()})
    windowed = ("staged_keys_per_valid_row", "staged_keys_per_valid_query",
                "staged_keys_per_flagged_row_gated",
                "staged_keys_per_flagged_row_dense",
                "staged_keys_per_valid_row_gated",
                "staged_keys_per_valid_row_dense")
    for i in (2, 4, 5, 6, 8, 10):  # K2, K4, K5, K9 (each form), K1, K10
        for row, r in ((kernels[i], rec16.get(table[i][0], rec[table[i][0]])),
                       (kernels[i].get("float32"), rec[table[i][0]])):
            if row is not None:
                row.update({key: r[key] for key in windowed if key in r})
    kernels[7].update(second_shape=rec["K11"]["second_shape"],
                      cross_chunk_ties=rec["K11"]["cross_chunk_ties"])
    kernels[1].update(two_pass=rec16["K7"].pop("two_pass"))
    kernels[1]["float32"].update(two_pass=rec["K7"].pop("two_pass"))
    kernels[9].update(convs=rec16["K8"].pop("convs"))
    kernels[9]["float32"].update(convs=rec["K8"].pop("convs"))
    # the FCGF step's float32 numbers (phase 11): per step, both sides
    for i in (1, 3, 4, 5):  # K7, K3, K4, K5
        k = table[i][0]
        r = fcgf_rec[k]
        kernels[i].update(
            fcgf_launches=fcgf["launches"][k],
            fcgf_bf16_launches=fcgf["bf16_launches"][k],
            **{f"fcgf_{key}": r[key] for key in numbers},
            fcgf_library_ms=r.get("library_ms"),
            **({"fcgf_convs": r["convs"],
                "fcgf_dx_executed_over_matched":
                    r["dx_executed_over_matched"]} if k == "K7" else {}))
    # the launches of phases 12 and 13's paths, each driven with the counts
    # set to 0 just before and read just after: one rank of each 2-rank
    # data-parallel step, the FCGF step of V2 and of ResUNetIN2E
    for i, (k, *_) in enumerate(table):
        kernels[i].update(
            dp_gcl_rank_launches=dp["gcl"]["launches"][k],
            dp_fcgf_rank_launches=dp["fcgf"]["launches"][k],
            v2_fcgf_launches=zoo["ResUNetFatBNEXP_V2"]["launches"][k],
            in2e_fcgf_launches=zoo["ResUNetIN2E"]["launches"][k])
    # phase 14's paths, each driven with the counts set to 0 just before
    # and read just after: the demo's extract of each input, the ETH
    # evaluation's four (two pairs); K6 and K2 at those geometries
    demo_runs = entry["demo"]
    for i, (k, *_) in enumerate(table):
        kernels[i].update(
            demo_synthetic_launches=demo_runs["synthetic"]["launches"][k],
            demo_scan_launches=demo_runs["scan_65536"]["launches"][k],
            eth_launches=entry["eth"]["launches"][k])
    for i, (k, *_) in enumerate(table):  # phase 16's in-process parts
        kernels[i]["host_native_launches"] = host_launches[k]
    for i, k in ((0, "K6"), (2, "K2")):
        kernels[i]["float32"].update(
            demo_synthetic=demo_runs["synthetic"]["kernels"][k],
            demo_scan_65536=demo_runs["scan_65536"]["kernels"][k],
            eth_fragment=entry["eth"]["kernels"][k])
    for i in (0, 1):  # K6, K7 at V2's conv1_extra and conv1_tr_extra
        kernels[i]["float32"]["v2_extra"] = {
            conv: {"key": r["key"], "cin": r["cin"], "cout": r["cout"],
                   **r[table[i][0]]} for conv, r in v2_extra.items()}
    print(json.dumps({"fcgf_step": {
        k: v for k, v in fcgf.items() if "launches" not in k}}))
    print(json.dumps({"data_parallel": {
        "gcl_bf16_2_ranks_one_card": {k: v for k, v in dp["gcl"].items()
                                      if k != "launches"},
        "fcgf_2_ranks_one_card": {k: v for k, v in dp["fcgf"].items()
                                  if k != "launches"},
        "bench_step_time_s": dp["bench"]}, "zoo": {
        name: {k: v for k, v in r.items() if k not in ("launches", "checked")}
        for name, r in zoo.items()}}))
    print(json.dumps({"entry_points": {
        "demo": {name: {k: v for k, v in r.items()
                        if k not in ("kernels", "launches", "checked")}
                 for name, r in demo_runs.items()},
        "eth": {k: v for k, v in entry["eth"].items()
                if k not in ("kernels", "launches")},
        "sc2_benchmark": {k: v for k, v in entry["sc2_benchmark"].items()
                       if k != "launches"}}}))
    print(json.dumps({"host_native": host}))
    print(json.dumps({"kernels": kernels}))
    print(f"{gpu}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
