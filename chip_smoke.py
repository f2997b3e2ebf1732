#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (built for H100).

Run from the repository root, with no arguments:

    python3 chip_smoke.py

It builds the CUDA kernels of ``src/repro_torch/kernels/csrc`` (nvcc,
sm_90a), holds each kernel against its plain PyTorch version on the card,
drives the port's paths — ``FastVAT().fit(X)`` then ``order()``,
``image()``, ``image(use_ivat=True)`` and ``assess()`` at n = 2,048 (the
``vat`` rung), at n = 50,000 (the ``flashvat`` rung, and its stepwise
engine) and at n = 1,000,000 (the ``approx`` rung, anchored kNN), the
``ivat`` rung at n = 2,048 and 16,384, ``method="approx"`` at
n = 32,768 (exact kNN), and the batched fits ``FastVAT().fit_many(Xs)`` of
8 datasets at n = 2,048 (``vat``; also ``ivat`` and precomputed) and of 4
at n = 50,000 (``flashvat``, both engines), and ``ops.knn_graph_batch`` of
4 at n = 32,768 — checks what comes out and that every kernel of
each path was launched, holds the flashvat engines bit for bit against
each other and against the materialized ordering, the kNN kernel bit for
bit against the pairwise kernel's sorted rows, the one-launch Prim kernel
bit for bit against the loop of plain masked argmins, the iVAT op against
the plain recurrence on both of its routes (``ivat-route`` lines: every
fit path's iVAT lanes took the range route; ``kernel-check`` lines name
each input's route), the segmented kNN
launch (every anchored cell at once) bit for bit against the kNN kernel
cell by cell, Borůvka on the card against
Borůvka on the CPU, the approx order at k = n - 1 against the exact
orders, and every batched lane bit for bit against its solo kernel and
solo fit, the recording step of the stepwise engines bit for bit against
the single step, and their loops at one device operation a step (two on
the sharded engine: its step and NCCL's copy) in a traced traversal;
drives ``FastVAT(method="bigvat")`` at n = 1,000,000 (its assignment
blocks bit for bit against one (n, 256) call, and the same fit from an
``np.memmap``), ``StreamingVAT(cap=256, d=8)`` over 2,000 points, the
paper's tables over the seven datasets of ``data/synth.py`` (k-means,
DBSCAN, PCA and t-SNE, each against its CPU run), k-means and DBSCAN at
16,384 points and t-SNE at 8,192, and an armed ``kernels.dispatch``
fault site; drives the serving layer, ``TendencyServer(ServeConfig(
device="cuda"))``: 64 mixed requests from 8 client threads (``vat`` and
``ivat`` padded to the 2,048 bucket, ``flashvat`` at 50,000), each result
bit for bit its solo fit, with fewer batches than requests, every
resilience counter 0 and the served kernels launched (``serve-mixed``);
``vat`` and ``ivat`` at bucket boundaries and with repeated rows
(``serve-pad``); cold first requests against warm latencies and the host
pre-pass (``serve-warm``); the SLO router's rungs with predicted against
measured walls (``serve-slo``); and the six chaos scenarios with their
counter pins, flashvat's ladder at 50,000 (``serve-chaos``); drives the
``embed`` rung: ``FastVAT().fit(X, encoder=fn)`` on two blobs of 1,000 × 32
through a tanh projection on the card (``embed-encoder``),
``FastVAT().fit_embeddings`` of full-width gemma-2b (18 layers, f32, from
``init_params`` seed 0) at B = 4, S = 512 (2,048 rows: ``vat``) and
S = 1,024 (4,096 rows: ``flashvat``) (``embed-gemma``) and of full-width
internvl2-1b at B = 4, S = 512 (1,024 text rows: ``vat``) (``embed-vlm``),
each bit for bit the plain fit of the same activations with the inner
rung's kernels launched, and the kernels on each fit's own activations
against their plain versions (row 1 on the ``vat`` matrix, every seed-scan
block and the render; ``prim_persist`` by tree weight and edges, with its
plain time), the probes over gemma's run (``probes``: the final layer's
taps and the embedding table, rstar == the VAT image of the maximin
sample, row 1 on the sample against its plain version) and the card's 2-layer forwards against the CPU's within 1e-4 of
scale (``model-parity``); drives the other families at their published
widths (f32, ``init_params`` seed 0, ``make_batch``; ``model-size`` prints
each one's weights and the depth cut one card's 80 GB forces): rwkv6-3b
(32 layers; ``vat`` at B 4, S 512 and ``flashvat`` at S 1,024), zamba2-2.7b
(54 layers), whisper-large-v3 (32 + 32 layers, 1,500 frames),
phi3.5-moe-42b-a6.6b (8 of 32 layers) and deepseek-v3-671b (1 of 61
layers and its MTP block, labels in the batch), each through
``fit_embeddings`` (``embed-*``: bit for bit the plain fit, its kernels
against their plain versions), ``router_tendency`` on the moe configs'
last router logits (``router-probe``; ``moe-routing``: the dispatch's
expert positions and the aux loss's token fractions equal the one-hot
formulas bit for bit, on the card and the CPU), and ``prefill`` of 128
tokens then
32 ``decode_step``s against the forward of the same 160 (``decode-*``:
within 2e-3 of scale, 5e-3 hybrid, under an f32 cache; prefill and a
step timed under the bfloat16 cache), with ``model-parity`` for four of
them (phi3.5-moe at 1 layer with the same expert ids, rwkv6 at 2, zamba2
at one super-block, whisper at 1 + 1); trains gemma-2b at its published
config (18 layers, ``remat="full"``, f32, AdamW through
``build_train_step(donate=True)``, B 2, S 1,024) for 4 steps with
``TendencyMonitor.observe`` after steps 2 and 4 (``train-gemma``: loss and
gradient norm finite, params moved, probes in [0, 1], rows 1 and 3'
launched by the diag steps and held against their plain versions on the
probes' own draws; step, optimizer and diag-step times, TFLOP/s, peak),
holds the card's gradients and optimizer updates against the CPU's on
phi3-mini-3.8b at 1 layer (``train-parity``: 1e-4 and 1e-6 of scale) and
``train()`` interrupted and resumed against an uninterrupted run
(``train-resume``: params, optimizer state and tendency history bit for
bit; each checkpoint's bytes and seconds); runs the training CLI on the
card (``launch-train``: ``python -m repro_torch.launch.train --arch
gemma-2b --smoke --steps 4``, then ``--steps 6`` on the same checkpoint
directory: one device, a finite loss, resumed from step 4, run on cuda);
reads the dry run (``dryrun``: ``python -m repro_torch.launch.dryrun
--arch gemma-2b --shape train_4k`` at gemma-2b's published config,
bfloat16, ``remat="full"``, ``seq_shard``, on the 16 x 16 mesh of a fake
world of 512 ranks, rwkv6-3b ``prefill_32k`` on the same mesh (its WKV
recurrence traced once), deepseek-v3-671b ``train_4k --optimized`` on
the same mesh (``dryrun-dsv3``: experts over model x data; ok, no op
unsharded, a peak a rank under half of the 774.23 GB the cell counted
while the moe's buffers were whole on every rank), ``launch.perf --exp B2_ctx_vpad`` and
``tools/dryrun_sweep.py``; all five started as host subprocesses that
see no card when the script starts, so they trace beside the card
phases: ok, FLOPs a rank, all-gathers (gemma: more than the 366 counted
while each layer's gathered weights were its checkpoint's inputs), a peak
a rank under 80 GB (gemma: under that layout's 17.49 GB),
the roofline table at the H100's constants, ``analytic_flops`` against
``train_flops`` for gemma-2b at B 2, S 1,024, and one ``dryrun-sweep``
line for each of the 30 smoke cells, every one ok and none unsharding an
op beyond ``SWEEP_REPLICATED_OK``); runs the certification sweep (``numerics/certify.py``, 180
fits);
times each kernel beside its plain version, one PyTorch library call
where there is one and the card's bound, and prints:

  * one line per phase, the GPU's name and power limit (nvidia-smi), and a
    JSON line ``{"kernels": [...]}`` before the last;
  * as the last line, ``{"ok": true, "device": {...}}``.

It exits non-zero, printing no result line, when there is no CUDA device,
when ``src/repro_torch`` is missing, or when any phase fails.  It imports
nothing of JAX or of the JAX package ``repro``.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

#: Peak rates of one H100 SXM at its 700 W limit (NVIDIA's data sheet):
#: HBM3 bandwidth and f32 outside the tensor cores.  The bound of a kernel
#: is the larger of its bytes over the first and its operations over the
#: second.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12

#: Relative spanning-tree-weight excess allowed between orderings built
#: from the kernel's and the plain version's matrices (the reference's
#: EXCESS_F32, repro/numerics/certify.py).
EXCESS_F32 = 1e-5

F32_EPS = float(np.finfo(np.float32).eps)


class SmokeFailure(RuntimeError):
    pass


def require(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(phase: str, **fields) -> None:
    print(f"[{phase}] " + json.dumps(fields, default=str), flush=True)


def blobs(n: int, d: int, k: int, seed: int) -> np.ndarray:
    """k Gaussian clusters of n // k points in d dimensions, from a seed."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=8.0, size=(k, d))
    labels = np.repeat(np.arange(k), -(-n // k))[:n]
    return (centers[labels] + rng.normal(size=(n, d))).astype(np.float32)


# ------------------------------------------------------------ timing ----

def kernel_device_ms(prof) -> dict:
    """Device time (ms) by kernel name from a torch.profiler run: only the
    device-side events, so the CPU ops that launched them are not counted
    a second time."""
    from torch.autograd import DeviceType
    by_name = {}
    for e in prof.key_averages():
        if e.device_type == DeviceType.CUDA and e.self_device_time_total:
            by_name[e.key] = by_name.get(e.key, 0.0) \
                + e.self_device_time_total / 1e3
    return by_name


def device_launches(prof) -> int:
    """Operations the card ran in a torch.profiler run: kernels and copies
    (a 0-d device-to-device write is a memcpy, a strided one a kernel)."""
    from torch.autograd import DeviceType
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA
               and e.self_device_time_total)


def ops_per_step(prof, name_part: str):
    """Device operations a step of a traced step loop: every kernel and
    copy the card ran from the first launch of the step kernel (its name
    holds ``name_part``) to its last, NCCL's annotations excluded, over the
    number of those launches; and that number."""
    from torch.autograd import DeviceType
    evs = sorted((e for e in prof.events()
                  if e.device_type == DeviceType.CUDA
                  and not e.name.startswith("nccl:")),
                 key=lambda e: e.time_range.start)
    idx = [i for i, e in enumerate(evs) if name_part in e.name]
    require(idx, f"no {name_part} kernel in the trace")
    return (idx[-1] - idx[0] + 1) / len(idx), len(idx)


def read_floor_ms(torch, build, x) -> float:
    """Device time of a kernel that only reads the floats of ``x`` once
    (``repro_read_floor``), warm: the floor for a step that reads them."""
    lib = build.library()
    blocks = 8 * torch.cuda.get_device_properties(0).multi_processor_count
    out = torch.zeros(blocks, dtype=torch.int32, device="cuda")

    def run():
        build.check(lib.repro_read_floor(
            x.data_ptr(), x.numel(), blocks, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "read_floor")
    return device_ms(torch, run, reps=200, label="read_floor")


def device_ms(torch, fn, *, reps: int, label: str = "") -> float:
    """Device time of one ``fn()`` in ms: every kernel and copy it puts on
    the card, summed by torch.profiler over ``reps`` calls after one
    warm-up.  Host time between launches is not counted.

    A profiler session now and then records no device events at all; it
    is then tried twice more, and if none records any, the stream time of
    ``event_ms`` (host launch gaps included, so an upper bound) is
    returned instead and a ``timer-fallback`` line says so."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(kernel_device_ms(prof).values())
        if total > 0:
            return total / reps
    ms = event_ms(torch, fn, reps=reps, warmup=1)
    log("timer-fallback", call=label, event_ms=ms,
        why="torch.profiler recorded no device time in 3 sessions")
    return ms


def event_ms(torch, fn, *, reps: int, warmup: int = 2) -> float:
    """Stream time of one ``fn()`` in ms: CUDA events around ``reps``
    back-to-back calls.  Where the host launches more slowly than the
    card runs the kernels, this is the host's rate, not the card's."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def wall_s(torch, fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def bound_ms(nbytes: float, nops: float):
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = nops / PEAK_F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def pairwise_cost(n: int, m: int | None, d: int):
    """Bytes (X, Y read once, R written once) and f32 operations (the
    multiply-add per feature and pair, the row norms, a 4-op epilogue).

    ``m=None`` is the self-matrix (Y is X): R[i, j] == R[j, i], so only the
    n (n + 1) / 2 pairs on and above the diagonal need their dot product
    and epilogue, while all n * n entries are still written."""
    if m is None:
        nbytes = 4 * (n * d + n * n)
        pairs = n * (n + 1) // 2
        nops = 2 * pairs * d + 2 * n * d + 4 * pairs
    else:
        nbytes = 4 * (n * d + m * d + n * m)
        nops = 2 * n * m * d + 2 * (n + m) * d + 4 * n * m
    return nbytes, nops


def argmin_cost(n: int):
    return 4 * n + n + 16, 2 * n      # vals + mask read, pair written


def prim_order_cost(n: int):
    """The n - 1 pivot rows of R read once (the last vertex's row is never
    needed), the order written once; a min and a key compare per lane and
    step."""
    return 4 * n * (n - 1) + 8 * n + 8, 2 * n * (n - 1)


def persist_cost(n: int, d: int, pairs: int):
    """X, aux read once, order (int64), edges and stats written once; one
    FMA per feature and pair evaluation the kernel made (``stats[2]``:
    each unselected lane against each pivot folded into its tile, which
    for an exact traversal is n (n - 1) / 2 whatever the schedule)."""
    return 4 * n * d + 4 * n + 12 * n + 32, 2 * d * pairs


def stream_step_cost(n: int, d: int):
    """One step: X, aux and the mask read, the frontier read and written,
    the pair written; one FMA per feature and lane, a 4-op epilogue."""
    return 4 * n * d + 4 * n + n + 8 * n + 16, 2 * n * d + 4 * n


def ivat_cost(n: int):
    """The strict lower triangle of R* read once, D' written once; one
    compare and one max per lower-triangle entry."""
    lower = n * (n - 1) // 2
    return 4 * lower + 4 * n * n, 2 * lower


# ------------------------------------------------------------ phases ----

def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr}")
    return smi.stdout.strip().splitlines()[0]


def phase_environment(torch, build):
    card = card_line()
    nvcc = build.find_nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0
    log("environment", torch=torch.__version__, cuda=torch.version.cuda,
        nvcc=ver[-1] if ver else None, build_s=build_s,
        library=str(build.build()), device=torch.cuda.get_device_name(0),
        pairwise_dist_ptxas=ptxas_report(build, "pairwise_dist.cu"),
        prim_persist_ptxas=ptxas_report(build, "prim_persist.cu"),
        knn_graph_ptxas=ptxas_report(build, "knn_graph.cu"),
        prim_update_ptxas=ptxas_report(build, "prim_update.cu"),
        ivat_update_ptxas=ptxas_report(build, "ivat_update.cu"))
    return card


def ptxas_report(build, source: str) -> list:
    """Registers and spill bytes of each kernel of one source, from the
    ptxas report the build writes beside the library (absent when the
    library was built before this run and no log is found)."""
    path = build.BUILD_DIR / "build.log"
    if not path.exists():
        return []
    text = path.read_text()
    start = text.find(f"== {source}")
    if start < 0:
        return []
    end = text.find("\n== ", start + 1)
    section = text[start:end if end >= 0 else None]
    stats = re.findall(r"(\d+) bytes spill stores.*?Used (\d+) registers",
                       section, flags=re.S)
    return [{"registers": int(r), "spill_store_bytes": int(sp)}
            for sp, r in stats]


def check_pairwise(torch, ref, ops, pairwise_dist_cuda, probe_count, gen):
    """Kernel against plain version at the main path's shapes: the
    self-matrix of the fit, a ragged one, and assess()'s Hopkins calls,
    (m probes) x (n points) with m = probe_count(n)."""
    worst = 0.0
    cases = ((2048, None, 64), (2047, None, 3), (2048, 256, 64),
             (probe_count(2048), 2048, 64),
             # the flash path's: a seed-scan block at n = 50,000 (25 x 7
             # blocks of about 2,000 x 7,143), the band render's
             # representatives, and assess()'s Hopkins calls
             (2000, 7143, 64), (256, None, 64),
             (probe_count(50_000), 50_000, 64),
             # the ivat rung's matrix at the top of its window
             (16384, None, 32),
             # bigvat's assignment block (and its ragged last one at a
             # million points), and the kmeans tile of cluster-scale
             (4096, 256, 8), (576, 256, 8), (16384, 8, 32))
    for n, m, d in cases:
        case_worst = {}
        X = torch.randn(n, d, device="cuda", generator=gen)
        Y = None if m is None else torch.randn(m, d, device="cuda",
                                               generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            Xc = X.to(dtype)
            Yc = None if Y is None else Y.to(dtype)
            sq_max = float(torch.amax(torch.sum(Xc.float() ** 2, dim=1)))
            if Yc is not None:
                sq_max = max(sq_max, float(torch.amax(
                    torch.sum(Yc.float() ** 2, dim=1))))
            for metric in ref.METRICS:
                for form in ("gram", "direct"):
                    K = pairwise_dist_cuda(Xc, Yc, metric=metric, form=form)
                    P = ref.pairwise_dissim_ref(Xc, Yc, metric=metric,
                                                form=form)
                    torch.cuda.synchronize()
                    err = float(torch.amax(torch.abs(K - P)))
                    if metric == "euclidean" and form == "gram":
                        tol = (16 * F32_EPS * sq_max) ** 0.5
                    else:
                        tol = 1e-5 * float(torch.amax(torch.abs(P))) + 1e-6
                    worst = max(worst, err)
                    key = f"{metric}/{form}"
                    case_worst[key] = max(case_worst.get(key, 0.0), err)
                    require(err <= tol, f"pairwise {metric}/{form} n={n} "
                            f"m={m} d={d} {dtype}: err {err} > tol {tol}")
                    if Yc is None:
                        require(torch.equal(K, K.T), f"pairwise {metric}/"
                                f"{form} n={n} d={d}: not exactly symmetric")
                        R = ops.pairwise_dist(Xc, metric=metric, form=form)
                        require(bool((torch.diagonal(R) == 0).all()),
                                "pairwise diagonal is not exactly zero")
        log("kernel-check", kernel="pairwise_dist", n=n, m=m, d=d,
            dtypes=["float32", "bfloat16"], max_abs_err=case_worst)
    # a self-matrix through ops.pairwise_dist: the pre-pass (norms, the
    # feature-major copy) and the tiles, which write the zero diagonal
    X = torch.randn(2048, 64, device="cuda", generator=gen)
    per_call = {form: launches_per_call(
        torch, lambda: ops.pairwise_dist(X, form=form), f"self {form}")
        for form in ("gram", "direct")}
    require(all(v is None or v <= 2 for v in per_call.values()),
            f"ops.pairwise_dist of a self-matrix made {per_call} device "
            "operations a call, want at most 2")
    log("kernel-check", kernel="pairwise_dist", n=2048, d=64,
        device_ops_per_self_call=per_call)
    return worst


def launches_per_call(torch, fn, label: str, calls: int = 5):
    """Device operations (kernels, copies) of one ``fn()`` by torch.profiler
    over ``calls`` calls; a session that records none is tried twice more,
    and None (with a ``timer-fallback`` line) if none records any."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        ops_ = device_launches(prof)
        if ops_:
            return ops_ / calls
    log("timer-fallback", call=label, device_ops=None,
        why="torch.profiler recorded no device operation in 3 sessions")
    return None


def check_argmin(torch, ref, masked_argmin_cuda, gen):
    for n in (2048, 16384):
        vals = torch.randint(-20, 50, (n,), device="cuda",
                             generator=gen).float()     # many ties
        masks = {
            "random": torch.rand(n, device="cuda", generator=gen) < 0.5,
            "all_but_one": torch.ones(n, dtype=torch.bool, device="cuda"),
            "all": torch.ones(n, dtype=torch.bool, device="cuda"),
            "none": torch.zeros(n, dtype=torch.bool, device="cuda"),
        }
        masks["all_but_one"][n - 7] = False
        for name, mask in masks.items():
            kv, ki = masked_argmin_cuda(vals, mask)
            pv, pi = ref.masked_argmin_ref(vals, mask)
            torch.cuda.synchronize()
            require(int(ki) == int(pi) and torch.equal(
                kv.view(1).view(torch.int32), pv.view(1).view(torch.int32)),
                f"masked_argmin n={n} mask={name}: kernel ({float(kv)}, "
                f"{int(ki)}) != plain ({float(pv)}, {int(pi)})")
        log("kernel-check", kernel="masked_argmin", n=n, bitwise=True,
            masks=list(masks))
    return 0.0


def check_vat_prim(torch, ref, ops, vat_prim_order_cuda, vat_order, gen):
    """The one-launch Prim kernel against the loop it replaces,
    ``vat_order(R, argmin=ref.masked_argmin_ref)`` on the same card
    matrix, bit for bit, at every cluster size the kernel takes (1, 2, 4,
    8, 16 CTAs a matrix), each with the pivot rows read by every thread's
    loads and, where n % 4 == 0, by one bulk copy, and at the host's
    choice: float matrices,
    tie-heavy integer ones (squared distances of integer points, duplicates
    among them), the same with the zeros of every other row made -0.0, n
    from 1 to 16,384 (2,047 and 16,383: n no C > 1 divides; 1 to 3: C > n,
    CTAs with no lane), n = 40,961 (past one CTA's shared memory: one CTA
    refused, every larger C), and 8 lanes of clusters in one launch
    against their solo launches.  The loop runs once a matrix."""
    from repro_torch.kernels.pairwise_dist import pairwise_dist_cuda
    from repro_torch.kernels.prim_update import (CLUSTER_SIZES, SLICE_MAX,
                                                 prim_bulk, prim_plan)

    def int_matrix(n):
        P = torch.randint(-3, 4, (n, 3), device="cuda", generator=gen)
        R = pairwise_dist_cuda(P.float(), metric="sqeuclidean")
        return R.fill_diagonal_(0.0)

    def every_cluster(R, i0, want, label, sizes=CLUSTER_SIZES):
        n = R.shape[-1]
        for c in (*sizes, None):
            for bulk in ((False, True) if c and prim_bulk(n, c) else
                         (False,) if c else (None,)):
                got = vat_prim_order_cuda(R, i0, cluster=c, bulk=bulk)
                require(torch.equal(got, want), f"vat_prim_order {label} "
                        f"cluster={c} bulk={bulk}: not the loop's order")

    cases, chosen = [], {}
    for n in (1, 2, 3, 129, 2047, 2048, 16_383, 16_384):
        Ri = int_matrix(n)
        Rz = Ri.clone()
        Rz[(Rz == 0) & (torch.arange(n, device="cuda") % 2 == 0)[:, None]] \
            = -0.0
        mats = {"float": ops.pairwise_dist(
            torch.randn(n, 16, device="cuda", generator=gen)),
            "int": Ri, "signed_zero": Rz}
        for name, R in mats.items():
            i0 = torch.argmax(torch.amax(R, dim=1)).view(1)
            want = vat_order(R, argmin=ref.masked_argmin_ref)
            every_cluster(R, i0, want, f"{name} n={n}")
            cases.append(f"{name}/{n}")
        chosen[n] = prim_plan(n)
        del mats, Ri, Rz
    n = SLICE_MAX + 1
    R = int_matrix(n)
    i0 = torch.argmax(torch.amax(R, dim=1)).view(1)
    try:
        vat_prim_order_cuda(R, i0, cluster=1)
        refused = False
    except ValueError:
        refused = True
    require(refused, f"vat_prim_order n={n} cluster=1: one CTA cannot hold "
            f"the frontier, and the call was not refused")
    want = vat_order(R, argmin=ref.masked_argmin_ref)
    every_cluster(R, i0, want, f"int n={n}", sizes=CLUSTER_SIZES[1:])
    cases.append(f"int/{n}")
    chosen[n] = prim_plan(n)
    del R, want
    stack = torch.stack([int_matrix(2048) if z % 2 else ops.pairwise_dist(
        torch.randn(2048, 16, device="cuda", generator=gen))
        for z in range(8)])
    i0 = torch.argmax(torch.amax(stack, dim=2), dim=1)
    want = ref.vat_prim_order_ref(stack, i0)
    for c in (2, 8, 16, None):
        lanes = vat_prim_order_cuda(stack, i0, cluster=c)
        for z in range(8):
            require(torch.equal(lanes[z], vat_prim_order_cuda(
                stack[z].contiguous(), i0[z:z + 1], cluster=c)),
                f"vat_prim_order lane {z} of 8 (cluster={c}) != its solo "
                f"launch")
        require(torch.equal(lanes, want),
                f"vat_prim_order lanes (cluster={c}) != the batched loop")
    log("vat-prim-kernel", kernel="vat_prim_order", bitwise=cases,
        clusters=list(CLUSTER_SIZES), bulk_copy_where_allowed=True,
        lanes_equal_solo=8, slice_max=SLICE_MAX,
        chosen={str(k): {"cluster": c, "threads": t, "bulk": u}
                for k, (c, t, u) in chosen.items()})
    return 0.0


def reset_counts(build):
    """Zero the launch counts and the iVAT op's lanes by route."""
    from repro_torch.kernels.ivat_update import reset_route_lanes
    build.reset_launch_counts()
    reset_route_lanes()


def require_range_route(label: str, lanes: int) -> dict:
    """Every iVAT lane since ``reset_counts`` took the range route: ``lanes``
    of them, none serial.  Prints an ``ivat-route`` line."""
    from repro_torch.kernels.ivat_update import route_lanes
    routes = route_lanes()
    require(lanes > 0 and routes == {"range": lanes, "serial": 0},
            f"{label}: iVAT lanes by route {routes}, want {lanes} on the "
            "range route and none serial")
    log("ivat-route", path=label, **routes)
    return routes


def swapped_non_prim(torch, ref, rstar):
    """rstar with rows (and columns) p and p + 1 swapped, for the first p
    that breaks the range route's condition (by the plain stages): a
    matrix the recurrence answers that is not in Prim order."""
    n = rstar.shape[0]
    for p in range(1, n - 1):
        perm = torch.arange(n, device=rstar.device)
        perm[[p, p + 1]] = perm[[p + 1, p]]
        R2 = rstar[perm][:, perm].contiguous()
        if not bool(ref.ivat_route_ref(*ref.ivat_parents_ref(R2))):
            return R2
    raise SmokeFailure("no swap of neighbouring rows breaks the condition")


def signed_matrix(n: int, seed: int) -> np.ndarray:
    """A symmetric precomputed matrix with negative entries, +0.0 and -0.0
    off the diagonal and a zero diagonal, from a seed."""
    rng = np.random.default_rng(seed)
    A = rng.integers(-3, 4, (n, n)).astype(np.float32)
    A = A + A.T
    A[A == 0] = np.where(rng.random(int((A == 0).sum())) < 0.5, 0.0, -0.0)
    np.fill_diagonal(A, 0.0)
    return A


def check_ivat_stages(torch, ref, ivu, R, label):
    """Each stage of the range route against its plain version on the
    (b, n, n) stack R, all in Prim order: parents (j and w's bits), route
    flags (all True), range writer (values, no -0.0)."""
    j, w = ivu.ivat_parents_cuda(R)
    pj, pw = ref.ivat_parents_ref(R)
    require(torch.equal(j, pj) and torch.equal(w.view(torch.int32),
                                               pw.view(torch.int32)),
            f"ivat parents {label}: kernel != plain")
    ok, tables = ivu.ivat_route_cuda(j, w)
    require(torch.equal(ok, ref.ivat_route_ref(pj, pw)) and bool(ok.all()),
            f"ivat route {label}: kernel {ok.tolist()} != plain or not all "
            "on the range route")
    D = ivu.ivat_range_cuda(w, tables, ok)
    require(torch.equal(D, ref.ivat_range_ref(pw))
            and not bool(torch.signbit(D).any()),
            f"ivat range {label}: kernel != plain")
    log("kernel-check", kernel="ivat_from_vat", stages=label,
        shape=list(R.shape), parents_bitwise=True, route_equal=True,
        range_equal=True)


def check_ivat(torch, ref, ops, core, rstars):
    """The iVAT op against the plain recurrence, by value, on every rstar of
    the main path and on inputs chosen for each route: a VAT order with two
    rows swapped (no Prim order: the serial route), the VAT orders of
    duplicate points and of a precomputed matrix with negative entries and
    +-0.0 (the range route), a stack of all four and a stack of copies of
    the largest matrix past 2^31 elements (each lane == its solo call);
    then each stage against its plain version at (2,048), (16,384) and
    (8, 2,048).  Prints each lane's route."""
    from repro_torch.kernels import ivat_update as ivu
    prim = rstars[0]
    Xd = np.repeat(blobs(683, 16, k=8, seed=3), 3, axis=0)[:2048]
    cases = [(f"main path rstar n={r.shape[0]}", r, True) for r in rstars]
    cases += [
        ("swapped rows n=2048", swapped_non_prim(torch, ref, prim), False),
        ("duplicate points n=2048", core.vat_from_dist(ops.pairwise_dist(
            torch.from_numpy(Xd).cuda(), form="direct")).rstar, True),
        ("negative and +-0.0 entries n=2048", core.vat_from_dist(
            torch.from_numpy(signed_matrix(2048, seed=4)).cuda()).rstar,
         True)]
    solo = {}
    for label, R, want_range in cases:
        ivu.reset_route_lanes()
        K = ivu.ivat_from_vat_cuda(R)
        routes = ivu.route_lanes()
        P = ref.ivat_from_vat_ref(R)
        require(routes == {"range": int(want_range),
                           "serial": int(not want_range)},
                f"ivat {label}: lanes by route {routes}, want the "
                f"{'range' if want_range else 'serial'} route")
        require(torch.equal(K, P), f"ivat {label}: kernel != plain "
                f"(max |diff| {float(torch.amax(torch.abs(K - P)))})")
        require(torch.equal(K, K.T) and not bool(torch.diagonal(K).any()),
                f"ivat {label}: not symmetric with a zero diagonal")
        solo[label] = K
        log("kernel-check", kernel="ivat_from_vat", input=label,
            n=R.shape[0], route="range" if want_range else "serial",
            equal_to_recurrence=True,
            negative_zeros=int(torch.signbit(K).sum()))
    mixed = [c for c in cases if c[1].shape[0] == 2048]
    stack = torch.stack([R for _, R, _ in mixed])
    ivu.reset_route_lanes()
    K = ivu.ivat_from_vat_cuda(stack)
    routes = ivu.route_lanes()
    ranged = sum(want for _, _, want in mixed)
    require(routes == {"range": ranged, "serial": len(mixed) - ranged},
            f"ivat mixed stack: lanes by route {routes}")
    require(all(torch.equal(K[z], solo[label])
                for z, (label, _, _) in enumerate(mixed)),
            "ivat mixed stack: a lane differs from its solo call")
    log("kernel-check", kernel="ivat_from_vat", input="mixed stack",
        lanes=[label for label, _, _ in mixed],
        routes=["range" if want else "serial" for _, _, want in mixed],
        lanes_by_route=routes, lanes_equal_solo=True)
    # a stack past 2^31 elements: copies of the largest main-path matrix
    big = rstars[-1]
    nb = big.shape[0]
    lanes = 2 ** 31 // (nb * nb) + 1
    stack = big.expand(lanes, nb, nb).contiguous()
    ivu.reset_route_lanes()
    K = ivu.ivat_from_vat_cuda(stack)
    routes = ivu.route_lanes()
    require(routes == {"range": lanes, "serial": 0},
            f"ivat stack of {lanes} x n={nb}: lanes by route {routes}")
    require(all(torch.equal(K[z], solo[f"main path rstar n={nb}"])
                for z in range(lanes)),
            f"ivat stack of {lanes} x n={nb}: a lane differs from its solo "
            "call")
    log("kernel-check", kernel="ivat_from_vat", input=f"stack of {lanes} "
        f"copies n={nb}", elements=lanes * nb * nb, lanes_by_route=routes,
        lanes_equal_solo=True)
    del stack, K
    X8 =torch.from_numpy(np.stack([blobs(2048, 64, k=8, seed=20 + s)
                                    for s in range(8)])).cuda()
    R8 = core.vat_batch_from_dist(ops.pairwise_dist_batch(X8)).rstar
    for R, label in ((prim[None], "n=2048"), (rstars[-1][None], "n=16384"),
                     (R8, "b=8 n=2048")):
        check_ivat_stages(torch, ref, ivu, R, label)
    return 0.0, R8


def phase_ivat_times(torch, ref, ivu, rstars, R8, card):
    """Row 4 at n = 2,048, 16,384 and (8, 2,048), by CUDA events: the op,
    its serial route alone (the recurrence every lane took before the range
    route) and each range-route stage; the op's profiler device time and
    the plain recurrence's (lane by lane, ``device_ms``) beside them, and
    one call's lanes by route from the route counter.  The bound is
    ``ivat_cost`` per lane."""
    rows = {}
    for R, label, reps in ((rstars[0], "n=2048", 20),
                           (rstars[-1], "n=16384", 5), (R8, "b=8 n=2048", 20)):
        Rb = R if R.dim() == 3 else R[None]
        b, n = Rb.shape[0], Rb.shape[-1]
        j, w = ivu.ivat_parents_cuda(Rb)
        ok, tables = ivu.ivat_route_cuda(j, w)
        ivu.reset_route_lanes()
        ivu.ivat_from_vat_cuda(R)
        lanes_by_route = ivu.route_lanes()
        row = {"kernel": "ivat_from_vat", "input": label, "b": b, "n": n,
               "ms": event_ms(torch, lambda: ivu.ivat_from_vat_cuda(R),
                              reps=reps),
               "profiler_ms": device_ms(torch,
                                        lambda: ivu.ivat_from_vat_cuda(R),
                                        reps=reps, label=f"ivat {label}"),
               "serial_route_ms": event_ms(
                   torch, lambda: ivu.ivat_serial_cuda(R),
                   reps=1 if n > 2048 else 3, warmup=1),
               "parents_ms": event_ms(torch, lambda: ivu.ivat_parents_cuda(Rb),
                                      reps=reps),
               "route_ms": event_ms(torch, lambda: ivu.ivat_route_cuda(j, w),
                                    reps=reps),
               "range_ms": event_ms(torch, lambda: ivu.ivat_range_cuda(
                   w, tables, ok), reps=reps),
               "plain_ms": device_ms(torch, lambda: [
                   ref.ivat_from_vat_ref(x) for x in Rb], reps=1,
                   label=f"ivat plain {label}"),
               "lanes_by_route": lanes_by_route, "timer": "cuda events"}
        nbytes, nops = ivat_cost(n)
        row["bound_ms"], row["bound_by"] = bound_ms(b * nbytes, b * nops)
        log("ivat-times", card=card, **row)
        rows[label] = row
    return rows


def tree_weight(torch, X, order):
    """Spanning-tree weight of a Prim ordering, in f64 euclidean: the sum
    over positions t >= 1 of the distance to the nearest earlier point.
    Rows go in blocks of 2,048, so no (n, n) object is formed."""
    Xd = X.double().index_select(0, order)
    sq = torch.sum(Xd * Xd, dim=1)
    n = Xd.shape[0]
    col = torch.arange(n, device=X.device)
    total = 0.0
    for t0 in range(1, n, 2048):
        t1 = min(n, t0 + 2048)
        D = torch.sqrt(torch.clamp_min(sq[t0:t1, None] + sq[None, :]
                                       - 2.0 * (Xd[t0:t1] @ Xd.T), 0.0))
        earlier = col[None, :] < torch.arange(t0, t1, device=X.device)[:, None]
        total += float(torch.sum(torch.amin(
            torch.where(earlier, D, torch.inf), dim=1)))
    return total


def check_orders(torch, ref, ops, vat_order, Xt, order_fit, label):
    """The fit's order against the plain paths on the same input."""
    n = Xt.shape[0]
    require(torch.equal(torch.sort(order_fit).values,
                        torch.arange(n, device=Xt.device)),
            f"{label}: order is not a permutation")
    R = ops.pairwise_dist(Xt)
    order_k, prim_s = wall_s(torch, lambda: vat_order(R))
    require(torch.equal(order_k, order_fit), f"{label}: refit order differs")
    order_plain_argmin, prim_plain_s = wall_s(
        torch, lambda: vat_order(R, argmin=ref.masked_argmin_ref))
    require(torch.equal(order_k, order_plain_argmin),
            f"{label}: kernel and plain argmin give different orders on "
            "the same matrix")
    Rp = ref.pairwise_dissim_ref(Xt)
    Rp.fill_diagonal_(0.0)
    order_plain = vat_order(Rp, argmin=ref.masked_argmin_ref)
    wk = tree_weight(torch, Xt, order_k)
    wp = tree_weight(torch, Xt, order_plain)
    excess = abs(wk - wp) / wp
    require(excess <= EXCESS_F32, f"{label}: tree weight of the kernel "
            f"ordering {wk} vs plain {wp}: relative {excess} > {EXCESS_F32}")
    return {"prim_loop_s": prim_s, "prim_loop_plain_argmin_s": prim_plain_s,
            "same_order_as_plain_argmin": True,
            "same_order_as_plain_pairwise": bool(torch.equal(order_k,
                                                             order_plain)),
            "tree_weight_rel_excess": excess}


def phase_main_path(torch, rt, ref, ops, build, vat_order):
    """Drive the port's main path and its ivat rung through FastVAT.

    Returns the vat fit's launch counts, its walls, the fits' R* and the
    launch counts of the ivat fit at n = 16,384 (the Prim kernel's second
    row in the ``kernels`` line)."""
    n, d = 2048, 64
    X = blobs(n, d, k=8, seed=0)
    reset_counts(build)
    walls = {}
    fv, walls["fit"] = wall_s(torch, lambda: rt.FastVAT().fit(X))
    order, walls["order"] = wall_s(torch, fv.order)
    img, walls["image"] = wall_s(torch, fv.image)
    img_iv, walls["image_ivat"] = wall_s(
        torch, lambda: fv.image(use_ivat=True))
    rep, walls["assess"] = wall_s(torch, fv.assess)
    launches = build.launch_counts()
    routes = require_range_route("vat n=2048 image(use_ivat=True)",
                                 launches["ivat_from_vat"])
    # a second fit: the first paid one-time costs (lazy module loading)
    _, walls["fit_again"] = wall_s(torch, lambda: rt.FastVAT().fit(X))
    from repro_torch.api.validation import validate_points
    from repro_torch.numerics import resolve
    t0 = time.perf_counter()
    validate_points(X)
    resolve(X, metric="euclidean")
    walls["host_prepass"] = time.perf_counter() - t0
    require(fv.method_resolved == "vat",
            f"auto picked {fv.method_resolved!r} at n={n}, want 'vat'")
    require(fv.result.meta.device.startswith("cuda"), "fit did not run on cuda")
    Xt = fv._X
    for name in ("pairwise_dist", "vat_prim_order", "ivat_from_vat"):
        require(launches[name] > 0,
                f"kernel {name} was not launched on the main path")
    require(launches["prim_persist"] == launches["prim_stream_step"] == 0,
            f"the vat path launched a matrix-free Prim kernel: {launches}")
    require(launches["vat_prim_order"] == 1
            and launches["masked_argmin"] == 0,
            f"the Prim ordering launched vat_prim_order "
            f"{launches['vat_prim_order']} and masked_argmin "
            f"{launches['masked_argmin']} times, want 1 and 0")
    require(img.shape == (n, n) and np.isfinite(img).all(), "bad image")
    require(img_iv.shape == (n, n) and np.isfinite(img_iv).all(),
            "bad iVAT image")
    require(np.array_equal(img_iv, img_iv.T) and not np.diag(img_iv).any(),
            "iVAT image is not symmetric with a zero diagonal")
    require(bool((img_iv <= img).all()), "iVAT image exceeds the VAT image")
    require(np.isfinite(rep.hopkins) and 0 < rep.hopkins < 1,
            f"bad hopkins {rep.hopkins}")
    require(rep.k_est == 8 and rep.clustered,
            f"8 separated blobs gave k_est={rep.k_est}, "
            f"clustered={rep.clustered}")
    orders = check_orders(torch, ref, ops, vat_order, Xt,
                          fv.result.order, "vat n=2048")
    # the same fit on the CPU: the plain versions end to end.  Gram-form
    # euclidean entries may differ by up to tol_e (the sqrt of the Gram
    # cancellation floor) and the super-diagonal holds the smallest
    # distances, so the band mean moves by up to tol_e: the block score
    # 1 - band / mean(R*) by tol_e / mean(R*), plus f32 rounding.
    cpu = rt.FastVAT(device="cpu").fit(X)
    cpu_rep = cpu.assess()
    sq_max = float(torch.amax(torch.sum(Xt * Xt, dim=1)))
    tol_score = ((16 * F32_EPS * sq_max) ** 0.5
                 / float(torch.mean(fv.result.rstar)) + 1e-5)
    require(abs(cpu_rep.block_score - rep.block_score) <= tol_score
            and cpu_rep.k_est == rep.k_est,
            f"CPU and GPU assess differ beyond {tol_score}: {cpu_rep} vs "
            f"{rep}")
    log("main-path", n=n, d=d, method=fv.method_resolved,
        launches=launches, ivat_routes=routes, walls_s=walls,
        hopkins=rep.hopkins,
        block_score=rep.block_score, k_est=rep.k_est,
        cpu_block_score=cpu_rep.block_score, block_score_tol=tol_score,
        same_order_as_cpu_fit=bool(np.array_equal(cpu.order(), order)),
        **orders)

    rstars = [fv.result.rstar]
    big_launches = None
    for n2, d2 in ((2048, 64), (16384, 32)):
        X2 = X if n2 == n else blobs(n2, d2, k=8, seed=1)
        reset_counts(build)
        fiv, wall = wall_s(torch, lambda: rt.FastVAT(method="ivat").fit(X2))
        counts = build.launch_counts()
        routes = require_range_route(f"ivat fit n={n2}", 1)
        require(counts["pairwise_dist"] == 1 and counts["ivat_from_vat"] == 1
                and counts["vat_prim_order"] == 1
                and counts["masked_argmin"] == 0,
                f"ivat fit n={n2}: launch counts {counts}")
        iv = fiv.result.ivat_image
        require(iv.shape == (n2, n2) and bool(torch.isfinite(iv).all()),
                "bad ivat image")
        require(torch.equal(iv, iv.T) and not bool(torch.diagonal(iv).any()),
                "ivat image not symmetric with zero diagonal")
        orders = check_orders(torch, ref, ops, vat_order, fiv._X,
                              fiv.result.order, f"ivat n={n2}")
        log("ivat-rung", n=n2, d=d2, launches=counts, ivat_routes=routes,
            fit_wall_s=wall,
            **orders)
        if n2 != n:
            rstars.append(fiv.result.rstar)
            big_launches = counts
    return launches, walls, rstars, big_launches


def phase_profile(torch, rt, X, label="vat n=2048", many=False):
    """Device busy share of one main-path fit (a ``fit_many`` of the stack X
    when ``many``), from torch.profiler: the kernels' device time over the
    fit's wall time (tracing slows the host, so the share is a lower
    bound), and the kernels that take most."""
    from torch.profiler import ProfilerActivity, profile
    fit = rt.FastVAT().fit_many if many else rt.FastVAT().fit
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, wall = wall_s(torch, lambda: fit(X))
    by_name = kernel_device_ms(prof)
    busy = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log("profile", fit=label, fit_wall_ms=wall * 1e3, device_busy_ms=busy,
        device_busy_share=busy / (wall * 1e3),
        top_ms={name[:60]: ms for name, ms in top})


# ------------------------------------------------------- flash path ----

def frontier_minima(torch, R, order):
    """edges[t] of a Prim ordering read off the matrix R: the least entry of
    row order[t] over the earlier vertices, t >= 1."""
    out = torch.empty(R.shape[0] - 1, dtype=R.dtype, device=R.device)
    Rs = R.index_select(0, order)
    pos = torch.empty_like(order)
    pos[order] = torch.arange(order.numel(), device=R.device)
    for t0 in range(1, R.shape[0], 2048):   # row blocks: no (n, n) mask
        rows = Rs[t0:t0 + 2048]
        t = torch.arange(t0, t0 + rows.shape[0], device=R.device)
        earlier = pos[None, :] < t[:, None]
        out[t0 - 1:t0 - 1 + rows.shape[0]] = torch.amin(
            torch.where(earlier, rows, torch.inf), dim=1)
    return out


def event_once_ms(torch, fn):
    """CUDA-event time of one call (for a kernel of seconds, where launch
    cost is nothing and a repeat costs as much as the first run)."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def stepwise_costs(torch, ops, core, X, seed_pivot, traced_n: int = 8_192):
    """The stepwise engine's step as its loop runs it, on X (n, d) or a
    (b, n, d) stack: host us a step (the enqueue of 500 steps, the card
    idle at the start), stream us a step (CUDA events over the next 2,000),
    and, from a traced traversal of the first ``traced_n`` points, device
    operations a step, required to be one: the step kernel and nothing
    else."""
    from torch.profiler import ProfilerActivity, profile
    lead = X.shape[:-1]
    aux = ops.metric_aux(X)
    i0 = (torch.stack([seed_pivot(x, metric="euclidean") for x in X])
          if X.dim() == 3 else seed_pivot(X, metric="euclidean"))
    mind = torch.full(lead, torch.inf, device="cuda")
    sel = torch.zeros(lead, dtype=torch.bool, device="cuda")
    order = torch.zeros(lead, dtype=torch.int64, device="cuda")
    edges = torch.zeros(lead, device="cuda")
    order[..., 0] = i0
    sel.scatter_(-1, order[..., :1], True)
    step = ops.prim_stream_stepper(X, aux, mind, sel, order, edges)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for t in range(1, 501):
        step(t)
    host_us = (time.perf_counter() - t0) * 1e6 / 500
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for t in range(501, 2501):
        step(t)
    end.record()
    end.synchronize()
    Xt = X[..., :traced_n, :].contiguous()
    run = (core.vat_matrix_free_batch if X.dim() == 3
           else core.vat_matrix_free)
    run(Xt, turbo=False)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(Xt, turbo=False)
        torch.cuda.synchronize()
    per_step, launched = ops_per_step(prof, "stream_step_kernel")
    require(launched == traced_n - 1 and per_step == 1.0,
            f"the traced stepwise traversal ran {per_step} device "
            f"operations a step over {launched} step kernels")
    by_name = kernel_device_ms(prof)
    kernel_ms = sum(v for k, v in by_name.items() if "stream_step" in k)
    return {"host_us_per_step": host_us,
            "stream_us_per_step": start.elapsed_time(end) * 1e3 / 2000,
            "traced_n": traced_n, "device_ops_per_step": per_step,
            "traced_kernel_us_per_step": kernel_ms * 1e3 / launched}


def phase_flash_path(torch, rt, ref, ops, build, core, prim_persist_cuda,
                     prim_stream_step_cuda, seed_pivot):
    """The flashvat rung at the top of its auto window, its stepwise engine,
    and the bitwise checks of its kernels on the card."""
    from repro_torch.core.vat import PERSIST_PRUNE
    from repro_torch.kernels.prim_persist import DEFAULT_BLOCK, persist_plan
    n, d = 50_000, 64
    X = blobs(n, d, k=8, seed=0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(build)
    walls = {}
    fv, walls["fit"] = wall_s(torch, lambda: rt.FastVAT().fit(X))
    peak = torch.cuda.max_memory_allocated() - base
    order, walls["order"] = wall_s(torch, fv.order)
    img, walls["image"] = wall_s(torch, fv.image)
    img_iv, walls["image_ivat"] = wall_s(
        torch, lambda: fv.image(use_ivat=True))
    rep, walls["assess"] = wall_s(torch, fv.assess)
    launches = build.launch_counts()
    require_range_route("flashvat n=50000 band render", 1)
    require(fv.method_resolved == "flashvat",
            f"auto picked {fv.method_resolved!r} at n={n}, want 'flashvat'")
    require(fv.result.meta.device.startswith("cuda"), "fit did not run on cuda")
    m = fv.result.rstar.shape[0]
    require(launches["prim_persist"] == 1 and launches["prim_stream_step"] == 0
            and launches["vat_prim_order"] == 1 and m == 256
            and launches["masked_argmin"] == 0
            and launches["ivat_from_vat"] == 1
            and launches["pairwise_dist"] > 0,
            f"flash path launch counts {launches}")
    require(peak < 512 * 2 ** 20, f"the flashvat fit allocated {peak} bytes "
            "on the card, over 512 MiB")
    require(np.array_equal(np.sort(order), np.arange(n)),
            "flashvat order is not a permutation")
    require(img.shape == (256, 256) and np.isfinite(img).all()
            and img_iv.shape == (256, 256) and np.isfinite(img_iv).all(),
            "bad flashvat image")
    require(np.array_equal(img_iv, img_iv.T) and bool((img_iv <= img).all()),
            "flashvat iVAT image not symmetric or above the VAT image")
    require(rep.k_est == 8 and rep.clustered and 0 < rep.hopkins < 1,
            f"8 separated blobs gave {rep}")

    # pruned == eager, bit for bit, at the fit's own input and seed
    Xt = fv._X.float().contiguous()
    aux = ops.metric_aux(Xt)
    # the seed scan alone: its stream time and its pairwise launches
    build.reset_launch_counts()
    i0, seed_ms = event_once_ms(torch, lambda: seed_pivot(
        Xt, metric="euclidean"))
    seed_launches = build.launch_counts()["pairwise_dist"]
    require(seed_launches == 175, f"the seed scan at n={n} made "
            f"{seed_launches} pairwise launches, want 25 x 7 = 175")
    (o1, e1, s1), pruned_ms = event_once_ms(
        torch, lambda: prim_persist_cuda(Xt, aux, i0))
    (o0, e0, s0), eager_ms = event_once_ms(
        torch, lambda: prim_persist_cuda(Xt, aux, i0, prune=False))
    nblk = -(-n // DEFAULT_BLOCK)
    require(torch.equal(o1, o0) and torch.equal(e1, e0),
            "prim_persist: pruned and eager traversals differ")
    require(torch.equal(o1, fv.result.order), "refit order differs")
    require(int(s0[0]) <= (n - 1) * nblk and int(s1[0]) <= int(s0[0]),
            f"tile folds pruned {s1.tolist()} eager {s0.tolist()}")
    # an exact traversal meets each (earlier pivot, lane) pair once
    require(int(s1[2]) == int(s0[2]) == n * (n - 1) // 2,
            f"pair evaluations pruned {s1.tolist()} eager {s0.tolist()}, "
            f"want n (n - 1) / 2 = {n * (n - 1) // 2}")
    require(int(s1[3]) == int(s0[3]) == n - 1,
            f"group barriers pruned {s1.tolist()} eager {s0.tolist()}, "
            f"want one a step")
    plan = persist_plan(1, n, d)
    log("flash-path", n=n, d=d, method=fv.method_resolved,
        launches=launches, walls_s=walls, peak_alloc_mib=peak / 2 ** 20,
        hopkins=rep.hopkins, block_score=rep.block_score, k_est=rep.k_est,
        pruned_equals_eager=True, stats_pruned=s1.tolist(),
        stats_eager=s0.tolist(), eager_tile_fold_cap=(n - 1) * nblk,
        seed_scan_s=seed_ms / 1e3, seed_scan_launches=seed_launches,
        block=DEFAULT_BLOCK, group=plan["group"], ctas=plan["ctas"],
        rows_staged=plan["rows_staged"], smem_bytes=plan["smem_bytes"],
        barriers_per_step=int(s1[3]) / (n - 1), path_prunes=PERSIST_PRUNE,
        pruned_ms=pruned_ms, eager_ms=eager_ms,
        pruned_us_per_step=pruned_ms * 1e3 / (n - 1),
        eager_us_per_step=eager_ms * 1e3 / (n - 1))

    # the stepwise engine is its own path: counts from 0, read after
    build.reset_launch_counts()
    fs, wall = wall_s(torch, lambda: rt.FastVAT(turbo=False).fit(X))
    step_launches = build.launch_counts()
    require(step_launches["prim_stream_step"] == n - 1
            and step_launches["prim_persist"] == 0,
            f"stepwise launch counts {step_launches}")
    require(np.array_equal(fs.order(), order),
            "stepwise and persistent engines give different orders")
    costs = stepwise_costs(torch, ops, core, fv._X.float().contiguous(),
                           seed_pivot)
    log("flash-stepwise", n=n, fit_wall_s=wall,
        fit_us_per_step=wall * 1e6 / (n - 1), launches=step_launches,
        same_order_as_persistent=True, **costs)

    # flashvat against the materialized ordering of the same conditioned
    # data: the pairwise kernel's matrix and the masked-argmin Prim loop
    n2, d2 = 16_384, 32
    X2 = blobs(n2, d2, k=8, seed=1)
    ff, wall_flash = wall_s(torch,
                            lambda: rt.FastVAT(method="flashvat").fit(X2))
    fm, wall_vat = wall_s(torch, lambda: rt.FastVAT(method="vat").fit(X2))
    require(ff.result.meta.numerics == fm.result.meta.numerics,
            "flashvat and vat fits took different numerics plans")
    require(np.array_equal(ff.order(), fm.order()),
            "flashvat order differs from the materialized vat order")
    X2t = ff._X.float().contiguous()
    res2 = core.vat_matrix_free(X2t)
    require(torch.equal(res2.order, ff.result.order), "refit order differs")
    R2 = ops.pairwise_dist(X2t)
    require(torch.equal(res2.edges[1:], frontier_minima(torch, R2,
                                                        res2.order)),
            "flashvat edges are not the materialized frontier minima")
    del R2
    # the plain version on the same card tensors: rows from cuBLAS, so
    # held by spanning-tree weight
    aux2 = ops.metric_aux(X2t)
    i02 = seed_pivot(X2t, metric="euclidean")
    porder, pedges = ref.prim_persist_ref(X2t, aux2, i02)
    wk = tree_weight(torch, X2t, res2.order)
    wp = tree_weight(torch, X2t, porder)
    excess = abs(wk - wp) / wp
    require(excess <= EXCESS_F32, f"prim_persist vs plain at n={n2}: tree "
            f"weight {wk} vs {wp}, relative {excess} > {EXCESS_F32}")
    # the MST's edge weights, as multisets, within the gram tolerance
    persist_err = float(torch.amax(torch.abs(
        torch.sort(res2.edges).values - torch.sort(pedges).values)))
    tol2 = (16 * F32_EPS * float(torch.amax(aux2))) ** 0.5
    require(persist_err <= tol2, f"prim_persist edges vs plain: "
            f"{persist_err} > {tol2}")
    log("flash-vs-materialized", n=n2, d=d2, flash_fit_s=wall_flash,
        vat_fit_s=wall_vat, same_order=True, edges_are_frontier_minima=True,
        plain_tree_weight_rel_excess=excess, plain_edges_max_abs_err=
        persist_err, plain_edges_tol=tol2,
        same_order_as_plain=bool(torch.equal(porder, res2.order)))

    # uncentered data: through the fit (auto policy: conditioned, direct
    # form) and raw, both forms, where the pruning slack carries the gram
    # rows' absolute error
    X3 = blobs(4_096, 16, k=8, seed=2) + np.float32(1e3)
    f3 = rt.FastVAT(method="flashvat").fit(X3)
    require(f3.result.meta.numerics.form == "direct",
            f"uncentered blobs took {f3.result.meta.numerics}")
    checked = []
    for data, form, label in ((f3._X.float().contiguous(), "direct", "fit"),
                              (torch.from_numpy(X3).cuda(), "gram", "raw"),
                              (torch.from_numpy(X3).cuda(), "direct", "raw")):
        a3 = ops.metric_aux(data)
        s3 = seed_pivot(data, metric="euclidean", form=form)
        p = prim_persist_cuda(data, a3, s3, form=form, block=64)
        e = prim_persist_cuda(data, a3, s3, form=form, block=64, prune=False)
        require(torch.equal(p[0], e[0]) and torch.equal(p[1], e[1]),
                f"uncentered {label}/{form}: pruned and eager differ")
        checked.append({"data": label, "form": form,
                        "stats_pruned": p[2].tolist(),
                        "stats_eager": e[2].tolist()})
    require(np.array_equal(f3.order(), core.vat_matrix_free(
        f3._X, form="direct").order.cpu().numpy()), "uncentered refit differs")
    log("flash-uncentered", n=4096, d=16, offset=1e3, checked=checked)

    # one step of the stepwise kernel against its plain version at the
    # path's shape: the frontier within the pairwise tolerance, the pair
    # the plain argmin of the kernel's own frontier, bit for bit
    gen = torch.Generator(device="cuda").manual_seed(3)
    mind = torch.rand(n, device="cuda", generator=gen) * 50.0
    sel = torch.rand(n, device="cuda", generator=gen) < 0.5
    q = torch.tensor([int(i0)], device="cuda")
    want, _, _ = ref.prim_stream_step_ref(Xt, aux, q, mind.clone(), sel)
    rmind, rsel = mind.clone(), sel.clone()
    got, ev, nq = prim_stream_step_cuda(Xt, aux, q, mind, sel)
    step_err = float(torch.amax(torch.abs(got - want)))
    tol = (16 * F32_EPS * float(torch.amax(aux))) ** 0.5
    pv, pi = ref.masked_argmin_ref(got, sel)
    require(step_err <= tol and int(nq) == int(pi)
            and torch.equal(ev.view(1), pv.view(1)),
            f"prim_stream_step vs plain: err {step_err} (tol {tol}), pair "
            f"({float(ev)}, {int(nq)}) vs ({float(pv)}, {int(pi)})")
    # the recording step the engine runs: the single step's frontier and
    # pair, bit for bit, written into the record and the mask
    rorder = torch.zeros(n, dtype=torch.int64, device="cuda")
    rorder[0] = q[0]
    redges = torch.zeros(n, device="cuda")
    ops.prim_stream_stepper(Xt, aux, rmind, rsel, rorder, redges)(1)
    sel[int(nq)] = True
    require(torch.equal(rmind, got) and int(rorder[1]) == int(nq)
            and torch.equal(redges[1:2], ev.view(1))
            and torch.equal(rsel, sel),
            "the recording step differs from the single step")
    log("kernel-check", kernel="prim_stream_step", n=n, d=d,
        max_abs_err=step_err, tol=tol, pair_bitwise=True,
        record_equals_single_step=True)
    return {"launches": launches, "step_launches": step_launches,
            "X": Xt, "aux": aux, "i0": i0, "stats": s1.tolist(),
            "plan": plan, "stepwise_fit_s": wall,
            "path_ms": pruned_ms if PERSIST_PRUNE else eager_ms,
            "order": o1, "edges": e1,
            "pruned_ms": pruned_ms, "eager_ms": eager_ms,
            "stats_eager": s0.tolist(),
            "step_err": step_err}


def persist_blocks(torch, prim_persist_cuda, persist_plan, flash):
    """prim_persist at the flash path's input for each tile length, pruned
    and eager: its time, group, staging and tile folds, each run held bit
    for bit against the path's order and edges (the tile length sets the
    work, never a bit)."""
    X, aux, i0 = flash["X"], flash["aux"], flash["i0"]
    n, d = X.shape
    out = []
    for block in (64, 128, 256, 512, 1024):
        row = {"block": block, **persist_plan(1, n, d, block=block)}
        for prune, label in ((True, "pruned"), (False, "eager")):
            (o, e, st), ms = event_once_ms(torch, lambda: prim_persist_cuda(
                X, aux, i0, block=block, prune=prune))
            require(torch.equal(o, flash["order"])
                    and torch.equal(e, flash["edges"]),
                    f"prim_persist block={block} prune={prune} differs")
            row[f"{label}_ms"] = ms
            row[f"{label}_tile_folds"] = int(st[0])
        out.append(row)
    return out


def persist_step_floor(torch, ops, prim_persist_cuda, seed_pivot, n: int):
    """The per-step cost of the traversal with next to no fold work: the
    flash path's n at d = 4, pruned and eager, in us a step."""
    Xs = torch.from_numpy(blobs(n, 4, k=8, seed=0)).cuda()
    aux = ops.metric_aux(Xs)
    i0 = seed_pivot(Xs, metric="euclidean")
    out = {"n": n, "d": 4}
    for prune, label in ((True, "pruned"), (False, "eager")):
        (_, _, st), ms = event_once_ms(torch, lambda: prim_persist_cuda(
            Xs, aux, i0, prune=prune))
        out[f"{label}_us_per_step"] = ms * 1e3 / (n - 1)
        out[f"{label}_barriers"] = int(st[3])
    return out


def phase_flash_times(torch, ref, ops, flash, prim_stream_step_cuda,
                      prim_persist_cuda, seed_pivot):
    """The two Prim kernels beside their plain versions and bounds, at the
    flash path's shapes (n = 50,000, d = 64); prim_persist also at every
    tile length, and its per-step floor."""
    from repro_torch.kernels.prim_persist import persist_plan
    X, aux, i0 = flash["X"], flash["aux"], flash["i0"]
    n, d = X.shape
    # the plain traversal is n - 1 steps of ~7 launches: a profiler trace of
    # it takes minutes to read back, so it is timed by CUDA events around
    # one call (stream time: the host's launch gaps are included)
    (porder, pedges), plain_ms = event_once_ms(
        torch, lambda: ref.prim_persist_ref(X, aux, i0))
    # ... and held against the kernel's traversal of the same tensors: its
    # rows come from cuBLAS, so by spanning-tree weight and by the MST's
    # edge weights as multisets, within the gram tolerance
    wk = tree_weight(torch, X, flash["order"])
    wp = tree_weight(torch, X, porder)
    excess = abs(wk - wp) / wp
    require(excess <= EXCESS_F32, f"prim_persist vs plain at n={n}: tree "
            f"weight {wk} vs {wp}, relative {excess} > {EXCESS_F32}")
    err = float(torch.amax(torch.abs(torch.sort(flash["edges"]).values
                                     - torch.sort(pedges).values)))
    tol = (16 * F32_EPS * float(torch.amax(aux))) ** 0.5
    require(err <= tol, f"prim_persist edges vs plain at n={n}: {err} > "
            f"{tol}")
    persist = {"kernel": "prim_persist", "n": n, "ms": flash["path_ms"],
               "pruned_ms": flash["pruned_ms"], "eager_ms": flash["eager_ms"],
               "plain_ms": plain_ms,
               "plain_timer": "cuda events, one call",
               "library_ms": None, "stats": flash["stats"],
               "stats_eager": flash["stats_eager"],
               "plain_tree_weight_rel_excess": excess,
               "plain_edges_max_abs_err": err, "plain_edges_tol": tol,
               "same_order_as_plain": bool(torch.equal(porder,
                                                       flash["order"]))}
    persist["bound_ms"], persist["bound_by"] = bound_ms(
        *persist_cost(n, d, flash["stats"][2]))
    plan = flash["plan"]
    persist.update(
        group=plan["group"], ctas=plan["ctas"],
        rows_staged=plan["rows_staged"],
        barriers_per_step=flash["stats"][3] / (n - 1),
        us_per_step=flash["path_ms"] * 1e3 / (n - 1),
        pruned_us_per_step=flash["pruned_ms"] * 1e3 / (n - 1),
        eager_us_per_step=flash["eager_ms"] * 1e3 / (n - 1),
        stepwise_fit_s=flash["stepwise_fit_s"],
        blocks=persist_blocks(torch, prim_persist_cuda, persist_plan, flash),
        step_floor=persist_step_floor(torch, ops, prim_persist_cuda,
                                      seed_pivot, n))
    log("time", **persist)
    from repro_torch.kernels import _build as build
    mind = torch.full((n,), torch.inf, device=X.device)
    sel = torch.zeros(n, dtype=torch.bool, device=X.device)
    sel[int(i0)] = True
    q = i0.view(1)
    order = torch.zeros(n, dtype=torch.int64, device=X.device)
    order[0] = i0
    edges = torch.zeros(n, device=X.device)
    # the step as the engine runs it: one call of its step object (one
    # launch); the single-call wrapper also copies X feature-major and
    # allocates its scratch each call
    rec = ops.prim_stream_stepper(X, aux, mind.clone(), sel.clone(), order,
                                  edges)
    step = {"kernel": "prim_stream_step", "n": n,
            "ms": device_ms(torch, lambda: rec(1), reps=200,
                            label="prim_stream_step"),
            "plain_ms": device_ms(torch, lambda: ref.prim_stream_step_ref(
                X, aux, q, mind, sel), reps=50,
                label="prim_stream_step plain"),
            "library_ms": None,
            "library_ms_why": "no single call: a fold then a masked argmin",
            "event_ms": event_ms(torch, lambda: rec(1), reps=200),
            "single_call_ms": device_ms(torch, lambda: prim_stream_step_cuda(
                X, aux, q, mind, sel), reps=50,
                label="prim_stream_step single call"),
            "l2_floor_ms": read_floor_ms(torch, build, X)}
    step["bound_ms"], step["bound_by"] = bound_ms(*stream_step_cost(n, d))
    log("time", **step)
    return persist, step


# ---------------------------------------------------- the sharded path ----

def frontier_step_cost(n: int, d: int):
    """One step of one rank's shard: X read once, the frontier read and
    written (8 bytes a lane), aux (4 bytes a lane), the table slot and the
    new slot; one FMA per feature and lane, a 4-op epilogue."""
    width = 4 + 4 * -(-d // 4)
    return 4 * n * d + 12 * n + 8 * width, 2 * n * d + 4 * n


def check_frontier_kernel(torch, ref, prim_frontier_step_cuda, gen):
    """The frontier kernel against its plain version on the same tensors:
    six kinds at the shard-path shape (n = 50,000, d = 64, one rank) and at
    ragged small n; the least-key slot of three is the pivot, recorded
    exactly; its lane closed; +inf lanes kept; finite lanes within the
    pairwise tolerance; the new slot the kernel's own first-index minimum
    (global id, raw value, aux entry, point), bit for bit."""
    from repro_torch.kernels.pairwise_dist import metric_aux_cuda
    offset = 1_000_000
    cases, worst = [], {}
    shapes = ((50_000, 64), (1, 64), (255, 7), (257, 64), (1_000, 5))
    for n, d in shapes:
        X = torch.randn(n, d, device="cuda", generator=gen)
        width = ref.slot_width(d)
        for metric, form in (("euclidean", "gram"), ("sqeuclidean", "gram"),
                             ("cosine", "gram"), ("euclidean", "direct"),
                             ("sqeuclidean", "direct"),
                             ("manhattan", "direct")):
            aux = metric_aux_cuda(X, metric=metric)
            piv = min(17, n - 1)

            def slot(v, gid, local):
                return ref.make_slot(
                    torch.tensor(v, device="cuda"),
                    torch.tensor(gid, device="cuda"),
                    torch.tensor(v, device="cuda"), aux[local], X[local],
                    width)

            table = torch.stack([slot(7.0, 3, 0),
                                 slot(2.5, offset + piv, piv),
                                 slot(2.5, offset + n + 9, 0)])
            u = torch.rand(n, device="cuda", generator=gen)
            mind = torch.where(u < 0.3, torch.inf, torch.where(
                u < 0.6, ref.UNSEEN, 50.0 * torch.rand(
                    n, device="cuda", generator=gen)))
            order = torch.zeros(4, dtype=torch.int64, device="cuda")
            edges = torch.zeros(4, device="cuda")
            porder, pedges = order.clone(), edges.clone()
            want, _ = ref.prim_frontier_round_ref(
                X, aux, table, mind.clone(), porder, pedges, 2,
                offset=offset, metric=metric, form=form)
            was_inf = torch.isinf(mind)
            out = torch.empty(width, device="cuda")
            got = prim_frontier_step_cuda(X, aux, table, mind, out, order,
                                          edges, 2, offset=offset,
                                          metric=metric, form=form)
            torch.cuda.synchronize()
            label = f"{metric}/{form} n={n} d={d}"
            require(torch.equal(order, porder) and torch.equal(edges, pedges)
                    and int(order[2]) == offset + piv
                    and float(edges[2]) == 2.5,
                    f"frontier {label}: pivot recorded {order.tolist()} "
                    f"{edges.tolist()}")
            require(bool(torch.isinf(got[piv]))
                    and bool(torch.all(torch.isinf(got[was_inf])))
                    and torch.equal(torch.isinf(got), torch.isinf(want)),
                    f"frontier {label}: +inf lanes not kept in band")
            fin = ~torch.isinf(got)
            err, tol = 0.0, 0.0
            if bool(fin.any()):
                err = float(torch.amax(torch.abs(got[fin] - want[fin])))
                tol = (plain_tolerance(torch, metric, X, want[fin])
                       if form == "gram" else 1e-5 * float(
                           torch.amax(torch.abs(want[fin]))) + 1e-6)
            require(err <= tol, f"frontier {label}: err {err} > {tol}")
            i = int(torch.argmin(got))
            key = ref.signed_key(got[i], torch.tensor(offset + i,
                                                      device="cuda"))
            require(torch.equal(out[:2].view(torch.int64), key.view(1))
                    and torch.equal(out[2:4], torch.stack([got[i], aux[i]]))
                    and torch.equal(out[4:4 + d], X[i])
                    and bool(torch.all(out[4 + d:] == 0)),
                    f"frontier {label}: the new slot is not the kernel's "
                    f"own minimum {i}")
            worst[f"{metric}/{form}"] = max(worst.get(f"{metric}/{form}",
                                                      0.0), err)
            cases.append(label)
    log("frontier-kernel", kernel="prim_frontier_step", cases=len(cases),
        shapes=[list(s) for s in shapes], max_abs_err=worst,
        in_band=True, pivot_recorded=True, slot_bitwise=True)
    return worst["euclidean/gram"]


def init_world_of_one(torch, dist):
    """An NCCL process group of one rank on card 0, from an in-memory
    store: every collective of the sharded path runs, over no network."""
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)


def phase_shard_path(torch, rt, ref, core, build, flash):
    """``core.vat_matrix_free_sharded`` over NCCL at world size 1: the
    flash path's n = 50,000 points equal prim_persist's order and edges bit
    for bit, four metrics at n = 4,096 too; wall time, peak memory, and a
    traced fit's kernel, NCCL and idle times."""
    X, n = flash["X"], flash["X"].shape[0]
    d = X.shape[1]
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launch_counts()
    sh, wall = wall_s(torch, lambda: core.vat_matrix_free_sharded(X))
    launches = build.launch_counts()
    peak = torch.cuda.max_memory_allocated() - base
    require(launches["prim_frontier_step"] == n
            and launches["pairwise_dist"] > 0
            and launches["prim_persist"] == launches["prim_stream_step"] == 0,
            f"shard path launch counts {launches}")
    require(torch.equal(sh.order, flash["order"])
            and torch.equal(sh.edges, flash["edges"]),
            f"sharded n={n}: order or edges differ from prim_persist's")
    require(peak < 512 * 2 ** 20, f"the sharded fit allocated {peak} bytes "
            "on the card, over 512 MiB")
    metrics = {}
    for metric in ref.METRICS:
        Xm = torch.from_numpy(blobs(4_096, 64, k=8, seed=4)).cuda()
        solo = core.vat_matrix_free(Xm, metric=metric)
        shm, w = wall_s(torch, lambda: core.vat_matrix_free_sharded(
            Xm, metric=metric))
        require(torch.equal(shm.order, solo.order)
                and torch.equal(shm.edges, solo.edges),
                f"sharded {metric} n=4096 differs from prim_persist")
        metrics[metric] = w
    # one traced fit: at n = 8,192, since a trace of n steps of a few
    # events each takes minutes to read back at 50,000
    from torch.profiler import ProfilerActivity, profile
    nt = 8_192
    Xt = X[:nt].contiguous()
    core.vat_matrix_free_sharded(Xt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, twall = wall_s(torch, lambda: core.vat_matrix_free_sharded(Xt))
    # the collective shows twice on the card's timeline: as NCCL's
    # annotation ("nccl:...") and as the work under it (at one rank, a
    # device-to-device copy); busy time and operations count the work once
    from torch.autograd import DeviceType
    by_name = kernel_device_ms(prof)
    nccl_ms = sum(v for k, v in by_name.items() if k.startswith("nccl:"))
    busy = sum(v for k, v in by_name.items() if not k.startswith("nccl:"))
    frontier_ms = sum(v for k, v in by_name.items() if "frontier" in k)
    ops_traced = sum(e.count for e in prof.key_averages()
                     if e.device_type == DeviceType.CUDA
                     and e.self_device_time_total
                     and not e.key.startswith("nccl:"))
    # a step's operations: from the first frontier kernel to the last,
    # the seed scan and the set-up before them left out
    per_step, steps = ops_per_step(prof, "frontier_step_kernel")
    require(steps == nt and per_step <= 2.0,
            f"the traced sharded fit ran {per_step} device operations a "
            f"step over {steps} frontier kernels, want at most 2")
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    log("shard-path", n=n, d=d, world_size=1, backend="nccl",
        fit_wall_s=wall, fit_us_per_step=wall * 1e6 / n, launches=launches,
        peak_alloc_mib=peak / 2 ** 20,
        equals_prim_persist=True, metrics_n4096_wall_s=metrics,
        traced_n=nt, traced_fit_wall_ms=twall * 1e3, device_busy_ms=busy,
        idle_share=1.0 - busy / (twall * 1e3),
        frontier_kernel_ms_per_step=frontier_ms / nt,
        nccl_ms_per_step=nccl_ms / nt, device_ops_per_step=per_step,
        device_ops_per_fit_step=ops_traced / nt,
        top_ms={k[:60]: v for k, v in top})
    return launches, wall


def phase_frontier_times(torch, ref, prim_frontier_step_cuda, flash, err,
                         launches):
    """The frontier kernel at the shard path's shape beside its plain
    version and bound."""
    X, aux = flash["X"], flash["aux"]
    n, d = X.shape
    width = ref.slot_width(d)
    zero = torch.zeros((), device="cuda")
    i0 = flash["i0"]
    table = ref.make_slot(zero, i0, zero, aux[i0], X[i0], width).view(1, -1)
    mind = torch.full((n,), ref.UNSEEN, device="cuda")
    out = torch.empty(width, device="cuda")
    order = torch.zeros(1, dtype=torch.int64, device="cuda")
    edges = torch.zeros(1, device="cuda")
    from repro_torch.kernels import _build as build
    from repro_torch.kernels import ops
    # the step as the engine runs it: one call of its step object
    fstep = ops.prim_frontier_stepper(X, aux, table, mind.clone(), out,
                                      order, edges)
    row = {"kernel": "prim_frontier_step", "n": n,
           "ms": device_ms(torch, lambda: fstep(0), reps=200,
                           label="prim_frontier_step"),
           "plain_ms": device_ms(torch, lambda: ref.prim_frontier_round_ref(
               X, aux, table, mind, order, edges, 0, offset=0), reps=50,
               label="prim_frontier_step plain"),
           "library_ms": None,
           "library_ms_why": "no single call: a fold then a masked argmin",
           "event_ms": event_ms(torch, lambda: fstep(0), reps=200),
           "single_call_ms": device_ms(torch, lambda: prim_frontier_step_cuda(
               X, aux, table, mind, out, order, edges, 0), reps=50,
               label="prim_frontier_step single call"),
           "l2_floor_ms": read_floor_ms(torch, build, X)}
    row["bound_ms"], row["bound_by"] = bound_ms(*frontier_step_cost(n, d))
    log("time", **row)
    return {"name": "prim_frontier_step", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/prim_stream.cu",
            "replaces": "src/repro/kernels/prim_stream.py:175",
            "launches": launches["prim_frontier_step"], "max_abs_err": err,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None, "event_ms": row["event_ms"],
            "l2_floor_ms": row["l2_floor_ms"]}


def phase_dvat(torch, rt, core, build):
    """``core.dvat`` at world size 1 (n = 16,384: its exact start is the
    reference's (n/P, n) strip, 1 GiB here) against the solo vat order by
    tree weight (its rows are direct differences, not the pairwise
    kernel's, so a bitwise order is not owed); the dvat rung refuses one
    rank; the svat rung runs on the card."""
    n, d = 16_384, 64
    X = torch.from_numpy(blobs(n, d, k=8, seed=5)).cuda()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    res, wall = wall_s(torch, lambda: core.dvat(X))
    peak = torch.cuda.max_memory_allocated() - base
    order = res.order
    require(torch.equal(torch.sort(order).values,
                        torch.arange(n, device="cuda")),
            "dvat order is not a permutation")
    vat_order = core.vat(X).order
    wd, wv = tree_weight(torch, X, order), tree_weight(torch, X, vat_order)
    excess = abs(wd - wv) / wv
    require(excess <= EXCESS_F32, f"dvat vs vat at n={n}: tree weight {wd} "
            f"vs {wv}, relative {excess} > {EXCESS_F32}")
    try:
        rt.FastVAT(method="dvat").fit(blobs(64, 4, k=2, seed=0))
        refused = False
    except RuntimeError:
        refused = True
    require(refused, "FastVAT(method='dvat') ran at world size 1")
    Xs = blobs(50_000, 64, k=8, seed=0)
    build.reset_launch_counts()
    fv, swall = wall_s(torch, lambda: rt.FastVAT(method="svat").fit(Xs))
    counts = build.launch_counts()
    img = fv.image()
    rep = fv.assess()
    idx = fv.sample_indices()
    require(fv.result.meta.device.startswith("cuda")
            and counts["pairwise_dist"] == 1
            and counts["vat_prim_order"] == 1
            and counts["masked_argmin"] == 0,
            f"svat fit launch counts {counts}")
    require(img.shape == (256, 256) and np.isfinite(img).all()
            and len(np.unique(idx)) == 256, "bad svat image or sample")
    require(rep.k_est == 8 and rep.clustered,
            f"svat on 8 separated blobs gave {rep}")
    log("dvat", n=n, d=d, world_size=1, dvat_wall_s=wall,
        peak_alloc_mib=peak / 2 ** 20, tree_weight_rel_excess=excess,
        same_order_as_vat=bool(torch.equal(order, vat_order)),
        dvat_rung_refuses_one_rank=refused, svat_n=50_000,
        svat_fit_wall_s=swall, svat_launches=counts, svat_k_est=rep.k_est,
        svat_block_score=rep.block_score)


# ------------------------------------------------------ approx path ----

def demo_blobs(n: int, k: int = 5, d: int = 8, seed: int = 0):
    """The reference demo's data (examples/approx_demo.py::make_blobs,
    copied): k Gaussian blobs, centres N(0, 20^2), built in blocks."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(scale=20.0, size=(k, d)).astype(np.float32)
    lab = rng.integers(0, k, size=n)
    X = np.empty((n, d), np.float32)
    for s in range(0, n, 100_000):
        e = min(s + 100_000, n)
        X[s:e] = centers[lab[s:e]] + rng.normal(
            size=(e - s, d)).astype(np.float32)
    return X, lab


def knn_cost(n: int, d: int, k: int):
    """X read once, the (n, k) lists written once (f32 + int64); one FMA
    per feature for each pair, the pairs counted once (one triangle of the
    symmetric matrix), as the pairwise row counts a self-matrix."""
    return 4 * n * d + 12 * n * k, 2 * d * n * (n - 1) // 2


def kernel_plain_knn(ref, pairwise_dist_cuda, Xq, Xc, qid, cid, k, metric,
                     rows=2048):
    """The kNN kernel's function from the pairwise kernel's entries: each
    row block of the matrix masked, stably sorted by (value, id), first k.
    Bit for bit what the kernel must return."""
    import torch
    parts = [ref.topk_from_dissim(
        pairwise_dist_cuda(Xq[r0:r0 + rows], Xc, metric=metric),
        qid[r0:r0 + rows], cid, k) for r0 in range(0, Xq.shape[0], rows)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def plain_tolerance(torch, metric, X, want):
    """check_pairwise's tolerances: a sqrt of the gram cancellation floor
    for euclidean, 1e-5 of the scale (+1e-6) otherwise."""
    if metric == "euclidean":
        return (16 * F32_EPS * float(torch.amax(torch.sum(X * X, 1)))) ** 0.5
    finite = want[torch.isfinite(want)]
    return 1e-5 * float(torch.amax(torch.abs(finite))) + 1e-6


def phase_knn_kernel(torch, ref, ops, knn_topk_cuda, knn_topk_blocked,
                     pairwise_dist_cuda, gen):
    """The kNN kernel against its function on the card, bit for bit, at the
    approx paths' shapes and ragged ones; and against the plain version
    (cuBLAS rows) within the pairwise tolerance."""
    from repro_torch.kernels import _build
    require(_build.library().repro_knn_max_k() == 128, "kernel MAX_K")
    cases = 0
    for metric in ref.METRICS:
        for n in (64, 257, 1024, 4099):
            for d in (3, 64, 100):
                X = torch.randn(n, d, device="cuda", generator=gen)
                ids = torch.arange(n, device="cuda")
                for k in (1, 15, 128):
                    got = knn_topk_cuda(X, X, ids, ids, k=k, metric=metric)
                    want = kernel_plain_knn(ref, pairwise_dist_cuda, X, X,
                                            ids, ids, k, metric)
                    torch.cuda.synchronize()
                    require(torch.equal(got[0], want[0])
                            and torch.equal(got[1], want[1]),
                            f"knn kernel {metric} n={n} d={d} k={k}: not "
                            "the pairwise kernel's sorted lists")
                    cases += 1
    # query/candidate form: sentinel query ids (the anchored assignment),
    # padded candidates and cells with fewer valid candidates than k
    for metric in ref.METRICS:
        Xq = torch.randn(5000, 8, device="cuda", generator=gen)
        Xc = torch.randn(1000, 8, device="cuda", generator=gen)
        no_id = torch.full((5000,), -1, dtype=torch.int64, device="cuda")
        cid = torch.arange(1000, device="cuda")
        for k in (2, 15):
            got = knn_topk_cuda(Xq, Xc, no_id, cid, k=k, metric=metric)
            want = kernel_plain_knn(ref, pairwise_dist_cuda, Xq, Xc, no_id,
                                    cid, k, metric)
            require(torch.equal(got[0], want[0])
                    and torch.equal(got[1], want[1]),
                    f"knn kernel {metric} query/candidate k={k} differs")
        cell = torch.where(cid[:20] % 3 == 0, -1, cid[:20] * 7)
        qid = torch.arange(5000, device="cuda")
        got = knn_topk_cuda(Xq, Xc[:20], qid, cell, k=15, metric=metric)
        want = kernel_plain_knn(ref, pairwise_dist_cuda, Xq, Xc[:20], qid,
                                cell, 15, metric)
        require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
                and bool((got[1][:, 13:] == -1).all()),
                f"knn kernel {metric}: short cell lists differ")
        blk = knn_topk_blocked(Xq, Xc, no_id, cid, k=15, metric=metric,
                               rows=1024, cols=384)
        got = knn_topk_cuda(Xq, Xc, no_id, cid, k=15, metric=metric)
        require(torch.equal(blk[0], got[0]) and torch.equal(blk[1], got[1]),
                f"knn blocked route {metric} differs from the kernel")
        cases += 5
    # the top of the exact-kNN window, in row blocks
    n, d, k = 32_768, 64, 15
    X = torch.randn(n, d, device="cuda", generator=gen)
    ids = torch.arange(n, device="cuda")
    got = ops.knn_graph(X, k=k)
    want = kernel_plain_knn(ref, pairwise_dist_cuda, X, X, ids, ids, k,
                            "euclidean")
    require(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
            f"knn kernel n={n}: not the pairwise kernel's sorted lists")
    # the plain version on the same card tensors: rows from cuBLAS
    errs = {}
    for metric, Xm in (("euclidean", X), ("sqeuclidean", X[:4099]),
                       ("manhattan", X[:4099]), ("cosine", X[:4099])):
        kd, ki = ops.knn_graph(Xm, k=k, metric=metric)
        pd, pi = ref.knn_graph_ref(Xm, k=k, metric=metric)
        err = float(torch.amax(torch.abs(kd - pd)))
        tol = plain_tolerance(torch, metric, Xm, pd)
        require(err <= tol, f"knn kernel vs plain {metric} n="
                f"{Xm.shape[0]}: {err} > {tol}")
        errs[metric] = {"n": Xm.shape[0], "max_abs_err": err, "tol": tol,
                        "equal_idx_share": float((ki == pi).float().mean())}
    log("knn-kernel", kernel="knn_graph", bitwise_cases=cases,
        bitwise_n32768=True, vs_plain=errs)
    return X, errs["euclidean"]["max_abs_err"]


def phase_approx_exact(torch, rt, ops, build, core):
    """method="approx" at the top of the exact-kNN window, with the flash
    fit of the same points as the exact reference."""
    n, d = 32_768, 64
    X = blobs(n, d, k=8, seed=0)
    reset_counts(build)
    walls = {}
    fa, walls["fit"] = wall_s(torch, lambda: rt.FastVAT(method="approx").fit(X))
    order, walls["order"] = wall_s(torch, fa.order)
    img, walls["image"] = wall_s(torch, fa.image)
    img_iv, walls["image_ivat"] = wall_s(
        torch, lambda: fa.image(use_ivat=True))
    rep, walls["assess"] = wall_s(torch, fa.assess)
    launches = build.launch_counts()
    require_range_route("approx n=32768 band render",
                        launches["ivat_from_vat"])
    s = fa.result.meta.approx
    require(s.mode == "exact" and s.k == 15, f"approx stats {s}")
    for name in ("knn_graph", "pairwise_dist", "vat_prim_order",
                 "ivat_from_vat"):
        require(launches[name] > 0, f"approx-exact did not launch {name}")
    require(launches["masked_argmin"] == 0 and launches["vat_prim_order"] == 1
            and launches["knn_graph"] == 1,
            f"approx-exact launch counts {launches}")
    require(launches["prim_persist"] == 0 == launches["prim_stream_step"],
            f"approx-exact launched a Prim kernel: {launches}")
    require(np.array_equal(np.sort(order), np.arange(n)),
            "approx order is not a permutation")
    require(img.shape == (256, 256) and np.isfinite(img).all()
            and np.isfinite(img_iv).all(), "bad approx image")
    # Borůvka on the card == on the CPU, bit for bit, on the same graph
    Xt = fa._X.float().contiguous()
    dist, idx = ops.knn_graph(Xt, k=15)
    radius = dist.amax(dim=1)
    i0 = int(torch.argmax(radius))
    card, t_card = wall_s(torch, lambda: core.boruvka_mst(idx, dist, X=Xt))
    host, t_host = wall_s(torch, lambda: core.boruvka_mst(
        idx.cpu(), dist.cpu(), X=Xt))
    require(all(np.array_equal(a, b) for a, b in zip(card[0], host[0]))
            and card[1:] == host[1:],
            "Borůvka on the card differs from Borůvka on the CPU")
    require(card[0].src.size == n - 1, "the tree has not n - 1 edges")
    walk, t_walk = wall_s(torch, lambda: core.mst_vat_order(n, card[0], i0))
    require(np.array_equal(walk[0], order),
            "the fit's order is not mst_vat_order of its tree")
    # against the exact MST of a flashvat fit of the same points, in the
    # f64 geometry (the rung's one-sided error model)
    ff, t_flash = wall_s(torch,
                         lambda: rt.FastVAT(method="flashvat").fit(X))
    require(ff.result.meta.numerics == fa.result.meta.numerics,
            "approx and flashvat fits took different numerics plans")
    w_approx = tree_weight(torch, Xt, fa.result.order)
    w_exact = tree_weight(torch, Xt, ff.result.order)
    ratio = w_approx / w_exact
    require(ratio >= 1.0 - EXCESS_F32, f"kNN-MST weight below the exact "
            f"MST: ratio {ratio}")
    frep = ff.assess()
    require(rep.k_est == frep.k_est, f"approx k_est {rep.k_est} != flashvat "
            f"{frep.k_est}")
    log("approx-exact", n=n, d=d, k=15, launches=launches, walls_s=walls,
        stats=vars(s),
        boruvka_card_s=t_card, boruvka_cpu_s=t_host, tree_walk_s=t_walk,
        boruvka_card_equals_cpu=True, flash_fit_s=t_flash,
        tree_weight_ratio=ratio, mst_weight_f32_sum=s.mst_weight,
        k_est=rep.k_est, flash_k_est=frep.k_est,
        same_order_as_flash=bool(np.array_equal(order, ff.order())))
    return launches


def phase_approx_full_k(torch, rt, ref, build):
    """k = n-1: the approx order is exact Prim's, through the kernel
    (n = 129) and the blocked route (n = 1,024), every metric."""
    done = []
    for metric in ref.METRICS:
        for n in (129, 1024):
            X = np.random.default_rng(n).normal(size=(n, 8)).astype(
                np.float32)
            build.reset_launch_counts()
            fa = rt.FastVAT(method="approx", knn_k=n - 1,
                            metric=metric).fit(X)
            knn = build.launch_counts()["knn_graph"]
            require(knn == (1 if n - 1 <= 128 else 0),
                    f"full-k n={n}: {knn} kNN kernel launches")
            ff = rt.FastVAT(method="flashvat", metric=metric).fit(X)
            fv = rt.FastVAT(method="vat", metric=metric).fit(X)
            require(np.array_equal(fa.order(), ff.order())
                    and np.array_equal(fa.order(), fv.order()),
                    f"full-k {metric} n={n}: approx order != exact order")
            done.append(f"{metric}/{n}")
    log("approx-full-k", bitwise=done)


def phase_approx_path(torch, rt, ops, build, core, registry):
    """FastVAT().fit(X) at a million points, auto: the approx rung with the
    anchored kNN; then each stage timed alone on the same data."""
    n, d = 1_000_000, 8
    X, lab = demo_blobs(n)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(build)
    walls = {}
    fv, walls["fit"] = wall_s(torch, lambda: rt.FastVAT().fit(X))
    peak = torch.cuda.max_memory_allocated() - base
    order, walls["order"] = wall_s(torch, fv.order)
    img, walls["image"] = wall_s(torch, fv.image)
    img_iv, walls["image_ivat"] = wall_s(
        torch, lambda: fv.image(use_ivat=True))
    rep, walls["assess"] = wall_s(torch, fv.assess)
    launches = build.launch_counts()
    require_range_route("approx n=1000000 band render",
                        launches["ivat_from_vat"])
    s = fv.result.meta.approx
    require(fv.method_resolved == "approx" and s.mode == "anchored",
            f"auto at n={n}: {fv.method_resolved}, {s}")
    require(launches["knn_graph"] == 1
            and launches["knn_graph_segmented"] == 1
            and launches["pairwise_dist"] > 0
            and launches["vat_prim_order"] == 1
            and launches["masked_argmin"] == 0,
            f"approx path launch counts {launches}: want one assignment "
            "launch and one launch for every anchored cell")
    require(np.array_equal(np.sort(order), np.arange(n)),
            "approx order is not a permutation")
    require(img.shape == (256, 256) and np.isfinite(img).all()
            and np.isfinite(img_iv).all(), "bad approx image")
    # the demo's acceptance: each of the 5 blobs one contiguous run of the
    # order.  assess()'s k_est counts only super-diagonal jumps above half
    # the largest, and two of these centres lie close enough that the
    # reference's own fit reads k_est = 4 here (5 runs).
    runs = 1 + int(np.sum(lab[order][1:] != lab[order][:-1]))
    require(runs == 5 and rep.clustered and 4 <= rep.k_est <= 5,
            f"5 demo blobs gave {runs} runs, {rep}")
    # the stages, each the core function on the fit's own data
    stages = {}
    Xt = fv._X.float().contiguous()
    (dist, idx), stages["anchored_knn_s"] = wall_s(
        torch, lambda: core.knn_graph_anchored(Xt, k=15))
    finite = torch.isfinite(dist) & (idx >= 0)
    i0 = int(torch.argmax(torch.where(finite, dist, -torch.inf).amax(1)))
    rows = torch.arange(n, device=Xt.device)
    idx = torch.where(finite, idx, rows[:, None])
    dist = torch.where(finite, dist, 0.0)
    (tree, passes, ncomp, _), stages["boruvka_s"] = wall_s(
        torch, lambda: core.boruvka_mst(idx, dist, X=Xt))
    require(tree.src.size == n - 1 and ncomp == s.components
            and passes == s.n_passes, "refit tree differs from the fit's")
    (worder, _), stages["tree_walk_s"] = wall_s(
        torch, lambda: core.mst_vat_order(n, tree, i0))
    require(np.array_equal(worder, order), "refit order differs")
    opts = registry.RungOptions(num_form=fv.result.meta.numerics.form)
    order_t = torch.as_tensor(worder.astype(np.int64), device=Xt.device)
    _, stages["band_render_s"] = wall_s(
        torch, lambda: registry._band_render(Xt, order_t, fv.result.meta,
                                             opts))
    log("approx-path", n=n, d=d, k=15, method=fv.method_resolved,
        launches=launches, walls_s=walls, stages_s=stages,
        peak_alloc_mib=peak / 2 ** 20, components=s.components,
        repaired_edges=s.repaired_edges, repair_weight=s.repair_weight,
        n_passes=s.n_passes, mst_weight=s.mst_weight, runs=runs,
        hopkins=rep.hopkins, block_score=rep.block_score, k_est=rep.k_est)
    return launches, Xt


def segmented_cost(cells, d: int, k: int):
    """The cells' queries and candidates read once, the (Q, k) lists
    written once (f32 + int64); one FMA per feature for each query x
    candidate pair of a cell (the pairs of this run's cells)."""
    q = (cells.qoff[1:] - cells.qoff[:-1]).double()
    c = (cells.coff[1:] - cells.coff[:-1]).double()
    nq, nc = int(cells.qoff[-1]), int(cells.coff[-1])
    pairs = float((q * c).sum())
    return 4 * d * (nq + nc) + 12 * k * nq, 2 * d * pairs, pairs


def phase_knn_segmented(torch, ref, core, build, Xt, launches, card):
    """The anchored search's cells, as the approx fit lays them out on the
    million-point input: the segmented launch against the kNN kernel cell
    by cell, bit for bit (every cell for euclidean, one cell in 20 for the
    other metrics) and against the pairwise kernel's sorted rows on a few
    cells; then its time beside its plain version (the kernel's plain
    version cell by cell) and its bound, and the assignment launch's."""
    from repro_torch.kernels.knn_graph import (knn_topk_cuda,
                                              knn_topk_segmented_cuda)
    from repro_torch.kernels.pairwise_dist import pairwise_dist_cuda
    n, d = Xt.shape
    k = 15
    cells = core.anchor_cells(Xt)
    Xq = Xt.index_select(0, cells.query)
    Xc = Xt.index_select(0, cells.members)
    qo, co = cells.qoff.tolist(), cells.coff.tolist()
    c = len(qo) - 1
    checked = {}
    for metric in ("euclidean", "sqeuclidean", "manhattan", "cosine"):
        got = knn_topk_segmented_cuda(Xq, Xc, cells.query, cells.members,
                                      cells.qoff, cells.coff, k=k,
                                      metric=metric)
        step = 1 if metric == "euclidean" else 20
        done = 0
        for g in range(0, c, step):
            q0, q1, c0, c1 = qo[g], qo[g + 1], co[g], co[g + 1]
            if q1 == q0:
                continue
            rows = (got[0][q0:q1], got[1][q0:q1])
            if c1 == c0:
                require(bool(torch.isinf(rows[0]).all()
                             and (rows[1] == -1).all()),
                        f"knn segmented {metric} cell {g}: empty cell rows")
                continue
            want = knn_topk_cuda(Xq[q0:q1], Xc[c0:c1], cells.query[q0:q1],
                                 cells.members[c0:c1], k=min(k, c1 - c0),
                                 metric=metric)
            kk = want[0].shape[1]
            require(torch.equal(rows[0][:, :kk], want[0])
                    and torch.equal(rows[1][:, :kk], want[1])
                    and bool(torch.isinf(rows[0][:, kk:]).all())
                    and bool((rows[1][:, kk:] == -1).all()),
                    f"knn segmented {metric} cell {g}: not the per-cell "
                    "kernel call's lists")
            if metric == "euclidean" and g % 100 == 0:
                plain = kernel_plain_knn(ref, pairwise_dist_cuda, Xq[q0:q1],
                                         Xc[c0:c1], cells.query[q0:q1],
                                         cells.members[c0:c1], k, metric)
                require(torch.equal(rows[0], plain[0])
                        and torch.equal(rows[1], plain[1]),
                        f"knn segmented cell {g}: not the pairwise kernel's "
                        "sorted rows")
            done += 1
        checked[metric] = done
        del got
    nbytes, nops, pairs = segmented_cost(cells, d, k)
    args = (Xq, Xc, cells.query, cells.members, cells.qoff, cells.coff)
    A = Xt.index_select(0, cells.anchors)
    no_id = torch.full((n,), -1, dtype=torch.int64, device="cuda")
    aid = torch.arange(A.shape[0], device="cuda")
    sd, si = knn_topk_segmented_cuda(*args, k=k)
    pd, pi = ref.knn_topk_segmented_ref(*args, k=k)
    err = float(torch.amax(torch.where(torch.isfinite(pd), (sd - pd).abs(),
                                       0.0)))
    tol = plain_tolerance(torch, "euclidean", Xt, pd)
    require(err <= tol, f"knn segmented vs plain: {err} > {tol}")
    # CUDA events around back-to-back calls: torch.profiler has read this
    # launch at a third of its stream time (the wrapper's host sync on the
    # work list seems to cost the profiler events), so the row takes the
    # stream time, the wrapper's aux pre-pass and work list included
    row = {"kernel": "knn_graph_segmented", "n": n, "d": d, "k": k,
           "cells": c, "queries": len(cells.query), "pairs": pairs,
           "ms": event_ms(torch, lambda: knn_topk_segmented_cuda(*args, k=k),
                          reps=3),
           "profiler_ms": device_ms(torch, lambda: knn_topk_segmented_cuda(
               *args, k=k), reps=3, label="knn_graph_segmented"),
           "plain_ms": device_ms(torch, lambda: ref.knn_topk_segmented_ref(
               *args, k=k), reps=1, label="knn_graph_segmented plain"),
           "library_ms": None,
           "assignment_ms": event_ms(torch, lambda: knn_topk_cuda(
               Xt, A, no_id, aid, k=2), reps=3)}
    row["bound_ms"], row["bound_by"] = bound_ms(nbytes, nops)
    a_bytes, a_ops = 4 * d * (n + A.shape[0]) + 24 * n, 2 * d * n * A.shape[0]
    row["assignment_bound_ms"] = bound_ms(a_bytes, a_ops)[0]
    row["anchored_kernel_ms"] = row["ms"] + row["assignment_ms"]
    row["anchored_bound_ms"] = bound_ms(nbytes + a_bytes, nops + a_ops)[0]
    log("knn-segmented", card=card, checked_cells=checked,
        vs_plain_max_abs_err=err, vs_plain_tol=tol, **row)
    return {"name": "knn_graph_segmented", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/knn_graph.cu",
            "replaces": "src/repro/kernels/knn_graph.py:137",
            "launches": launches["knn_graph_segmented"], "max_abs_err": err,
            "ms": row["ms"], "timer": "cuda events",
            "profiler_ms": row["profiler_ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": None,
            "library_ms_why": "no single PyTorch call takes the top-k of "
                              "many independent query x candidate blocks"}


def phase_knn_times(torch, ref, knn_topk_cuda, X, launches, err):
    """The kNN kernel beside its plain version, one library yardstick and
    its bound, at the top of the exact-kNN window (n = 32,768, d = 64,
    k = 15)."""
    n, d = X.shape
    k = 15
    ids = torch.arange(n, device="cuda")

    def library():   # cdist + topk in row blocks; a yardstick only
        out = []
        for r0 in range(0, n, 4096):
            D = torch.cdist(X[r0:r0 + 4096], X)
            rr = torch.arange(D.shape[0], device="cuda")
            D[rr, rr + r0] = torch.inf
            out.append(torch.topk(D, k, largest=False))
        return out

    row = {"kernel": "knn_graph", "n": n, "d": d, "k": k,
           "ms": device_ms(torch, lambda: knn_topk_cuda(X, X, ids, ids, k=k),
                           reps=5, label="knn_graph"),
           "event_ms": event_ms(torch, lambda: knn_topk_cuda(X, X, ids, ids,
                                                             k=k), reps=5),
           "plain_ms": device_ms(torch, lambda: ref.knn_graph_ref(X, k=k),
                                 reps=1, label="knn_graph plain"),
           "library_ms": device_ms(torch, library, reps=2,
                                   label="knn_graph library")}
    row["bound_ms"], row["bound_by"] = bound_ms(*knn_cost(n, d, k))
    log("time", **row)
    return {"name": "knn_graph", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/knn_graph.cu",
            "replaces": "src/repro/kernels/knn_graph.py:137",
            "launches": launches["knn_graph"], "max_abs_err": err,
            "ms": row["ms"], "plain_ms": row["plain_ms"],
            "bound_ms": row["bound_ms"], "bound_by": row["bound_by"],
            "library_ms": row["library_ms"]}


def phase_certify(torch):
    """The port's certification sweep on the card: 4 rungs x 3 conditioned
    metrics x 3 policies x 5 generators, each fit scored against the f64
    naive-Prim oracle."""
    from repro_torch.numerics import certify
    results, wall = wall_s(torch, certify.sweep)
    print(certify.summarize(results), flush=True)
    bad = [r for r in results if not r.ok]
    require(len(results) == 180 and not bad,
            f"certify: {len(bad)} of {len(results)} cells fail")
    log("certify", cells=len(results), ok=len(results) - len(bad),
        exact=sum(r.exact for r in results), wall_s=wall,
        worst_excess={m: max(r.excess for r in results if r.method == m)
                      for m in certify.DEFAULT_METHODS})


def phase_times(torch, ref, kernels, rstars, gen, errs, launches,
                big_launches):
    """Kernel, plain version, library call and bound at both sizes (the
    iVAT op has its own, ``phase_ivat_times``).  ``launches`` are the vat
    fit's counts at n = 2,048, ``big_launches`` the ivat fit's at 16,384.

    ``ms`` / ``plain_ms`` / ``library_ms`` are device times per call
    (``device_ms``); ``event_ms`` beside them is the stream time per call
    in a back-to-back run, host launch overhead included.  The Prim
    kernel's row in the ``kernels`` line takes its ``event_ms``: one
    launch of milliseconds, so launch gaps are nothing, and torch.profiler
    has read such launches well below that stream time, which a single
    launch cannot be."""
    from prim_order_phases import step_floor_us
    from repro_torch.kernels.prim_update import prim_plan
    rows = []
    for n, d in ((2048, 64), (16384, 32)):
        X = torch.randn(n, d, device="cuda", generator=gen)
        vals = torch.rand(n, device="cuda", generator=gen)
        mask = torch.rand(n, device="cuda", generator=gen) < 0.5
        rstar = next(r for r in rstars if r.shape[0] == n)
        i0 = torch.argmax(torch.amax(rstar, dim=1)).view(1)
        big = n > 2048
        cases = {
            "pairwise_dist": (
                lambda: kernels["pairwise_dist"](X),
                lambda: ref.pairwise_dissim_ref(X),
                lambda: torch.cdist(X, X), pairwise_cost(n, None, d), 20),
            "masked_argmin": (
                lambda: kernels["masked_argmin"](vals, mask),
                lambda: ref.masked_argmin_ref(vals, mask),
                lambda: torch.argmin(vals.masked_fill(mask, torch.inf)),
                argmin_cost(n), 200),
            "vat_prim_order": (
                lambda: kernels["vat_prim_order"](rstar, i0),
                lambda: ref.vat_prim_order_ref(rstar, i0), None,
                prim_order_cost(n), 3 if big else 10),
        }
        for name, (kern, plain, lib, cost, reps) in cases.items():
            plain_reps = 1 if name == "vat_prim_order" else reps
            row = {"kernel": name, "n": n,
                   "ms": device_ms(torch, kern, reps=reps,
                                   label=f"{name} n={n}"),
                   "plain_ms": device_ms(torch, plain, reps=plain_reps,
                                         label=f"{name} plain n={n}"),
                   "library_ms": (None if lib is None else device_ms(
                       torch, lib, reps=reps, label=f"{name} library n={n}")),
                   "event_ms": event_ms(torch, kern, reps=reps),
                   "plain_event_ms": event_ms(torch, plain,
                                              reps=plain_reps, warmup=1)}
            row["bound_ms"], row["bound_by"] = bound_ms(*cost)
            if name == "pairwise_dist":
                row["d"] = d
            if name == "vat_prim_order":
                row["cluster"], row["threads"], row["bulk"] = prim_plan(n)
                row["us_a_step"] = 1e3 * row["event_ms"] / (n - 1)
                row["step_floor_us"] = step_floor_us(
                    torch, n, row["cluster"], row["threads"])
            log("time", **row)
            rows.append(row)
    # row 1 at the flashvat seed scan's block (25 x 7 of them a fit at
    # n = 50,000): two operands, (2,000 x 7,143, d = 64)
    n, m, d = 2000, 7143, 64
    X = torch.randn(n, d, device="cuda", generator=gen)
    Y = torch.randn(m, d, device="cuda", generator=gen)
    kern = lambda: kernels["pairwise_dist"](X, Y)   # noqa: E731
    plain = lambda: ref.pairwise_dissim_ref(X, Y)   # noqa: E731
    block = {"kernel": "pairwise_dist", "n": n, "m": m, "d": d,
             "ms": device_ms(torch, kern, reps=20,
                             label="pairwise_dist seed block"),
             "plain_ms": device_ms(torch, plain, reps=20,
                                   label="pairwise_dist plain seed block"),
             "library_ms": device_ms(torch, lambda: torch.cdist(X, Y),
                                     reps=20,
                                     label="pairwise_dist cdist seed block"),
             "event_ms": event_ms(torch, kern, reps=20),
             "plain_event_ms": event_ms(torch, plain, reps=20, warmup=1)}
    block["bound_ms"], block["bound_by"] = bound_ms(*pairwise_cost(n, m, d))
    log("time", **block)
    rows.append(block)
    meta = {
        "pairwise_dist": ("src/repro_torch/kernels/csrc/pairwise_dist.cu",
                          "src/repro/kernels/pairwise_dist.py:120"),
        "masked_argmin": ("src/repro_torch/kernels/csrc/prim_update.cu",
                          "src/repro/kernels/prim_update.py:39"),
        # the whole loop of masked_argmin_pallas steps the reference's
        # vat_order runs, in one launch
        "vat_prim_order": ("src/repro_torch/kernels/csrc/prim_update.cu",
                           "src/repro/kernels/prim_update.py:39"),
    }
    out = []
    # the Prim kernel has a row at each n: 2,048 (R in L2) and 16,384 (R
    # from HBM), each with its cluster size and step floor
    for name, n in (*((k, 2048) for k in meta), ("vat_prim_order", 16384)):
        source, replaces = meta[name]
        row = next(r for r in rows if r["kernel"] == name and r["n"] == n)
        timer = "cuda events" if name == "vat_prim_order" else "profiler"
        out.append({"name": name, "route": "cuda", "source": source,
                    "replaces": replaces,
                    "launches": (big_launches if n == 16384
                                 else launches)[name],
                    "max_abs_err": errs[name],
                    "ms": row["event_ms" if timer == "cuda events" else "ms"],
                    "timer": timer, "profiler_ms": row["ms"],
                    "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                    "bound_by": row["bound_by"],
                    "library_ms": row["library_ms"]})
        if name == "vat_prim_order":
            out[-1].update({k: row[k] for k in (
                "n", "cluster", "threads", "bulk", "us_a_step",
                "step_floor_us")})
        if name == "pairwise_dist":
            shapes = {f"{r['n']}x{r.get('m') or r['n']}x{r['d']}": r
                      for r in rows if r["kernel"] == name}
            out[-1]["ms_by_shape"] = {k: r["ms"] for k, r in shapes.items()}
            out[-1]["bound_ms_by_shape"] = {k: r["bound_ms"]
                                            for k, r in shapes.items()}
        if name == "masked_argmin":
            out[-1]["launches_why"] = (
                "off the main path: vat_prim_order runs the Prim loop that "
                "called it once a step; still held against its plain version")
    return out


# ------------------------------- bigvat, streaming, the paper's evaluation ----

#: DBSCAN radius and k-means k per dataset of the paper tables, copied from
#: the reference's benchmarks/vat_tables.py (``_EPS``, ``_K``).
PAPER_EPS = {"iris": 0.6, "mall": 10.0, "spotify": 1.6, "blobs": 0.8,
             "moons": 0.12, "circles": 0.12, "gmm": 0.45}
PAPER_K = {"iris": 3, "mall": 5, "spotify": 4, "blobs": 3, "moons": 2,
           "circles": 2, "gmm": 3}


def phase_bigvat_path(torch, rt, ref, ops, build, core, card):
    """``FastVAT(method="bigvat").fit(X)`` at a million points (the
    reference's ``make_big_blobs``: 5 blobs, d = 8, seed 0), then
    ``order()``, ``image()``, ``image(use_ivat=True)``, ``assess()``.  The
    assignment pass (one pairwise launch a 4,096-row block) is held bit for
    bit against one (n, 256) call, and against the plain version outside
    the near-tie band; the block is timed for the ``kernels`` line."""
    from repro_torch.data.synth import make_big_blobs
    n, d, k, block = 1_000_000, 8, 5, 4096
    X, lab = make_big_blobs(n=n, k=k, d=d, seed=0)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(build)
    walls = {}
    fv, walls["fit"] = wall_s(torch,
                              lambda: rt.FastVAT(method="bigvat").fit(X))
    peak = torch.cuda.max_memory_allocated() - base
    launches = build.launch_counts()
    routes = require_range_route("bigvat n=1000000 sample iVAT", 1)
    order, walls["order"] = wall_s(torch, fv.order)
    img, walls["image"] = wall_s(torch, fv.image)
    img_iv, walls["image_ivat"] = wall_s(
        torch, lambda: fv.image(use_ivat=True))
    rep, walls["assess"] = wall_s(torch, fv.assess)
    res = fv.result
    blocks = -(-n // block)
    require(fv.method_resolved == "bigvat"
            and res.meta.device.startswith("cuda"),
            f"bigvat fit: {fv.method_resolved} on {res.meta.device}")
    require(launches["pairwise_dist"] == blocks + 1
            and launches["ivat_from_vat"] == 1
            and launches["vat_prim_order"] == 1
            and launches["masked_argmin"] == 0,
            f"bigvat launch counts {launches}: want {blocks} assignment "
            "blocks + 1 sample matrix, one Prim and one iVAT launch")
    require(np.array_equal(np.sort(order), np.arange(n)),
            "bigvat order is not a permutation")
    sizes = res.group_sizes
    require(sizes.shape == (256,) and int(sizes.sum()) == n,
            f"group sizes {tuple(sizes.shape)} sum to {int(sizes.sum())}")
    require(rep.k_est == k and rep.clustered,
            f"{k} blobs gave k_est={rep.k_est}, clustered={rep.clustered}")
    require(img.shape == (256, 256) and img_iv.shape == (256, 256)
            and np.isfinite(img).all() and np.isfinite(img_iv).all()
            and bool((img_iv <= img).all()), "bad bigvat images")
    runs = 1 + int(np.sum(lab[order][1:] != lab[order][:-1]))
    # a second fit (the first paid one-time costs), then the stages, each
    # the core function on the fit's own data
    _, walls["fit_again"] = wall_s(
        torch, lambda: rt.FastVAT(method="bigvat").fit(X))
    from repro_torch.api.validation import validate_points
    from repro_torch.numerics import resolve
    stages = {}
    t0 = time.perf_counter()
    validate_points(X)
    resolve(X, metric="euclidean")
    stages["host_prepass"] = time.perf_counter() - t0
    Xt = fv._X
    sample, stages["svat_sample"] = wall_s(
        torch, lambda: core.svat_from(Xt, res.sample_idx[0], s=256))
    require(torch.equal(sample.sample_idx, res.sample_idx),
            "the sample refit differs from the fit's")
    P = Xt.index_select(0, res.sample_idx)
    (labels, dists), stages["assign_pass"] = wall_s(
        torch, lambda: core.nearest_prototype_assign(Xt, P, block=block))
    # the block loop against one (n, 256) call of the same kernel
    D = ops.pairwise_dist(Xt, P)                       # (n, 256), 1 GB
    mind, lab_one = torch.min(D, dim=1)
    require(torch.equal(res.extension_labels, lab_one)
            and torch.equal(labels, lab_one) and torch.equal(dists, mind),
            "the assignment blocks differ from one (n, 256) call")
    # against the plain version: equal labels outside the near-tie band,
    # where the squared distances to the two nearest prototypes lie within
    # twice the bound on a gram entry's d^2 (a flip needs both entries off
    # by that much in opposite directions); the band must hold few points
    err_sq = 16 * F32_EPS * float(torch.amax(torch.sum(Xt * Xt, 1)))
    two = torch.topk(D, 2, dim=1, largest=False).values.double()
    near = (two[:, 1] ** 2 - two[:, 0] ** 2) <= 2 * err_sq
    del D, two
    n_near = int(near.sum())
    require(n_near <= n // 100,
            f"{n_near} of {n} points in the near-tie band (over 1 %)")
    lab_plain = torch.argmin(ref.pairwise_dissim_ref(Xt, P), dim=1)
    differ = lab_plain != lab_one
    require(not bool((differ & ~near).any()),
            f"{int((differ & ~near).sum())} labels differ from the plain "
            "version outside the near-tie band")
    # the assignment block: kernel, plain version, cdist, bound
    blk = Xt[:block]
    kern = lambda: ops.pairwise_dist(blk, P)                # noqa: E731
    plain = lambda: ref.pairwise_dissim_ref(blk, P)         # noqa: E731
    row = {"n": block, "m": 256, "d": d, "launches": blocks,
           "ms": device_ms(torch, kern, reps=50,
                           label="pairwise_dist assignment block"),
           "plain_ms": device_ms(torch, plain, reps=50,
                                 label="pairwise_dist plain assignment"),
           "library_ms": device_ms(torch, lambda: torch.cdist(blk, P),
                                   reps=50,
                                   label="pairwise_dist cdist assignment"),
           "event_ms": event_ms(torch, kern, reps=50)}
    row["bound_ms"], row["bound_by"] = bound_ms(*pairwise_cost(block, 256, d))
    log("time", kernel="pairwise_dist", **row)
    log("bigvat-path", n=n, d=d, k=k, block=block, card=card,
        method=fv.method_resolved, launches=launches, ivat_routes=routes,
        walls_s=walls, stages_s=stages, peak_alloc_mib=peak / 2 ** 20,
        runs=runs,
        hopkins=rep.hopkins, block_score=rep.block_score, k_est=rep.k_est,
        near_tie_points=n_near, near_tie_bound_sq=2 * err_sq,
        labels_differ_from_plain=int(differ.sum()),
        blocks_equal_one_call=True)
    return fv, X, row


def phase_bigvat_memmap(torch, rt, fv, X):
    """The same points from an np.memmap under the git-ignored build
    directory (deleted after): the fit copies them to the card once and
    skips the numerics pre-pass; order, labels and group sizes are the
    ndarray fit's bit for bit."""
    path = os.path.join(ROOT, "build", "smoke", "bigvat_points.f32")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    try:
        mm = np.memmap(path, dtype=np.float32, mode="w+", shape=X.shape)
        mm[:] = X
        mm.flush()
        del mm
        ro = np.memmap(path, dtype=np.float32, mode="r", shape=X.shape)
        fm, wall = wall_s(torch, lambda: rt.FastVAT(method="bigvat").fit(ro))
        del ro
    finally:
        os.remove(path)
    a, b = fm.result, fv.result
    require(a.meta.numerics is None, "memmap input went through the "
            "numerics pre-pass")
    same = {f: bool(torch.equal(getattr(a, f), getattr(b, f)))
            for f in ("order", "extension_labels", "group_sizes",
                      "sample_idx")}
    require(all(same.values()), f"memmap fit differs from the ndarray "
            f"fit: {same}")
    log("bigvat-memmap", n=X.shape[0], fit_wall_s=wall, equal=same)


def phase_streaming(torch, core):
    """``StreamingVAT(cap=256, d=8)`` (the reference docstring's example)
    takes 2,000 points in 200-point chunks: one blob (4 chunks), then three
    more (2 chunks each).  ``order()`` == ``core.vat`` of the reservoir on
    the card, bit for bit.  A single blob has no block structure, so its
    k_est counts noise; the stream must read unclustered (block score <
    0.3) on it, then clustered, with k_est rising from the second blob's
    reading to 4 at the end."""
    from repro_torch.core.streaming import StreamingVAT
    rng = np.random.default_rng(0)
    centers = rng.normal(scale=8.0, size=(4, 8))
    chunks = [centers[c] + rng.normal(size=(200, 8))
              for c in (0, 0, 0, 0, 1, 1, 2, 2, 3, 3)]
    sv = StreamingVAT(cap=256, d=8)
    ingest_s, query_s, trail = 0.0, [], []
    for chunk in chunks:
        t0 = time.perf_counter()
        sv.update(chunk)
        ingest_s += time.perf_counter() - t0
        rep, q = wall_s(torch, sv.tendency)
        query_s.append(q)
        trail.append(rep)
    order, order_s = wall_s(torch, sv.order)
    want = core.vat(torch.from_numpy(sv.pts).cuda()).order.cpu().numpy()
    require(np.array_equal(order, want),
            "StreamingVAT order differs from core.vat of its reservoir")
    s_one, k_two = trail[3][1], trail[5][2]
    s_end, k_end = trail[-1][1], trail[-1][2]
    require(s_one < 0.3 and s_end > 0.5 and 2 <= k_two < k_end == 4,
            f"stream tendency trail (hopkins, score, k_est): {trail}")
    log("streaming", cap=256, d=8, n_seen=sv.n_seen, reservoir=len(sv.pts),
        absorbed=int(sv.counts.sum()), ingest_host_s=ingest_s,
        query_s=query_s, order_s=order_s,
        trail=[{"hopkins": h, "block_score": s, "k_est": k}
               for h, s, k in trail])


def phase_paper_eval(torch, rt, core):
    """Tables 2 and 3 of the paper on the card, over the seven datasets:
    vat and ivat (``FastVAT(method="ivat")``), Hopkins, block score and
    k_est; k-means and DBSCAN ARI against the labels, each also run on the
    CPU from the same start (ARI >= 0.99 between them); PCA's variances
    against the CPU's; the reference tests' bars; then t-SNE on the two
    cases of ``tests/test_tsne.py``."""
    from repro_torch.data.synth import DATASETS, make_dataset
    rows = {}
    for name in DATASETS:
        X, y = make_dataset(name)
        fv, wall = wall_s(torch, lambda: rt.FastVAT(method="ivat").fit(X))
        rep = fv.assess()
        iv, rstar = fv.result.ivat_image, fv.result.rstar
        require(bool(torch.isfinite(iv).all()) and bool((iv <= rstar).all()),
                f"{name}: bad iVAT image")
        Xc, Xh = torch.from_numpy(X).cuda(), torch.from_numpy(X)
        i0 = torch.randint(0, len(X), (), device="cuda", generator=torch.
                           Generator(device="cuda").manual_seed(0))
        km = core.kmeans_from(Xc, i0, k=PAPER_K[name])[0]
        km_cpu = core.kmeans_from(Xh, int(i0), k=PAPER_K[name])[0]
        db = core.dbscan(Xc, eps=PAPER_EPS[name])
        db_cpu = core.dbscan(Xh, eps=PAPER_EPS[name])
        agree = (core.adjusted_rand_index(km, km_cpu),
                 core.adjusted_rand_index(db, db_cpu))
        require(km.is_cuda and db.is_cuda and min(agree) >= 0.99,
                f"{name}: card vs CPU ARI (kmeans, dbscan) {agree}")
        var = torch.var(core.pca(Xc), dim=0).cpu().double().numpy()
        var_cpu = torch.var(core.pca(Xh), dim=0).double().numpy()
        require(var[0] >= var[1] and np.allclose(var, var_cpu, rtol=1e-3),
                f"{name}: PCA variances {var} vs CPU {var_cpu}")
        rows[name] = {
            "n": len(X), "d": X.shape[1], "fit_wall_s": wall,
            "hopkins": rep.hopkins, "block_score": rep.block_score,
            "k_est": rep.k_est,
            "kmeans_ari": (None if y is None
                           else core.adjusted_rand_index(km, y)),
            "dbscan_ari": (None if y is None
                           else core.adjusted_rand_index(db, y)),
            "kmeans_card_vs_cpu_ari": agree[0],
            "dbscan_card_vs_cpu_ari": agree[1]}
        log("paper-eval", dataset=name, **rows[name])
    require(rows["blobs"]["kmeans_ari"] > 0.95,
            f"blobs k-means ARI {rows['blobs']['kmeans_ari']}")
    require(rows["circles"]["dbscan_ari"] > 0.95
            > rows["circles"]["kmeans_ari"] + 0.5,
            f"circles: {rows['circles']}")
    require(rows["moons"]["dbscan_ari"] > 0.9, f"moons: {rows['moons']}")
    # t-SNE: separates two clusters, shows no structure on spotify
    rng = np.random.default_rng(0)
    X2 = torch.from_numpy(np.concatenate([
        rng.normal(scale=0.3, size=(40, 10)),
        rng.normal(scale=0.3, size=(40, 10)) + 4.0]).astype(np.float32)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    Y, wall2 = wall_s(torch, lambda: core.tsne(X2, gen, perplexity=15.0,
                                               iters=300))
    a, b = Y[:40].cpu().numpy(), Y[40:].cpu().numpy()
    gap2 = float(np.linalg.norm(a.mean(0) - b.mean(0)))
    spread2 = float(max(a.std(), b.std()))
    require(bool(torch.isfinite(Y).all()) and gap2 > 2.0 * spread2,
            f"t-SNE two clusters: gap {gap2}, spread {spread2}")
    Xs = torch.from_numpy(make_dataset("spotify")[0][:150]).cuda()
    Ys, wall_s2 = wall_s(torch, lambda: core.tsne(
        Xs, torch.Generator(device="cuda").manual_seed(0), perplexity=20.0,
        iters=250))
    lab = core.kmeans(Ys, torch.Generator(device="cuda").manual_seed(1),
                      k=2)[0].cpu().numpy()
    Yn = Ys.cpu().numpy()
    a, b = Yn[lab == 0], Yn[lab == 1]
    gap_s = float(np.linalg.norm(a.mean(0) - b.mean(0)))
    spread_s = float(max(a.std(), b.std()))
    require(gap_s < 4.0 * spread_s,
            f"t-SNE on spotify: gap {gap_s}, spread {spread_s}")
    log("paper-eval", tsne_two_clusters={"gap": gap2, "spread": spread2,
                                         "wall_s": wall2},
        tsne_spotify={"gap": gap_s, "spread": spread_s, "wall_s": wall_s2})


def phase_cluster_scale(torch, core, build):
    """One timed run of each evaluation tool at a size an analyst would
    call real: k-means (k = 8, 50 iterations) and DBSCAN at n = 16,384,
    d = 32, t-SNE (500 iterations) at n = 8,192, d = 32; 8 blobs each."""
    from repro_torch.core.cluster import _dbscan
    out = {}

    def timed(label, fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        build.reset_launch_counts()
        res, wall = wall_s(torch, fn)
        out[label] = {"wall_s": wall,
                      "peak_alloc_mib": (torch.cuda.max_memory_allocated()
                                         - base) / 2 ** 20,
                      "pairwise_launches":
                          build.launch_counts()["pairwise_dist"]}
        return res

    n, d, k = 16_384, 32, 8
    truth = np.repeat(np.arange(k), -(-n // k))[:n]
    X = torch.from_numpy(blobs(n, d, k=k, seed=3)).cuda()
    labels, _, inertia = timed("kmeans", lambda: core.kmeans(
        X, torch.Generator(device="cuda").manual_seed(0), k=k, iters=50))
    (db, sweeps) = timed("dbscan", lambda: _dbscan(X, 8.0, 5))
    out["kmeans"]["ari"] = core.adjusted_rand_index(labels, truth)
    out["dbscan"].update(ari=core.adjusted_rand_index(db, truth),
                         sweeps=sweeps, eps=8.0,
                         noise=int((db < 0).sum()))
    require(out["kmeans"]["pairwise_launches"] == 51
            and out["dbscan"]["pairwise_launches"] == 1,
            f"cluster-scale pairwise launches {out}")
    require(out["kmeans"]["ari"] >= 0.99 and out["dbscan"]["ari"] >= 0.99
            and bool(torch.isfinite(inertia)),
            f"cluster-scale k-means / DBSCAN on 8 blobs: {out}")
    nt = 8_192
    Xt = torch.from_numpy(blobs(nt, d, k=k, seed=4)).cuda()
    Y = timed("tsne", lambda: core.tsne(
        Xt, torch.Generator(device="cuda").manual_seed(0), iters=500))
    require(Y.shape == (nt, 2) and bool(torch.isfinite(Y).all())
            and out["tsne"]["pairwise_launches"] == 1,
            f"t-SNE at n={nt}: {tuple(Y.shape)}, {out['tsne']}")
    truth_t = np.repeat(np.arange(k), -(-nt // k))[:nt]
    out["tsne"]["kmeans_on_embedding_ari"] = core.adjusted_rand_index(
        core.kmeans(Y, torch.Generator(device="cuda").manual_seed(0),
                    k=k)[0], truth_t)
    log("cluster-scale", n=n, d=d, tsne_n=nt, **out)


def phase_fault_site(torch, ops):
    """``kernels.dispatch`` armed around one ``ops.pairwise_dist`` on the
    card: FaultInjected, with the reference's context keys; after
    ``disarm_all()`` the same call runs."""
    from repro_torch import faults
    X = torch.randn(512, 8, device="cuda")
    seen = []
    faults.disarm_all()
    faults.arm("kernels.dispatch",
               match=lambda ctx: seen.append(dict(ctx)) or True)
    try:
        ops.pairwise_dist(X)
        raised = None
    except faults.FaultInjected as exc:
        raised = exc.site
    finally:
        faults.disarm_all()
    R = ops.pairwise_dist(X)
    torch.cuda.synchronize()
    require(raised == "kernels.dispatch" and len(seen) == 1
            and seen[0]["use_pallas"] is True
            and seen[0]["op"] == "pairwise_dist",
            f"armed kernels.dispatch: raised {raised}, contexts {seen}")
    require(R.shape == (512, 512) and not faults.armed(),
            "the disarmed call failed")
    log("fault-site", raised=raised, context=seen[0], after_disarm="ran")


# ------------------------------------------------------- batched fits ----

def check_batch_kernels(torch, ref, gen, card):
    """The batched kernels and the two lane axes against their plain
    versions and, lane by lane, against the single kernels, bit for bit, at
    the batched paths' shapes (fit_many's (8, 2,048, 64) matrices and
    (b, 256) renders, the stepwise engine's (4, 50,000, 64) step)."""
    from repro_torch.kernels.pairwise_dist import (pairwise_dist_batch_cuda,
                                                  pairwise_dist_cuda)
    from repro_torch.core.vat import PERSIST_PRUNE
    from repro_torch.kernels.prim_persist import (persist_plan,
                                                 prim_persist_cuda)
    from repro_torch.kernels.prim_stream import (prim_stream_step_batch_cuda,
                                                prim_stream_step_cuda)
    from repro_torch.kernels.prim_update import masked_argmin_cuda
    from repro_torch.kernels import ops
    from repro_torch.core.vat import _streamed_seed_pivot
    errs = {}
    worst = 0.0
    for b, n, d in ((8, 2048, 64), (4, 256, 64), (3, 2047, 3)):
        X = torch.randn(b, n, d, device="cuda", generator=gen)
        for dtype in (torch.float32, torch.bfloat16):
            Xc = X.to(dtype)
            sq_max = float(torch.amax(torch.sum(Xc.float() ** 2, dim=-1)))
            for metric in ref.METRICS:
                for form in ("gram", "direct"):
                    K = pairwise_dist_batch_cuda(Xc, metric=metric,
                                                 form=form)
                    P = ref.pairwise_dissim_batch_ref(Xc, metric=metric,
                                                      form=form)
                    torch.diagonal(P, dim1=-2, dim2=-1).zero_()
                    err = float(torch.amax(torch.abs(K - P)))
                    if metric == "euclidean" and form == "gram":
                        tol = (16 * F32_EPS * sq_max) ** 0.5
                    else:
                        tol = 1e-5 * float(torch.amax(torch.abs(P))) + 1e-6
                    worst = max(worst, err)
                    require(err <= tol, f"pairwise_dist_batch {metric}/"
                            f"{form} {(b, n, d)} {dtype}: err {err} > {tol}")
                    require(not bool(torch.diagonal(K, dim1=1, dim2=2).any()),
                            "pairwise_dist_batch diagonal is not zero")
                    for z in range(b):
                        S = pairwise_dist_cuda(Xc[z], metric=metric,
                                               form=form)
                        S.fill_diagonal_(0.0)
                        require(torch.equal(K[z], S), f"pairwise_dist_batch "
                                f"lane {z} {metric}/{form} {(b, n, d)} "
                                f"{dtype} != the single kernel's matrix")
    errs["pairwise_dist_batch"] = worst
    log("kernel-check", card=card, kernel="pairwise_dist_batch",
        max_abs_err=worst,
        shapes=[[8, 2048, 64], [4, 256, 64], [3, 2047, 3]],
        lanes_equal_single_kernel=True)

    for b, n in ((8, 2048), (4, 256), (3, 20000)):
        vals = torch.randint(-20, 50, (b, n), device="cuda",
                             generator=gen).float()     # many ties
        mask = torch.rand(b, n, device="cuda", generator=gen) < 0.5
        mask[-1] = True                                 # a fully masked lane
        kv, ki = masked_argmin_cuda(vals, mask)
        pv, pi = ref.masked_argmin_ref(vals, mask)
        require(torch.equal(ki, pi) and torch.equal(kv, pv),
                f"masked_argmin {(b, n)}: kernel != plain")
        for z in range(b):
            sv, si = masked_argmin_cuda(vals[z], mask[z])
            require(int(si) == int(ki[z]) and torch.equal(sv, kv[z]),
                    f"masked_argmin lane {z} of {(b, n)} != single launch")
    log("kernel-check", card=card, kernel="masked_argmin", lane_axis=True,
        shapes=[[8, 2048], [4, 256], [3, 20000]], bitwise=True)

    b, n, d = 4, 50_000, 64
    X = torch.randn(b, n, d, device="cuda", generator=gen)
    step_err = 0.0
    for metric in ref.METRICS:
        for form in ("gram", "direct"):
            aux = ops.metric_aux(X, metric=metric)
            mind = torch.rand(b, n, device="cuda", generator=gen) * 50.0
            sel = torch.rand(b, n, device="cuda", generator=gen) < 0.5
            q = torch.randint(0, n, (b,), device="cuda", generator=gen)
            want, _, _ = ref.prim_stream_step_batch_ref(
                X, aux, q, mind.clone(), sel, metric=metric, form=form)
            solo = [prim_stream_step_cuda(X[z], aux[z], q[z:z + 1],
                                          mind[z].clone(), sel[z],
                                          metric=metric, form=form)
                    for z in range(b)]
            got, ev, nq = prim_stream_step_batch_cuda(
                X, aux, q, mind, sel, metric=metric, form=form)
            err = float(torch.amax(torch.abs(got - want)))
            tol = plain_tolerance(torch, metric, X.view(b * n, d), want) \
                if form == "gram" else \
                1e-5 * float(torch.amax(torch.abs(want))) + 1e-6
            pv, pi = ref.masked_argmin_ref(got, sel)
            require(err <= tol and torch.equal(nq, pi) and torch.equal(ev, pv),
                    f"prim_stream_step_batch {metric}/{form}: err {err} "
                    f"(tol {tol}) or its pairs differ from the plain argmin")
            for z, (sm, se, sq) in enumerate(solo):
                require(torch.equal(got[z], sm) and torch.equal(ev[z], se)
                        and int(nq[z]) == int(sq),
                        f"prim_stream_step_batch lane {z} {metric}/{form} "
                        "!= the single step kernel")
            if metric == "euclidean" and form == "gram":
                step_err = err
    errs["prim_stream_step_batch"] = step_err
    log("kernel-check", card=card, kernel="prim_stream_step_batch", b=b,
        n=n, d=d,
        max_abs_err=step_err, pairs_bitwise=True,
        lanes_equal_single_kernel=True)

    b, n = 4, 4096
    Xp = torch.from_numpy(np.stack([blobs(n, 64, k=8, seed=s)
                                    for s in range(b)])).cuda()
    for metric in ref.METRICS:
        aux = ops.metric_aux(Xp, metric=metric)
        i0 = torch.stack([_streamed_seed_pivot(x, metric=metric)
                          for x in Xp])
        for prune in (True, False):
            order, edges, stats = prim_persist_cuda(Xp, aux, i0,
                                                    metric=metric,
                                                    prune=prune)
            for z in range(b):
                so, se, ss = prim_persist_cuda(Xp[z], aux[z], i0[z],
                                               metric=metric, prune=prune)
                require(torch.equal(order[z], so) and torch.equal(
                    edges[z], se) and torch.equal(stats[z], ss),
                    f"prim_persist lane {z} {metric} prune={prune} != a "
                    "single launch")
    aux = ops.metric_aux(Xp)
    i0 = torch.stack([_streamed_seed_pivot(x, metric="euclidean")
                      for x in Xp])
    order, _, _ = prim_persist_cuda(Xp, aux, i0)
    porder, _ = ref.prim_persist_batch_ref(Xp, aux, i0)
    excess = max(abs(tree_weight(torch, Xp[z], order[z])
                     - tree_weight(torch, Xp[z], porder[z]))
                 / tree_weight(torch, Xp[z], porder[z]) for z in range(b))
    require(excess <= EXCESS_F32, f"prim_persist lanes vs plain: tree "
            f"weight excess {excess} > {EXCESS_F32}")
    groups = {"lanes": persist_plan(b, n, 64)["group"],
              "solo": persist_plan(1, n, 64)["group"]}
    # more lanes than co-resident CTAs: groups of one CTA, a plain launch
    # whose exchange is the CTA's own barrier, against solo groups
    b1, n1, d1, blk1 = 600, 300, 8, 32
    plan1 = persist_plan(b1, n1, d1, block=blk1)
    require(plan1["group"] == 1, f"b={b1} lanes gave {plan1}, want G = 1")
    X1 = torch.from_numpy(np.stack([blobs(n1, d1, k=4, seed=s)
                                    for s in range(b1)])).cuda()
    aux = ops.metric_aux(X1)
    i0 = torch.stack([_streamed_seed_pivot(x, metric="euclidean")
                      for x in X1])
    order, edges, stats = prim_persist_cuda(X1, aux, i0, block=blk1,
                                            prune=PERSIST_PRUNE)
    for z in range(b1):
        so, se, ss = prim_persist_cuda(X1[z], aux[z], i0[z], block=blk1,
                                       prune=PERSIST_PRUNE)
        require(torch.equal(order[z], so) and torch.equal(edges[z], se)
                and torch.equal(stats[z], ss),
                f"prim_persist G = 1 lane {z} != its solo launch")
    groups["g1_lanes"] = 1
    groups["g1_solo"] = persist_plan(1, n1, d1, block=blk1)["group"]
    log("kernel-check", card=card, kernel="prim_persist", lane_axis=True,
        b=b, n=n,
        lanes_equal_single_launch=["pruned", "eager"],
        plain_tree_weight_rel_excess=excess, groups=groups,
        group_of_one={"b": b1, "n": n1, "d": d1, "block": blk1,
                      "lanes_equal_single_launch": True})
    return errs


def phase_batch_vat(torch, rt, ops, build, card):
    """FastVAT().fit_many(Xs) at the top of the batched vat window (b = 8,
    n = 2,048, d = 64), then method="ivat" and metric="precomputed" on the
    same stack; every lane against its solo fit, bit for bit."""
    b, n, d = 8, 2048, 64
    Xs = np.stack([blobs(n, d, k=8, seed=s) for s in range(b)])
    reset_counts(build)
    walls = {}
    fv, walls["fit"] = wall_s(torch, lambda: rt.FastVAT().fit_many(Xs))
    order, walls["order"] = wall_s(torch, fv.order)
    img, walls["image"] = wall_s(torch, fv.image)
    img_iv, walls["image_ivat"] = wall_s(
        torch, lambda: fv.image(use_ivat=True))
    reps, walls["assess"] = wall_s(torch, fv.assess)
    launches = build.launch_counts()
    require_range_route("vat fit_many b=8 image(use_ivat=True)", b)
    _, walls["fit_again"] = wall_s(torch, lambda: rt.FastVAT().fit_many(Xs))
    require(fv.method_resolved == "vat" and fv.batched,
            f"auto fit_many picked {fv.method_resolved!r} at n={n}")
    require(fv.result.meta.device.startswith("cuda"), "fit did not run on cuda")
    require(launches["pairwise_dist_batch"] == 1
            and launches["vat_prim_order"] == 1
            and launches["masked_argmin"] == 0
            and launches["ivat_from_vat"] == 1
            and launches["prim_persist"] == launches["prim_stream_step"]
            == launches["prim_stream_step_batch"] == 0
            and launches["knn_graph"] == launches["knn_graph_batch"] == 0,
            f"batch-vat launch counts {launches}")
    require(order.shape == (b, n) and img.shape == (b, n, n)
            and np.isfinite(img).all() and np.isfinite(img_iv).all(),
            "bad batched images")
    require(np.array_equal(img_iv, np.swapaxes(img_iv, 1, 2))
            and not np.diagonal(img_iv, axis1=1, axis2=2).any()
            and bool((img_iv <= img).all()),
            "batched iVAT images not symmetric, zero-diagonal, below VAT")
    require([r.batch_index for r in reps] == list(range(b))
            and all(r.k_est == 8 and r.clustered and 0 < r.hopkins < 1
                    for r in reps), f"batched reports {reps}")
    # a batched Prim step costs the launches of one solo step, not b times
    from torch.profiler import ProfilerActivity, profile
    kernels = {}
    for label, fit in (("solo", lambda: rt.FastVAT().fit(Xs[0])),
                       ("batched", lambda: rt.FastVAT().fit_many(Xs))):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fit()
            torch.cuda.synchronize()
        kernels[label] = device_launches(prof)
    require(kernels["batched"] <= kernels["solo"] * 1.05 + 64,
            f"the batched vat fit ran {kernels['batched']} device "
            f"operations, a solo fit {kernels['solo']}: a Prim step should "
            "cost the same")
    solo_s = 0.0
    for z in range(b):
        s, w = wall_s(torch, lambda: rt.FastVAT().fit(Xs[z]))
        solo_s += w
        srep = s.assess()
        require(np.array_equal(order[z], s.order())
                and torch.equal(fv.result.rstar[z], s.result.rstar)
                and np.array_equal(img_iv[z], s.image(use_ivat=True))
                and (reps[z].block_score, reps[z].k_est)
                == (srep.block_score, srep.k_est),
                f"batch-vat lane {z} differs from its solo fit")
    reset_counts(build)
    fi, wall_ivat = wall_s(torch,
                           lambda: rt.FastVAT(method="ivat").fit_many(Xs))
    ivat_launches = build.launch_counts()
    require_range_route("ivat fit_many b=8", b)
    require(ivat_launches["pairwise_dist_batch"] == 1
            and ivat_launches["vat_prim_order"] == 1
            and ivat_launches["masked_argmin"] == 0
            and ivat_launches["ivat_from_vat"] == 1,
            f"ivat fit_many launch counts {ivat_launches}")
    require(np.array_equal(fi.order(), order)
            and np.array_equal(fi.image(), img_iv),
            "ivat fit_many differs from the vat fit_many's iVAT images")
    Ds = ops.pairwise_dist_batch(
        fv._X, form=fv.result.meta.numerics.form).cpu().numpy()
    reset_counts(build)
    fp, wall_pre = wall_s(torch, lambda: rt.FastVAT(
        method="ivat", metric="precomputed").fit_many(Ds))
    pre_launches = build.launch_counts()
    require_range_route("ivat precomputed fit_many b=8", b)
    require(pre_launches["pairwise_dist_batch"] == 0
            and pre_launches["vat_prim_order"] == 1
            and pre_launches["masked_argmin"] == 0
            and pre_launches["ivat_from_vat"] == 1,
            f"precomputed fit_many launch counts {pre_launches}")
    require(np.array_equal(fp.order(), order)
            and np.array_equal(fp.image(), img_iv),
            "precomputed fit_many differs from the points' fit_many")
    log("batch-vat", card=card, b=b, n=n, d=d, method=fv.method_resolved,
        launches=launches, walls_s=walls, solo_fits_s=solo_s,
        device_ops_per_fit=kernels,
        ivat_fit_s=wall_ivat, ivat_launches=ivat_launches,
        precomputed_fit_s=wall_pre, precomputed_launches=pre_launches,
        lanes_equal_solo=True, k_est=[r.k_est for r in reps],
        hopkins=[r.hopkins for r in reps])
    return launches, fv._X


def phase_batch_flash(torch, rt, ops, core, build, card):
    """fit_many at the top of the batched auto window (b = 4, n = 50,000,
    d = 64): the persistent engine (one launch of four groups of CTAs),
    the stepwise engine (n - 1 batched steps), bit for bit against each
    other and lane 0 against a solo fit; every lane against its solo fit at
    n = 16,384; the kernel's four lanes beside one solo lane."""
    b, n, d = 4, 50_000, 64
    Xs = np.stack([blobs(n, d, k=8, seed=s) for s in range(b)])
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    reset_counts(build)
    walls = {}
    fv, walls["fit"] = wall_s(torch, lambda: rt.FastVAT().fit_many(Xs))
    peak = torch.cuda.max_memory_allocated() - base
    order, walls["order"] = wall_s(torch, fv.order)
    img, walls["image"] = wall_s(torch, fv.image)
    img_iv, walls["image_ivat"] = wall_s(
        torch, lambda: fv.image(use_ivat=True))
    reps, walls["assess"] = wall_s(torch, fv.assess)
    launches = build.launch_counts()
    require_range_route("flashvat fit_many b=4 band render", b)
    require(fv.method_resolved == "flashvat" and fv.batched,
            f"auto fit_many picked {fv.method_resolved!r} at n={n}")
    require(launches["prim_persist"] == 1
            and launches["prim_stream_step_batch"] == 0
            and launches["prim_stream_step"] == 0
            and launches["pairwise_dist_batch"] == 1
            and launches["vat_prim_order"] == 1
            and launches["masked_argmin"] == 0
            and launches["ivat_from_vat"] == 1,
            f"batch-flash launch counts {launches}")
    require(peak < 1024 * 2 ** 20, f"the batched flashvat fit allocated "
            f"{peak} bytes on the card, over 1 GiB")
    require(all(np.array_equal(np.sort(o), np.arange(n)) for o in order),
            "a batched flashvat order is not a permutation")
    require(img.shape == img_iv.shape == (b, 256, 256)
            and np.isfinite(img).all() and np.isfinite(img_iv).all(),
            "bad batched flashvat images")
    require(all(r.k_est == 8 and r.clustered for r in reps),
            f"batched flashvat reports {reps}")
    build.reset_launch_counts()
    fs, walls["fit_stepwise"] = wall_s(
        torch, lambda: rt.FastVAT(turbo=False).fit_many(Xs))
    step_launches = build.launch_counts()
    require(step_launches["prim_stream_step_batch"] == n - 1
            and step_launches["prim_persist"] == 0
            and step_launches["prim_stream_step"] == 0,
            f"batched stepwise launch counts {step_launches}")
    require(np.array_equal(fs.order(), order)
            and torch.equal(fs.result.rstar, fv.result.rstar)
            and np.array_equal(fs.image(use_ivat=True), img_iv),
            "batched stepwise and persistent engines differ")
    from repro_torch.core.vat import _streamed_seed_pivot
    costs = stepwise_costs(torch, ops, core, fv._X.float().contiguous(),
                           _streamed_seed_pivot)
    walls["fit_stepwise_us_per_step"] = walls["fit_stepwise"] * 1e6 / (n - 1)
    s0, walls["solo_fit_lane0"] = wall_s(torch,
                                         lambda: rt.FastVAT().fit(Xs[0]))
    require(np.array_equal(s0.order(), order[0])
            and torch.equal(s0.result.rstar, fv.result.rstar[0])
            and np.array_equal(s0.image(use_ivat=True), img_iv[0]),
            "batched flashvat lane 0 differs from its solo fit")
    n2, d2 = 16_384, 32
    X2 = np.stack([blobs(n2, d2, k=8, seed=10 + s) for s in range(b)])
    f2, walls["fit_16384"] = wall_s(
        torch, lambda: rt.FastVAT(method="flashvat").fit_many(X2))
    solo2 = 0.0
    for z in range(b):
        s, w = wall_s(torch,
                      lambda: rt.FastVAT(method="flashvat").fit(X2[z]))
        solo2 += w
        require(np.array_equal(s.order(), f2.order()[z])
                and torch.equal(s.result.ivat_image, f2.result.ivat_image[z]),
                f"batched flashvat n={n2} lane {z} differs from its solo fit")
    walls["solo_fits_16384"] = solo2
    kernel = persist_lanes_vs_solo(torch, Xs)
    log("batch-flash", card=card, b=b, n=n, d=d, method=fv.method_resolved,
        launches=launches, step_launches=step_launches, walls_s=walls,
        peak_alloc_mib=peak / 2 ** 20, engines_bitwise=True,
        lane0_equals_solo=True, lanes_equal_solo_n16384=True,
        k_est=[r.k_est for r in reps], hopkins=[r.hopkins for r in reps],
        prim_persist=kernel, stepwise=costs)
    return step_launches, Xs


def persist_lanes_vs_solo(torch, Xs):
    """prim_persist on the b lanes of Xs in one launch beside one solo
    launch on lane 0 (CUDA events, one call each), with both plans; lane 0
    of the stack equals the solo launch, stats included."""
    from repro_torch.core.vat import PERSIST_PRUNE, _streamed_seed_pivot
    from repro_torch.kernels import ops
    from repro_torch.kernels.prim_persist import (persist_plan,
                                                 prim_persist_cuda)
    X = torch.from_numpy(Xs).cuda()
    b, n, d = X.shape
    aux = ops.metric_aux(X)
    i0 = torch.stack([_streamed_seed_pivot(x, metric="euclidean")
                      for x in X])
    many, lanes_ms = event_once_ms(torch, lambda: prim_persist_cuda(
        X, aux, i0, prune=PERSIST_PRUNE))
    solo, solo_ms = event_once_ms(torch, lambda: prim_persist_cuda(
        X[0], aux[0], i0[0], prune=PERSIST_PRUNE))
    require(all(torch.equal(a[0], s) for a, s in zip(many, solo)),
            "prim_persist lane 0 of the stack != its solo launch")
    return {"prune": PERSIST_PRUNE, "lanes_ms": lanes_ms, "solo_ms": solo_ms,
            "lanes_plan": persist_plan(b, n, d),
            "solo_plan": persist_plan(1, n, d)}


def phase_knn_batch(torch, ref, build, gen, card):
    """ops.knn_graph_batch at the top of the exact-kNN window, four lanes:
    each lane the single kNN kernel's lists, bit for bit; the plain version
    within the pairwise tolerance; then its times and bound."""
    from repro_torch.kernels import ops
    from repro_torch.kernels.knn_graph import (knn_graph_batch_cuda,
                                              knn_topk_cuda)
    b, n, d, k = 4, 32_768, 64, 15
    X = torch.randn(b, n, d, device="cuda", generator=gen)
    ids = torch.arange(n, device="cuda")
    build.reset_launch_counts()
    (dist, idx), wall = wall_s(torch, lambda: ops.knn_graph_batch(X, k=k))
    launches = build.launch_counts()["knn_graph_batch"]
    require(launches == 1, f"knn_graph_batch launched {launches} times")
    for z in range(b):
        sd, si = knn_topk_cuda(X[z], X[z], ids, ids, k=k)
        require(torch.equal(dist[z], sd) and torch.equal(idx[z], si),
                f"knn_graph_batch lane {z} != the single kNN kernel")
    pd, pi = ref.knn_graph_batch_ref(X, k=k)
    err = float(torch.amax(torch.abs(dist - pd)))
    tol = plain_tolerance(torch, "euclidean", X.view(b * n, d), pd)
    require(err <= tol, f"knn_graph_batch vs plain: {err} > {tol}")

    def library():   # cdist + topk per lane in row blocks; a yardstick only
        out = []
        for z in range(b):
            for r0 in range(0, n, 4096):
                D = torch.cdist(X[z, r0:r0 + 4096], X[z])
                rr = torch.arange(D.shape[0], device="cuda")
                D[rr, rr + r0] = torch.inf
                out.append(torch.topk(D, k, largest=False))
        return out

    row = {"kernel": "knn_graph_batch", "b": b, "n": n, "d": d, "k": k,
           "ms": device_ms(torch, lambda: knn_graph_batch_cuda(X, k=k),
                           reps=3, label="knn_graph_batch"),
           "event_ms": event_ms(torch, lambda: knn_graph_batch_cuda(X, k=k),
                                reps=3),
           "plain_ms": device_ms(torch, lambda: ref.knn_graph_batch_ref(
               X, k=k), reps=1, label="knn_graph_batch plain"),
           "library_ms": device_ms(torch, library, reps=1,
                                   label="knn_graph_batch library")}
    nbytes, nops = knn_cost(n, d, k)
    row["bound_ms"], row["bound_by"] = bound_ms(b * nbytes, b * nops)
    log("knn-batch", card=card, b=b, n=n, d=d, k=k, launches=launches,
        wall_s=wall,
        lanes_equal_single_kernel=True, plain_max_abs_err=err, plain_tol=tol,
        equal_idx_share=float((idx == pi).float().mean()))
    log("time", card=card, **row)
    return {"name": "knn_graph_batch", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/knn_graph.cu",
            "replaces": "src/repro/kernels/knn_graph.py:187",
            "launches": launches, "max_abs_err": err, "ms": row["ms"],
            "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
            "bound_by": row["bound_by"], "library_ms": row["library_ms"]}


def phase_batch_times(torch, ref, ops, Xv, Xf, errs, vat_launches,
                      step_launches, card):
    """The batched pairwise kernel at batch-vat's shape (8, 2,048, 64) and
    the batched step at batch-flash's (4, 50,000, 64), beside their plain
    versions, one library call where there is one, and their bounds."""
    from repro_torch.kernels.pairwise_dist import pairwise_dist_batch_cuda
    from repro_torch.kernels.prim_stream import prim_stream_step_batch_cuda
    Xv = Xv.float().contiguous()
    b, n, d = Xv.shape
    nbytes, nops = pairwise_cost(n, None, d)
    pw = {"kernel": "pairwise_dist_batch", "b": b, "n": n, "d": d,
          "ms": device_ms(torch, lambda: pairwise_dist_batch_cuda(Xv),
                          reps=20, label="pairwise_dist_batch"),
          "event_ms": event_ms(torch, lambda: pairwise_dist_batch_cuda(Xv),
                               reps=20),
          "plain_ms": device_ms(torch, lambda: ref.pairwise_dissim_batch_ref(
              Xv), reps=20, label="pairwise_dist_batch plain"),
          "library_ms": device_ms(torch, lambda: torch.cdist(Xv, Xv),
                                  reps=20, label="pairwise_dist_batch cdist")}
    pw["bound_ms"], pw["bound_by"] = bound_ms(b * nbytes, b * nops)
    log("time", card=card, **pw)
    from repro_torch.kernels.prim_update import masked_argmin_cuda
    gen = torch.Generator(device="cuda").manual_seed(7)
    vals = torch.rand(b, n, device="cuda", generator=gen)
    mask = torch.rand(b, n, device="cuda", generator=gen) < 0.5
    am = {"kernel": "masked_argmin", "lane_axis": True, "b": b, "n": n,
          "ms": device_ms(torch, lambda: masked_argmin_cuda(vals, mask),
                          reps=200, label="masked_argmin (b, n)"),
          "event_ms": event_ms(torch, lambda: masked_argmin_cuda(vals, mask),
                               reps=200),
          "plain_ms": device_ms(torch, lambda: ref.masked_argmin_ref(
              vals, mask), reps=200, label="masked_argmin (b, n) plain"),
          "library_ms": device_ms(torch, lambda: torch.argmin(
              vals.masked_fill(mask, torch.inf), dim=1), reps=200,
              label="masked_argmin (b, n) library")}
    am["bound_ms"], am["bound_by"] = bound_ms(b * argmin_cost(n)[0],
                                              b * argmin_cost(n)[1])
    log("time", card=card, **am)
    Xs = torch.from_numpy(Xf).cuda()
    b2, n2, d2 = Xs.shape
    aux = ops.metric_aux(Xs)
    from repro_torch.kernels import _build as build
    mind = torch.full((b2, n2), torch.inf, device="cuda")
    sel = torch.zeros((b2, n2), dtype=torch.bool, device="cuda")
    q = torch.arange(b2, device="cuda")
    sel.scatter_(1, q.view(b2, 1), True)
    order = torch.zeros((b2, n2), dtype=torch.int64, device="cuda")
    order[:, 0] = q
    edges = torch.zeros((b2, n2), device="cuda")
    rec = ops.prim_stream_stepper(Xs, aux, mind.clone(), sel.clone(), order,
                                  edges)
    nbytes, nops = stream_step_cost(n2, d2)
    st = {"kernel": "prim_stream_step_batch", "b": b2, "n": n2, "d": d2,
          "ms": device_ms(torch, lambda: rec(1), reps=200,
                          label="prim_stream_step_batch"),
          "event_ms": event_ms(torch, lambda: rec(1), reps=200),
          "single_call_ms": device_ms(
              torch, lambda: prim_stream_step_batch_cuda(
                  Xs, aux, q, mind, sel), reps=50,
              label="prim_stream_step_batch single call"),
          "plain_ms": device_ms(torch, lambda: ref.prim_stream_step_batch_ref(
              Xs, aux, q, mind, sel), reps=20,
              label="prim_stream_step_batch plain"),
          "library_ms": None,
          "l2_floor_ms": read_floor_ms(torch, build, Xs)}
    st["bound_ms"], st["bound_by"] = bound_ms(b2 * nbytes, b2 * nops)
    log("time", card=card, **st)
    return [
        # its stream time: two launches of ~0.2 ms back to back are
        # device-bound, and torch.profiler has read it at 40 % of that
        {"name": "pairwise_dist_batch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/pairwise_dist.cu",
         "replaces": "src/repro/kernels/pairwise_dist.py:179",
         "launches": vat_launches["pairwise_dist_batch"],
         "max_abs_err": errs["pairwise_dist_batch"], "ms": pw["event_ms"],
         "timer": "cuda events", "profiler_ms": pw["ms"],
         "plain_ms": pw["plain_ms"], "bound_ms": pw["bound_ms"],
         "bound_by": pw["bound_by"], "library_ms": pw["library_ms"]},
        # its stream time too: back to back the steps are device-bound,
        # and torch.profiler has read it at 37 % of that
        {"name": "prim_stream_step_batch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/prim_stream.cu",
         "replaces": "src/repro/kernels/prim_stream.py:265",
         "launches": step_launches["prim_stream_step_batch"],
         "max_abs_err": errs["prim_stream_step_batch"], "ms": st["event_ms"],
         "timer": "cuda events", "profiler_ms": st["ms"],
         "plain_ms": st["plain_ms"], "bound_ms": st["bound_ms"],
         "bound_by": st["bound_by"], "library_ms": None,
         "library_ms_why": "no single call: a fold then a masked argmin",
         "l2_floor_ms": st["l2_floor_ms"]},
    ]


# ------------------------------------------------------- serving layer ----

#: The fields a served result shares bit for bit with its solo fit.
SERVE_FIELDS = ("order", "rstar", "ivat_image", "sample_idx",
                "extension_labels", "group_sizes")

#: The kernels of the served path and the wrapper counts that show them:
#: rows 2 (the vat/ivat matrices, the band renders), 3' (the Prim loop),
#: 4 (iVAT), 5 (the flashvat traversal) and 1a (its seed scan); row 3 runs
#: no step of any of them.
SERVED_KERNELS = ("pairwise_dist_batch", "vat_prim_order", "ivat_from_vat",
                  "prim_persist", "pairwise_dist")
SERVED_KERNEL_SYMBOLS = ("pairwise_tile_kernel", "vat_prim_order_kernel",
                         "range_kernel", "prim_persist_kernel")


def served_diff(torch, a, b) -> list:
    """The fields in which a served result and its solo fit differ."""
    return [f for f in SERVE_FIELDS
            if (getattr(a, f) is None) != (getattr(b, f) is None)
            or (getattr(a, f) is not None
                and not torch.equal(getattr(a, f), getattr(b, f)))]


def pct_ms(values, q: float) -> float:
    return float(np.percentile(np.asarray(values), q)) * 1e3


def phase_serve_mixed(torch, rt, build, card):
    """``TendencyServer(ServeConfig(device="cuda"))`` under 64 requests from
    8 client threads (window 2 ms, at most 8 a batch): 48 ``auto`` at n
    drawn from 1,025..2,048 (bucket 2,048, d = 32, half euclidean, half
    cosine), 8 ``ivat`` at n = 1,500, d = 32, and 8 ``flashvat`` at
    n = 50,000, d = 64 (4 datasets, each twice), in a seeded shuffle; each
    client submits its 8 requests, then waits for them (latency: submit to
    the future's completion).  Every served result == its solo
    ``FastVAT(method=...).fit`` bit for bit (flashvat's representatives,
    labels and band sizes included); fewer batches than requests; every
    resilience counter 0; the served path's kernels launched (counts
    zeroed just before, read just after; torch.profiler's kernel names)
    and row 3 not."""
    from concurrent.futures import ThreadPoolExecutor
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serve import (ResilienceStats, ServeConfig,
                                   TendencyServer, trace_census)
    rng = np.random.default_rng(22)
    reqs = [("auto", ("euclidean", "cosine")[i % 2],
             blobs(int(rng.integers(1025, 2049)), 32, k=8, seed=100 + i))
            for i in range(48)]
    reqs += [("ivat", "euclidean", blobs(1500, 32, k=8, seed=200 + i))
             for i in range(8)]
    flash = [blobs(50_000, 64, k=8, seed=300 + j) for j in range(4)]
    reqs += [("flashvat", "euclidean", flash[i % 4]) for i in range(8)]
    reqs = [reqs[i] for i in rng.permutation(len(reqs))]
    done = [0.0] * len(reqs)

    def client(c):
        futs = []
        for i in range(c, len(reqs), 8):
            method, metric, X = reqs[i]
            t0 = time.perf_counter()
            fut = srv.submit(X, method=method, metric=metric,
                             timeout_s=120.0)
            fut.add_done_callback(
                lambda f, i=i: done.__setitem__(i, time.perf_counter()))
            futs.append((i, t0, fut))
        return [(i, fut.result(timeout=300), t0) for i, t0, fut in futs]

    builds0 = trace_census()["traces"]
    build.reset_launch_counts()
    with TendencyServer(ServeConfig(window_s=0.002, max_batch=8)) as srv:
        t0 = time.perf_counter()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with ThreadPoolExecutor(max_workers=8) as pool:
                got = [r for part in pool.map(client, range(8))
                       for r in part]
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        stats = srv.stats()
    out = {i: (res, done[i] - t_sub) for i, res, t_sub in got}
    launches = build.launch_counts()
    names = " ".join(kernel_device_ms(prof))
    require(all(launches[k] > 0 for k in SERVED_KERNELS)
            and launches["masked_argmin"] == 0,
            f"served path launch counts {launches}")
    if names:
        require(all(s in names for s in SERVED_KERNEL_SYMBOLS)
                and "masked_argmin_kernel" not in names,
                f"served path kernels in the trace: {names[:2000]}")
    else:
        log("timer-fallback", call="serve-mixed trace",
            why="torch.profiler recorded no device event; the launch "
                "counts alone show the served kernels")
    require(stats.dispatched_batches < len(reqs)
            and stats.dispatched_requests == len(reqs)
            and stats.timeouts == 0 and stats.rejected == 0,
            f"serve-mixed scheduler counters {stats}")
    require(stats.resilience == ResilienceStats(),
            f"disarmed server's resilience counters {stats.resilience}")
    solo, by_rung = {}, {}
    for i, (method, metric, X) in enumerate(reqs):
        res, lat = out[i]
        key = (method, metric, id(X))
        if key not in solo:
            solo[key] = rt.FastVAT(method=method, metric=metric).fit(
                X).result
        diff = served_diff(torch, res, solo[key])
        require(not diff and res.order.is_cuda,
                f"served {method} {metric} n={len(X)} differs from its solo "
                f"fit in {diff}")
        by_rung.setdefault(res.meta.method, []).append(lat)
    log("serve-mixed", card=card, requests=len(reqs), clients=8,
        wall_s=wall, batches=stats.dispatched_batches,
        coalesce_rate=stats.coalesce_rate,
        builds=trace_census()["traces"] - builds0,
        cache={"hits": stats.cache.hits, "misses": stats.cache.misses,
               "evictions": stats.cache.evictions},
        latency_ms={r: {"n": len(v), "p50": pct_ms(v, 50),
                        "p99": pct_ms(v, 99)} for r, v in by_rung.items()},
        launches=launches, resilience="all 0", bitwise_vs_solo=len(reqs))
    return launches


def phase_serve_pad(torch, rt, card):
    """Served ``vat`` and ``ivat`` at n = 1,023, 1,024, 1,025, 2,047, 2,048
    under euclidean, sqeuclidean and cosine (d = 32: padded with copies of
    row 0 to the buckets 1,024 and 2,048), and at n = 1,025 with 100 rows
    repeated from others (real zero-weight Prim edges beside the padding):
    order, R* and the iVAT image == the solo fit's bit for bit."""
    from repro_torch.serve import ServeConfig, TendencyServer, bucket_n
    cases = [(n, metric, blobs(n, 32, k=8, seed=400 + n))
             for n in (1023, 1024, 1025, 2047, 2048)
             for metric in ("euclidean", "sqeuclidean", "cosine")]
    Xr = blobs(1025, 32, k=8, seed=499)
    Xr[925:] = Xr[np.random.default_rng(4).integers(0, 925, size=100)]
    cases.append((1025, "euclidean", Xr))
    checked = 0
    t0 = time.perf_counter()
    with TendencyServer(ServeConfig(window_s=0.001)) as srv:
        for n, metric, X in cases:
            for method in ("vat", "ivat"):
                res = srv.submit(X, method=method, metric=metric).result(
                    timeout=300)
                want = rt.FastVAT(method=method, metric=metric).fit(X).result
                diff = served_diff(torch, res, want)
                require(not diff, f"served {method} {metric} n={n} (bucket "
                        f"{bucket_n(n)}) differs from its solo fit in "
                        f"{diff}")
                checked += 1
    log("serve-pad", card=card, checked=checked, wall_s=time.perf_counter()
        - t0, ns=[1023, 1024, 1025, 2047, 2048],
        metrics=["euclidean", "sqeuclidean", "cosine"],
        repeated_rows={"n": 1025, "rows": 100}, bitwise_vs_solo=True)


SERVE_KEYS = (("vat", 2048, 32), ("ivat", 2048, 32), ("flashvat", 50_000, 64))


def kernel_counts(prof) -> dict:
    """Launches by kernel name that a torch.profiler run recorded."""
    from torch.autograd import DeviceType
    return {e.key: e.count for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total}


def phase_serve_warm(torch, srv, card, prim_ms):
    """For each key (vat and ivat at 2,048 × 32, flashvat at 50,000 × 64)
    on a server whose kernel library loaded when it started: the cold
    first request (its program's build binds the rung's fitter and runs
    nothing; the request pays its kernels' first launches at this shape)
    against the p50/p99 of 16 warm ones; ``warm()`` of the same key and
    the warm requests build nothing (census); the host pre-pass of one
    submit (``validate_points`` and ``numerics.resolve``, median of 5);
    the device time of a warm request (torch.profiler, counted only from
    a trace that holds every request's Prim kernel at no less than 0.8 of
    ``prim_ms``, that kernel's CUDA-event time at the key's shape in this
    run, else "not measured") against its p50 wall, the host share."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.api.validation import validate_points
    from repro_torch.numerics import resolve
    from repro_torch.serve import trace_census
    rows = {}
    for method, n, d in SERVE_KEYS:
        X = blobs(n, d, k=8, seed=500 + n)
        prepass = []
        for _ in range(5):
            t0 = time.perf_counter()
            validate_points(X)
            resolve(np.asarray(X, dtype=np.float32), metric="euclidean",
                    policy=srv.config.numerics)
            prepass.append(time.perf_counter() - t0)
        census = trace_census()["traces"]
        t0 = time.perf_counter()
        srv.submit(X, method=method).result(timeout=300)
        cold = time.perf_counter() - t0
        require(trace_census()["traces"] == census + 1,
                f"{method}-{n}: the cold request built "
                f"{trace_census()['traces'] - census} programs")
        srv.warm(n, d, method=method)
        warm = []
        for _ in range(16):
            t0 = time.perf_counter()
            srv.submit(X, method=method).result(timeout=300)
            warm.append(time.perf_counter() - t0)
        require(trace_census()["traces"] == census + 1,
                f"{method}-{n}: warm() or a warm request built a program")
        # a profiler session now and then loses launches or reads them
        # short: count the trace only when it holds the Prim kernel of
        # every request it spans, each near that kernel's event time
        reps = 2 if method == "flashvat" else 4
        prim = ("prim_persist_kernel" if method == "flashvat"
                else "vat_prim_order_kernel")
        device, tries = 0.0, 0
        while device == 0.0 and tries < 5:
            tries += 1
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    srv.submit(X, method=method).result(timeout=300)
            seen = sum(c for k, c in kernel_counts(prof).items()
                       if prim in k)
            by_name = kernel_device_ms(prof)
            prim_traced = sum(v for k, v in by_name.items() if prim in k)
            if seen == reps and prim_traced >= 0.8 * reps * prim_ms[prim]:
                device = sum(by_name.values()) / reps
        p50 = pct_ms(warm, 50)
        rows[f"{method}-{n}"] = {
            "cold_ms": cold * 1e3, "warm_p50_ms": p50,
            "warm_p99_ms": pct_ms(warm, 99),
            "prepass_ms": pct_ms(prepass, 50),
            "device_ms": device if device > 0 else "not measured",
            "host_share": 1.0 - device / p50 if device > 0
            else "not measured", "trace_sessions": tries}
        log("serve-warm", card=card, key=f"{method}-{n}x{d}",
            **rows[f"{method}-{n}"])
    c = srv.stats().cache
    log("serve-warm", card=card, cache={"hits": c.hits, "misses": c.misses,
                                        "evictions": c.evictions,
                                        "size": c.size})
    return rows


def phase_serve_slo(torch, rt, srv, card):
    """The cost-model router (``method="auto"`` with ``slo_ms``) at SLOs of
    5, 20, 100 and 1,000 ms for n = 2,048 (d = 32) and n = 50,000 (d = 64):
    the rung it picks, its predicted wall, the measured wall of one warm
    served request of that rung (after a first one) and of one warm
    solo ``FastVAT(method=rung).fit`` of the same points."""
    from repro_torch.api.registry import predict_latency_us
    from repro_torch.serve import resolve_key
    measured, solo, out = {}, {}, []
    for n, d in ((2048, 32), (50_000, 64)):
        X = blobs(n, d, k=8, seed=500 + n)
        for slo in (5.0, 20.0, 100.0, 1000.0):
            rung = resolve_key(n, d, slo_ms=slo, config=srv.config).rung
            if (rung, n) not in measured:
                srv.submit(X, slo_ms=slo).result(timeout=300)
                t0 = time.perf_counter()
                res = srv.submit(X, slo_ms=slo).result(timeout=300)
                measured[(rung, n)] = time.perf_counter() - t0
                fv = rt.FastVAT(method=rung)
                fv.fit(X)
                _, solo[(rung, n)] = wall_s(torch, lambda: fv.fit(X))
                require(res.meta.method == rung,
                        f"slo {slo} n={n}: served {res.meta.method}, "
                        f"routed {rung}")
            out.append({"n": n, "slo_ms": slo, "rung": rung,
                        "predicted_ms": predict_latency_us(rung, n) / 1e3,
                        "measured_ms": measured[(rung, n)] * 1e3,
                        "solo_fit_ms": solo[(rung, n)] * 1e3})
    log("serve-slo", card=card, routes=out)


def phase_serve_chaos(torch, card):
    """The six ``repro_torch.launch.chaos`` scenarios in this process on
    the card, with their exact counter pins (the fallback scenario serves
    flashvat at 50,000 × 64 on the ladder's turbo=False level: row 10
    launched once a Prim step, row 5 not, the solo stepwise and persistent
    fits' bits)."""
    from repro_torch.launch import chaos
    lines = []
    t0 = time.perf_counter()
    failed = chaos.run(list(chaos.SCENARIOS), "cuda", out=lines.append)
    require(failed == 0, f"chaos scenarios failed: {lines}")
    log("serve-chaos", card=card, scenarios=lines,
        wall_s=time.perf_counter() - t0)


# ---------------------------------------------- the embed rung (DeepVAT) ----

#: The inner rung's kernels an embed fit plus ``image(use_ivat=True)`` must
#: launch, by wrapper count and by the symbol a trace shows: rows 1, 3' and
#: 4 on ``vat``; rows 1a and 1 (one wrapper: the seed scan and the solo
#: band render), 5 and 4 on ``flashvat`` (whose band render also orders
#: its representatives with row 3').
EMBED_KERNELS = {"vat": ("pairwise_dist", "vat_prim_order", "ivat_from_vat"),
                 "flashvat": ("pairwise_dist", "prim_persist",
                              "ivat_from_vat")}
EMBED_SYMBOLS = {"vat": ("pairwise_tile_kernel", "vat_prim_order_kernel",
                         "range_kernel"),
                 "flashvat": ("pairwise_tile_kernel", "prim_persist_kernel",
                              "range_kernel")}


def peak_reset(torch) -> int:
    """Restart the peak count; returns the bytes allocated now, the base a
    phase's peak is read over (earlier phases leave tensors alive)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_gb(torch, base: int) -> float:
    """Peak card memory since the last ``peak_reset`` over ``base``, GB."""
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 1e9


def tree_leaves(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from tree_leaves(v)
        else:
            yield v


def tree_to(tree, device):
    """A params tree (nested dicts of tensors) copied to ``device``."""
    return {k: tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def params_gb(params) -> float:
    return sum(t.numel() * t.element_size()
               for t in tree_leaves(params)) / 1e9


class method_walls:
    """Host walls of the named methods of ``cls`` while the block runs, in
    s by name: each call synchronizes the card before and after it, so a
    stage of a real fit is timed and not a copy of it (``_admit`` waits on
    the forward's launches through its copy to the host either way)."""

    def __init__(self, torch, cls, names):
        self.torch, self.cls, self.walls = torch, cls, {}
        self.saved = {name: getattr(cls, name) for name in names}

    def _timed(self, name, fn):
        def call(*args, **kwargs):
            self.torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            self.torch.cuda.synchronize()
            self.walls[name] = (self.walls.get(name, 0.0)
                                + time.perf_counter() - t0)
            return out
        return call

    def __enter__(self):
        for name, fn in self.saved.items():
            setattr(self.cls, name, self._timed(name, fn))
        return self.walls

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(self.cls, name, fn)


def embed_vs_plain(torch, rt, build, fit, acts, rung, label, dev):
    """``fit()`` (an embed fit that returns its FastVAT) with counts zeroed
    before it and read after it and ``image(use_ivat=True)``, held bit for
    bit against ``FastVAT().fit(acts)``: order, R*, the iVAT image, the
    band fields.  Returns (fv, launches, fit wall s, the walls of its
    embed front end and of its admission and pre-pass in s)."""
    reset_counts(build)
    with method_walls(torch, rt.FastVAT,
                      ("_fit_embed_front", "_admit")) as walls:
        fv, wall = wall_s(torch, fit)
    img_iv = fv.image(use_ivat=True)
    launches = build.launch_counts()
    plain = rt.FastVAT(device=dev).fit(acts)
    require(fv.result.meta.method == "embed",
            f"{label}: meta.method {fv.result.meta.method!r}")
    require(plain.method_resolved == rung,
            f"{label}: {acts.shape[0]} rows resolved to "
            f"{plain.method_resolved!r}, want {rung!r}")
    diff = served_diff(torch, fv.result, plain.result)
    require(not diff and np.array_equal(img_iv, plain.image(use_ivat=True)),
            f"{label}: the embed fit differs from the plain fit in "
            f"{diff or ['the iVAT image']}")
    missing = [k for k in EMBED_KERNELS[rung] if launches[k] == 0]
    require(not missing, f"{label}: {missing} not launched: {launches}")
    return fv, launches, wall, walls


def pairwise_vs_plain(torch, ref, pairwise_dist_cuda, X, Y, metric, form,
                      label) -> dict:
    """Row 1 against its plain version on the same card tensors, and, for
    euclidean, both against the f64 distances.  The tolerance is
    ``check_pairwise``'s (the gram bound 16 eps max|x|² under the square
    root on the euclidean gram form, 1e-5 of scale otherwise), which holds
    there at d <= 64, scaled by d / 64 above it: an f32 sum of d products
    rounds within d eps / 2 of its terms' magnitude, so the bound on an
    entry grows as d (under the square root, as sqrt(d / 64))."""
    d = X.shape[1]
    grow = max(1.0, d / 64)
    K = pairwise_dist_cuda(X, Y, metric=metric, form=form)
    P = ref.pairwise_dissim_ref(X, Y, metric=metric, form=form)
    if metric == "euclidean" and form == "gram":
        sq = torch.sum(X.float() ** 2, dim=1)
        if Y is not None:
            sq = torch.cat([sq, torch.sum(Y.float() ** 2, dim=1)])
        tol = (16 * F32_EPS * float(torch.amax(sq)) * grow) ** 0.5
    else:
        tol = (1e-5 * float(torch.amax(torch.abs(P))) + 1e-6) * grow
    out = {"d": d, "max_abs_err": float(torch.amax(torch.abs(K - P))),
           "tol": tol}
    if metric == "euclidean":
        Xd = X.double()
        Yd = Xd if Y is None else Y.double()
        T = torch.sqrt(torch.clamp_min(
            torch.sum(Xd * Xd, dim=1)[:, None] + torch.sum(Yd * Yd, dim=1)
            - 2.0 * (Xd @ Yd.T), 0.0))
        if Y is None:
            T.fill_diagonal_(0.0)
        out["kernel_vs_f64"] = float(torch.amax(torch.abs(K.double() - T)))
        out["plain_vs_f64"] = float(torch.amax(torch.abs(P.double() - T)))
    worst = max(out["max_abs_err"], out.get("kernel_vs_f64", 0.0))
    require(worst <= tol, f"{label}: pairwise {metric}/{form} "
            f"{tuple(X.shape)} x {None if Y is None else tuple(Y.shape)}: "
            f"{out} exceeds tol {tol}")
    return out


def embed_kernels_vs_plain(torch, ref, ops, kern, fv, rung, label) -> dict:
    """The embed fit's kernels against their plain versions on the fit's
    own data (``fv._X``, d = d_model) at the shapes the fit gave them:
    row 1 on the ``vat`` matrix, or on every seed-scan block of the
    ``flashvat`` fit, and on the band render's representatives; row 5 on
    the ``flashvat`` traversal, its order the fit's bit for bit and held
    against ``ref.prim_persist_ref`` by tree weight (``EXCESS_F32``) and
    by the MST's edge weights as multisets within the gram tolerance.
    The first row-1 case and row 5 are timed by CUDA events beside the
    plain version, ``torch.cdist`` and the bound."""
    from repro_torch.core.vat import PERSIST_PRUNE, SEED_BLOCK, _split
    meta, res = fv.result.meta, fv.result
    metric, form = meta.metric, meta.numerics.form
    X = fv._X.float().contiguous()
    n, d = X.shape
    if rung == "vat":
        cases = [("matrix", X, None)]
    else:
        br, bc = _split(n, SEED_BLOCK[0]), _split(n, SEED_BLOCK[1])
        cases = [(f"seed_block_{a}_{c}", X[a:a + br], X[c:c + bc])
                 for a in range(0, n, br) for c in range(0, n, bc)]
        cases.append(("render", X.index_select(0, res.sample_idx), None))
    out = {"pairwise_dist": {
        name: pairwise_vs_plain(torch, ref, kern["pairwise_dist"], A, B,
                                metric, form, f"{label} {name}")
        for name, A, B in cases}}
    name, A, B = cases[0]
    m = None if B is None else B.shape[0]
    timed = {"shape": [A.shape[0], m, d],
             "ms": event_ms(torch, lambda: kern["pairwise_dist"](
                 A, B, metric=metric, form=form), reps=10, warmup=1),
             "plain_ms": event_ms(torch, lambda: ref.pairwise_dissim_ref(
                 A, B, metric=metric, form=form), reps=10, warmup=1),
             "library_ms": event_ms(torch, lambda: torch.cdist(
                 A, A if B is None else B), reps=10, warmup=1)}
    timed["bound_ms"], timed["bound_by"] = bound_ms(
        *pairwise_cost(A.shape[0], m, d))
    out["pairwise_dist"]["timed"] = timed
    if rung == "flashvat":
        aux = ops.metric_aux(X, metric=metric)
        i0 = kern["seed_pivot"](X, metric=metric, form=form)
        (order, edges, stats), ms = event_once_ms(
            torch, lambda: kern["prim_persist"](X, aux, i0, metric=metric,
                                                form=form,
                                                prune=PERSIST_PRUNE))
        require(torch.equal(order, res.order),
                f"{label}: prim_persist order differs from the fit's")
        (porder, pedges), plain_ms = event_once_ms(
            torch, lambda: ref.prim_persist_ref(X, aux, i0, metric=metric,
                                                form=form))
        wk = tree_weight(torch, X, order)
        wp = tree_weight(torch, X, porder)
        excess = abs(wk - wp) / wp
        require(excess <= EXCESS_F32, f"{label}: prim_persist vs plain: "
                f"tree weight {wk} vs {wp}, relative {excess} > "
                f"{EXCESS_F32}")
        err = float(torch.amax(torch.abs(torch.sort(edges).values
                                         - torch.sort(pedges).values)))
        tol = (16 * F32_EPS * float(torch.amax(aux))) ** 0.5
        require(err <= tol, f"{label}: prim_persist edges vs plain: {err} "
                f"> {tol}")
        persist = {"n": n, "d": d, "ms": ms, "plain_ms": plain_ms,
                   "plain_timer": "cuda events, one call",
                   "plain_tree_weight_rel_excess": excess,
                   "plain_edges_max_abs_err": err, "plain_edges_tol": tol,
                   "same_order_as_plain": bool(torch.equal(porder, order))}
        persist["bound_ms"], persist["bound_by"] = bound_ms(
            *persist_cost(n, d, int(stats[2])))
        out["prim_persist"] = persist
    return out


def phase_embed_encoder(torch, rt, build, dev="cuda"):
    """``FastVAT().fit(X, encoder=fn)`` on the card: two blobs of 1,000 × 32,
    ``fn`` a tanh projection to 16 dimensions on the card."""
    X = blobs(2000, 32, k=2, seed=5)
    gen = torch.Generator(device=dev).manual_seed(0)
    W = torch.randn(32, 16, generator=gen, device=dev) / (8 * 32 ** 0.5)

    def fn(x):
        return torch.tanh(torch.as_tensor(x, device=dev) @ W)

    base = peak_reset(torch)
    acts = fn(X)
    fv, launches, wall, _ = embed_vs_plain(
        torch, rt, build, lambda: rt.FastVAT(device=dev).fit(X, encoder=fn),
        acts, "vat", "embed-encoder", dev)
    meta = fv.result.meta
    rep = fv.assess()
    require("fn@" in meta.encoder, f"meta.encoder {meta.encoder!r}")
    require(meta.n == 2000 and rep.clustered,
            f"two blobs through tanh: n={meta.n}, {rep}")
    log("embed-encoder", n=meta.n, d_in=32, d_act=16, encoder=meta.encoder,
        inner="vat", launches=launches, fit_ms=wall * 1e3,
        hopkins=rep.hopkins, block_score=rep.block_score, k_est=rep.k_est,
        same_as_plain_fit=True, peak_gb=peak_gb(torch, base))
    return launches


def attn_macs(cfg, S: int, K: int | None = None):
    """Multiply-adds of one attention sublayer over S queries against K
    keys (default S): (per token of the projections, per sequence of the
    score and value products, formed in full for every head: the
    reference's q-chunked attention forms every chunk's full row block and
    masks it)."""
    D, K = cfg.d_model, S if K is None else K
    if cfg.use_mla:
        H, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                         cfg.v_head_dim)
        proj = (D * cfg.q_lora_rank + cfg.q_lora_rank * H * (dn + dr)
                + D * (cfg.kv_lora_rank + dr)
                + cfg.kv_lora_rank * H * (dn + dv) + H * dv * D)
        return proj, H * S * K * (dn + dr + dv)
    proj = 2 * cfg.q_dim * D + 2 * cfg.kv_dim * D
    return proj, 2 * cfg.eff_heads * S * K * cfg.head_dim


def ffn_macs(cfg, d_ff: int) -> int:
    return (3 if cfg.gated else 2) * cfg.d_model * d_ff


def forward_flops(cfg, B: int, S: int, labels: bool = False) -> float:
    """f32 operations of a ``return_hidden`` forward over B rows of S
    positions, two per multiply-add of its products: attention
    (``attn_macs``) and FFNs; for moe the router, every slot of the
    (E, cap, D) dispatch buffer through its expert (empty slots too: the
    batched products form them) and the shared experts, and with
    ``labels`` DeepSeek-V3's MTP block and its vocabulary product; for ssm
    RWKV-6's six D×D products, the decay LoRA, the channel mix and the WKV
    state update (about three per state entry a token); for hybrid the Mamba2 projections
    and SSD chunk products around the shared block; for audio the encoder
    over ``enc_seq`` frames and each decoder layer's cross-attention."""
    D, T = cfg.d_model, B * S
    proj, attn = attn_macs(cfg, S)
    dense = T * (proj + ffn_macs(cfg, cfg.d_ff)) + B * attn
    fam = cfg.family
    if fam in ("dense", "vlm"):
        macs = cfg.n_layers * dense
    elif fam == "moe":
        E, K, Fe = cfg.n_experts, cfg.top_k, cfg.d_ff_expert or cfg.d_ff
        cap = max(int(K * T * cfg.capacity_factor / E), 1)
        layer = (T * (proj + D * E) + B * attn + E * cap * ffn_macs(cfg, Fe)
                 + T * cfg.n_shared_experts * ffn_macs(cfg, Fe))
        macs = cfg.n_layers * layer
        if labels and cfg.mtp:
            macs += dense + T * (2 * D * D + D * cfg.padded_vocab)
    elif fam == "ssm":
        N = cfg.rwkv_head_dim
        macs = cfg.n_layers * T * (6 * D * D + 128 * D + 2 * D * cfg.d_ff
                                   + 3 * D * N)
    elif fam == "hybrid":
        inner, P, N = cfg.ssm_expand * D, cfg.ssm_head_dim, cfg.ssm_state
        H, L = inner // P, min(cfg.ssm_chunk, S)
        mamba = T * (D * (2 * inner + 2 * N + H) + inner * D
                     + L * N + L * H * P + 2 * N * H * P)
        nsb = cfg.n_layers // cfg.attn_every
        macs = nsb * ((cfg.attn_every - 1) * mamba + dense)
    elif fam == "audio":
        Se = cfg.enc_seq
        eproj, eattn = attn_macs(cfg, Se)
        enc = B * (Se * (eproj + ffn_macs(cfg, cfg.d_ff)) + eattn)
        _, xattn = attn_macs(cfg, S, Se)
        cross = B * (S * 2 * cfg.q_dim * D + Se * 2 * cfg.kv_dim * D + xattn)
        macs = cfg.n_enc_layers * enc + cfg.n_layers * (dense + cross)
    else:
        raise ValueError(fam)
    return 2.0 * macs


def embed_trace(torch, rt, acts, fingerprint, rung, dev="cuda") -> dict:
    """The device time by kernel of one traced ``fit(acts, encoder=)`` plus
    its ``image(use_ivat=True)`` (torch.profiler; tracing slows the host).
    ``profiler_shows_rung`` says whether the trace holds every symbol of
    ``EMBED_SYMBOLS[rung]``; a trace can lose launches (the hard check is
    the wrapper counts), and one that records no device time reads "not
    measured"."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fv = rt.FastVAT(device=dev).fit(acts, encoder=fingerprint)
        fv.image(use_ivat=True)
        torch.cuda.synchronize()
    by_name = kernel_device_ms(prof)
    if not by_name:
        return {"traced_device_ms": "not measured",
                "profiler_shows_rung": "not measured"}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:5]
    return {"traced_device_ms": sum(by_name.values()),
            "traced_top_ms": {name[:48]: ms for name, ms in top},
            "profiler_shows_rung": all(
                any(sym in name for name in by_name)
                for sym in EMBED_SYMBOLS[rung])}


def embed_model(torch, rt, ref, ops, kern, build, cfg, shapes, label,
                dev="cuda", kind="prefill"):
    """Full-width ``cfg`` from ``init_params`` (f32, seed 0) on the card;
    for each (B, S, rung) of ``shapes`` a ``make_batch`` batch of ``kind``
    (``train`` adds labels, which run DeepSeek-V3's MTP block), its forward
    (CUDA events), ``fit_embeddings`` held bit for bit against the plain fit
    of the same activations with the walls of its embed front end and
    pre-pass, its kernels against their plain versions on its data, and
    one traced embed fit.  Returns (params, the first batch, launches
    summed over the fits)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import make_batch
    from repro_torch.models import model as M
    from repro_torch.monitor import encode_batch, model_fingerprint
    base = peak_reset(torch)
    gen = torch.Generator(device=dev).manual_seed(0)
    params, init_s = wall_s(torch, lambda: M.init_params(cfg, gen,
                                                        device=dev))
    fingerprint = model_fingerprint(cfg, params)
    total, first = {}, None
    for B, S, rung in shapes:
        batch = make_batch(cfg, ShapeConfig("embed", S, B, kind), device=dev)
        first = first or batch
        torch.cuda.reset_peak_memory_stats()
        acts = encode_batch(params, cfg, batch)     # and the warm-up
        forward_ms = event_ms(torch, lambda: encode_batch(params, cfg, batch),
                              reps=1, warmup=0)
        require(bool(torch.isfinite(acts).all()),
                f"{label}: non-finite hidden states")
        tag = f"{label} B={B} S={S}"
        fv, launches, fit_s, walls = embed_vs_plain(
            torch, rt, build,
            lambda: rt.FastVAT(device=dev).fit_embeddings(params, cfg, batch),
            acts, rung, tag, dev)
        meta = fv.result.meta
        require(meta.n == acts.shape[0] and meta.encoder == fingerprint
                and meta.encoder.startswith(f"{cfg.name}@"),
                f"{label}: meta n={meta.n}, encoder={meta.encoder!r}")
        vs_plain = embed_kernels_vs_plain(torch, ref, ops, kern, fv, rung,
                                          tag)
        trace = embed_trace(torch, rt, acts, fingerprint, rung, dev)
        rep = fv.assess()
        flops = forward_flops(cfg, B, S, labels="labels" in batch)
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        log(label, arch=cfg.name, layers=cfg.n_layers, d_model=cfg.d_model,
            batch=B, seq=S, kind=kind, rows=meta.n, inner=rung,
            encoder=meta.encoder,
            param_gb=params_gb(params), init_s=init_s,
            forward_ms=forward_ms, forward_tflop=flops / 1e12,
            forward_tflop_per_s=flops / forward_ms / 1e9,
            forward_bound_ms=flops / PEAK_F32_OPS_PER_S * 1e3,
            fit_embeddings_ms=fit_s * 1e3,
            embed_fit_ms=walls["_fit_embed_front"] * 1e3,
            host_prepass_ms=walls["_admit"] * 1e3, launches=launches,
            kernels_vs_plain=vs_plain, **trace,
            hopkins=rep.hopkins, block_score=rep.block_score, k_est=rep.k_est,
            same_as_plain_fit=True, peak_gb=peak_gb(torch, base))
        del fv, acts
    return params, first, total


def check_report(torch, core, ref, ops, kern, name, report, acts, dev):
    """One tendency report (sample 128, a generator of seed 0) on the
    card: scores in [0, 1], a (128, 128) rstar equal bit for bit to the
    VAT image of ``core.maximin_sample``'s rows from a generator of the
    same seed, and row 1 on those rows against its plain version."""
    rep, wall = wall_s(torch, lambda: report(
        acts, torch.Generator(device=dev).manual_seed(0), sample=128))
    rows = acts.reshape(-1, acts.shape[-1]).float()
    idx = core.maximin_sample(
        rows, 128, torch.Generator(device=dev).manual_seed(0))
    want = core.vat_from_dist(ops.pairwise_dist(rows[idx])).rstar
    sample_err = pairwise_vs_plain(
        torch, ref, kern["pairwise_dist"], rows[idx], None, "euclidean",
        "gram", f"probe {name} sample")
    h, score = float(rep.hopkins), float(rep.block_score)
    require(0 <= h <= 1 and 0 <= score <= 1,
            f"probe {name}: hopkins {h}, block score {score}")
    require(tuple(rep.rstar.shape) == (128, 128)
            and torch.equal(rep.rstar, want),
            f"probe {name}: rstar {tuple(rep.rstar.shape)} is not the "
            "VAT image of the maximin sample")
    return {"rows": rows.shape[0], "d": rows.shape[1], "ms": wall * 1e3,
            "hopkins": h, "block_score": score, "k_est": int(rep.k_est),
            "pairwise_vs_plain": sample_err}


def phase_embed_probes(torch, core, ref, ops, kern, cfg, params, batch,
                       dev="cuda"):
    """``activation_report`` on the final layer's taps and
    ``embedding_tendency`` on the (vocab, d_model) table (sample 128 each):
    scores in [0, 1], a (128, 128) rstar equal bit for bit to the VAT image
    of ``core.maximin_sample``'s rows from a generator of the same seed,
    and row 1 on those rows against its plain version."""
    from repro_torch.models import model as M
    from repro_torch.monitor import activation_report, embedding_tendency
    base = peak_reset(torch)
    with torch.inference_mode():
        _, _, taps = M.forward(params, cfg, batch, return_hidden=True,
                               taps=True)
    final = taps["layer_out"][-1]
    out = {name: check_report(torch, core, ref, ops, kern, name, report,
                              acts, dev)
           for name, report, acts in (
               ("acts_final", activation_report, final),
               ("embed_table", embedding_tendency, params["embed"]))}
    log("probes", arch=cfg.name, taps_shape=list(taps["layer_out"].shape),
        reports=out, rstar_equals_maximin_vat=True, held_gb=base / 1e9,
        peak_gb=peak_gb(torch, base))


def expert_ids(torch, cfg, router_logits):
    """Each token's top-k experts, as ``moe_ffn`` routes them: (L, T, K)."""
    from repro_torch.models.moe import _top_k
    return _top_k(torch.softmax(router_logits, dim=-1), cfg.top_k)[1]


def phase_model_parity(torch, cfg, dev="cuda", **cut):
    """The card's forward against the CPU's on the same weights (the
    card's, copied): full width at the depth ``cut`` gives (2 layers by
    default), B = 1, 128 text tokens (vlm: after its patches; audio: over
    1,500 frames).  Each of hidden states, logits and taps within 1e-4 of
    its scale; for moe the router logits too, after the expert ids, which
    must be the same (a flip is reported as such)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import make_batch
    from repro_torch.models import model as M
    cfg = cfg.replace(**(cut or {"n_layers": 2}))
    base = peak_reset(torch)
    params = M.init_params(cfg, torch.Generator(device=dev).manual_seed(1),
                           device=dev)
    extra = cfg.n_patches if cfg.family == "vlm" else 0
    batch = make_batch(cfg, ShapeConfig("parity", 128 + extra, 1, "prefill"),
                       device=dev)
    host = tree_to(params, "cpu")
    host_batch = {k: (v.cpu() if isinstance(v, torch.Tensor) else v)
                  for k, v in batch.items()}
    ratios = {}
    with torch.inference_mode():
        got = M.forward(params, cfg, batch, taps=True)
        got_h = M.forward(params, cfg, batch, return_hidden=True)[0]
        want, cpu_s = wall_s(torch, lambda: M.forward(host, cfg, host_batch,
                                                      taps=True))
        want_h = M.forward(host, cfg, host_batch, return_hidden=True)[0]
    pairs = [("hidden", got_h, want_h), ("logits", got[0], want[0]),
             ("taps", got[2]["layer_out"], want[2]["layer_out"])]
    routing = {}
    if cfg.family == "moe":
        ids = expert_ids(torch, cfg, got[2]["router_logits"]).cpu()
        want_ids = expert_ids(torch, cfg, want[2]["router_logits"])
        flips = int((ids != want_ids).sum())
        require(flips == 0, f"{cfg.name}: expert flip: {flips} of "
                f"{ids.numel()} (token, slot) routes differ between the "
                "card's router logits and the CPU's")
        routing = {"same_expert_ids": True, "routes": ids.numel()}
        pairs.append(("router_logits", got[2]["router_logits"],
                      want[2]["router_logits"]))
    for name, a, b in pairs:
        ratios[name] = float((a.cpu() - b).abs().max()
                             / b.abs().max())
    require(all(r <= 1e-4 for r in ratios.values()),
            f"{cfg.name}: card against CPU max |diff| / max |cpu| {ratios}, "
            "want <= 1e-4")
    log("model-parity", arch=cfg.name, layers=cfg.n_layers,
        enc_layers=cfg.n_enc_layers, d_model=cfg.d_model, tokens=128,
        patches=extra, ratio_max_abs_over_scale=ratios, **routing,
        bound=1e-4, cpu_forward_s=cpu_s, peak_gb=peak_gb(torch, base))


def phase_router_probe(torch, core, ref, ops, kern, cfg, params, batch,
                       label, dev="cuda"):
    """``router_tendency`` on the last layer's router logits of the embed
    batch (T × n_experts), checked as ``check_report`` checks a probe."""
    from repro_torch.models import model as M
    from repro_torch.monitor import router_tendency
    base = peak_reset(torch)
    with torch.inference_mode():
        _, _, taps = M.forward(params, cfg, batch, return_hidden=True,
                               taps=True)
    logits = taps["router_logits"]
    require(tuple(logits.shape[::2]) == (cfg.n_layers, cfg.n_experts)
            and logits.dtype == torch.float32,
            f"{label}: router logits {tuple(logits.shape)} {logits.dtype}")
    report = check_report(torch, core, ref, ops, kern, label,
                          router_tendency, logits[-1], dev)
    check_moe_routing(torch, cfg, logits[-1], label, dev)
    log("router-probe", arch=cfg.name, logits_shape=list(logits.shape),
        layer=-1, report=report, rstar_equals_maximin_vat=True,
        peak_gb=peak_gb(torch, base))


def check_moe_routing(torch, cfg, router_logits, label, dev="cuda"):
    """``moe._positions`` and ``moe._token_fractions`` against the one-hot
    formulas they replace, bit for bit, on the card and on the CPU: the
    expert ids of ``router_logits`` (T, E), then seeded ids of 65,536 tokens
    at deepseek-v3's 256 experts, top-8."""
    import torch.nn.functional as F
    from repro_torch.models.moe import _positions, _token_fractions
    gen = torch.Generator(device=dev).manual_seed(0)
    cases = [(label, cfg.n_experts, expert_ids(torch, cfg, router_logits)),
             ("seeded E 256 K 8", 256, torch.randint(
                 0, 256, (65_536, 8), generator=gen, device=dev))]
    out = {}
    for name, E, ids in cases:
        for where in (dev, "cpu"):
            ids_w = ids.to(where)
            ids_f = ids_w.T.reshape(-1)
            oh = F.one_hot(ids_f, E)
            pos_eq = torch.equal(_positions(ids_f, E),
                                 (oh.cumsum(0) * oh).sum(1) - 1)
            del oh
            frac = _token_fractions(ids_w[:, 0], E)
            want = F.one_hot(ids_w[:, 0], E).float().mean(0)
            frac_eq = torch.equal(frac.view(torch.int32),
                                  want.view(torch.int32))
            require(pos_eq and frac_eq,
                    f"moe-routing {name} on {where}: positions equal "
                    f"{pos_eq}, token fractions equal {frac_eq}")
            out[f"{name} {where}"] = {"tokens": ids.shape[0], "experts": E,
                                      "top_k": ids.shape[1]}
    log("moe-routing", arch=cfg.name, positions_equal=True,
        token_fractions_equal=True, cases=out)


def phase_decode(torch, cfg, params, label, dev="cuda"):
    """``prefill`` of a 128-token prompt (B 1), 32 ``decode_step``s and a
    ``forward`` of the same 160 tokens: under an f32 cache the prefill's
    logits and each step's within 2e-3 of the forward's scale (5e-3 for
    hybrid), the reference's tolerances.  moe runs at capacity_factor
    max(16, n_experts / top_k): 16 (the reference's tests) holds
    phi3.5-moe's prompt, but at deepseek-v3's full width one expert takes
    most of the prompt's tokens (88 of 128 against a cap of 64), and at
    n_experts / top_k the cap is the token count, so nothing can drop;
    the prefill's largest load is printed and held under the cap, and
    decode never drops (a step's K experts are distinct, and cap >= 1).
    Then the prefill (CUDA events, one call) and a decode step (events
    around the 32) under the default bfloat16 cache."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.tokens import make_batch
    from repro_torch.models import model as M
    P, STEPS = 128, 32
    note = {}
    if cfg.family == "moe":
        cfg = cfg.replace(capacity_factor=max(16.0,
                                              cfg.n_experts / cfg.top_k))
    base = peak_reset(torch)
    batch = make_batch(cfg, ShapeConfig("decode", P + STEPS, 1, "prefill"),
                       device=dev)
    toks = torch.as_tensor(batch["tokens"], device=dev)
    extra = {k: v for k, v in batch.items() if k != "tokens"}
    prompt = {"tokens": toks[:, :P], **extra}

    def run(cache_dtype):
        logits, cache, pos = M.prefill(params, cfg, prompt, P + STEPS,
                                       cache_dtype=cache_dtype)
        steps = []
        for i in range(STEPS):
            lg, cache = M.decode_step(params, cfg, toks[:, P + i:P + i + 1],
                                      cache, pos + i)
            steps.append(lg)
        return logits, torch.cat(steps, dim=1), pos

    with torch.inference_mode():
        full, _ = M.forward(params, cfg, {"tokens": toks, **extra})
        if cfg.family == "moe":
            _, _, taps = M.forward(params, cfg, prompt, return_hidden=True,
                                   taps=True)
            ids = expert_ids(torch, cfg, taps["router_logits"])
            load = max(int(torch.bincount(ids[i].reshape(-1),
                                          minlength=cfg.n_experts).max())
                       for i in range(cfg.n_layers))
            cap = max(int(cfg.top_k * P * cfg.capacity_factor
                          / cfg.n_experts), 1)
            require(load <= cap, f"{label}: the prefill drops: an expert "
                    f"takes {load} entries of the prompt, cap {cap}")
            note = {"capacity_factor": cfg.capacity_factor,
                    "prefill_max_expert_load": load, "prefill_cap": cap,
                    "prefill_drops": 0, "decode_drops": 0,
                    "decode_cap": max(int(cfg.top_k * cfg.capacity_factor
                                          / cfg.n_experts), 1)}
        logits, steps, pos = run(torch.float32)
        require(pos == P, f"{label}: prefill returned position {pos}")
        scale = float(full.abs().max())
        errs = {"prefill": float((logits - full[:, :P]).abs().max()) / scale,
                "decode": float((steps - full[:, P:]).abs().max()) / scale}
        tol = 5e-3 if cfg.family == "hybrid" else 2e-3
        require(all(e <= tol for e in errs.values()),
                f"{label}: prefill/decode against forward {errs}, tol {tol}")
        # the default bfloat16 cache, timed
        prefill_ms = event_ms(torch, lambda: M.prefill(
            params, cfg, prompt, P + STEPS), reps=1, warmup=1)
        _, cache, pos = M.prefill(params, cfg, prompt, P + STEPS)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        for i in range(STEPS):
            lg, cache = M.decode_step(params, cfg, toks[:, P + i:P + i + 1],
                                      cache, pos + i)
        end.record()
        host_us = (time.perf_counter() - t0) / STEPS * 1e6
        end.synchronize()
        step_ms = start.elapsed_time(end) / STEPS
        require(bool(torch.isfinite(lg).all()),
                f"{label}: non-finite logits under the bfloat16 cache")
    log(label, arch=cfg.name, family=cfg.family, layers=cfg.n_layers,
        d_model=cfg.d_model, batch=1, prompt=P, steps=STEPS,
        err_over_scale_f32_cache=errs, tol=tol, **note,
        prefill_ms_bf16_cache=prefill_ms,
        prefill_tokens_per_s=P / prefill_ms * 1e3,
        decode_step_ms_bf16_cache=step_ms, decode_host_us_a_step=host_us,
        decode_tokens_per_s=1e3 / step_ms, peak_gb=peak_gb(torch, base))


def block_gemm_flops(cfg, T: int) -> float:
    """f32 operations of the products of one layer's block over T tokens
    (``phase_layer_trace``'s blocks): RWKV-6's six D×D products, the decay
    LoRA and the channel mix; Mamba2's in and out projections; the MoE
    router, every (E, cap) expert slot and the shared experts."""
    D = cfg.d_model
    if cfg.family == "ssm":
        return 2.0 * T * (6 * D * D + 128 * D + 2 * D * cfg.d_ff)
    if cfg.family == "hybrid":
        inner, N = cfg.ssm_expand * D, cfg.ssm_state
        H = inner // cfg.ssm_head_dim
        return 2.0 * T * (D * (2 * inner + 2 * N + H) + inner * D)
    E, K, Fe = cfg.n_experts, cfg.top_k, cfg.d_ff_expert or cfg.d_ff
    cap = max(int(K * T * cfg.capacity_factor / E), 1)
    return 2.0 * (T * D * E + E * cap * ffn_macs(cfg, Fe)
                  + T * cfg.n_shared_experts * ffn_macs(cfg, Fe))


def phase_layer_trace(torch, cfg, params, dev="cuda"):
    """One layer's sequence mixer or expert FFN at the embed batch's shape
    (B 4, S 512, a seeded normal input), after a warm-up: its stream time
    (CUDA events) beside its products' bound; then one call under
    torch.profiler: launches, the card's time split into the GEMM kernels
    and the rest, and the idle share of the stream time.  A trace whose
    device time falls under the products' bound lost launches and reads
    "not measured".  ssm: ``rwkv_block`` (the WKV loop of S steps);
    hybrid: ``mamba_block`` (the SSD chunk loop); moe: ``moe_ffn``, and
    its batched expert products alone on a buffer of the same (E, cap, D)
    shape, so routing, dispatch and combine are the difference."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels.ref import full_f32
    from repro_torch.models import model as M
    from repro_torch.models.common import activation
    from repro_torch.models.mamba2 import mamba_block
    from repro_torch.models.moe import moe_ffn
    from repro_torch.models.rwkv6 import rwkv_block
    block, idx = {"ssm": (rwkv_block, (0,)), "hybrid": (mamba_block, (0, 0)),
                  "moe": (moe_ffn, (0,))}[cfg.family]
    lp = M._layer(params["layers"], *idx)
    B, S = 4, 512
    h = torch.randn(B, S, cfg.d_model, device=dev,
                    generator=torch.Generator(device=dev).manual_seed(0))
    bound = block_gemm_flops(cfg, B * S) / PEAK_F32_OPS_PER_S * 1e3
    out = {"products_bound_ms": bound}
    with torch.inference_mode(), full_f32():
        out["ms"] = event_ms(torch, lambda: block(lp, h, cfg), reps=3,
                             warmup=1)
        if cfg.family == "moe":
            E, K = cfg.n_experts, cfg.top_k
            cap = max(int(K * B * S * cfg.capacity_factor / E), 1)
            buf = torch.zeros(E, cap, cfg.d_model, device=dev)
            act = activation(cfg.act)

            def experts():
                up = torch.einsum("ecd,edf->ecf", buf, lp["e_up"])
                gate = act(torch.einsum("ecd,edf->ecf", buf, lp["e_gate"]))
                return torch.einsum("ecf,efd->ecd", gate * up, lp["e_down"])

            out["expert_products_ms"] = event_ms(torch, experts, reps=3,
                                                 warmup=1)
            out["routing_dispatch_combine_shared_ms"] = (
                out["ms"] - out["expert_products_ms"])
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            block(lp, h, cfg)
            torch.cuda.synchronize()
    by_name = kernel_device_ms(prof)
    device = sum(by_name.values())
    if device >= bound:
        gemm = sum(v for k, v in by_name.items()
                   if "gemm" in k.lower() or "cutlass" in k.lower())
        out.update(device_ms=device, gemm_ms=gemm, other_ms=device - gemm,
                   launches=device_launches(prof),
                   idle_share=max(0.0, 1 - device / out["ms"]))
    else:
        out.update(trace="not measured", traced_device_ms=device,
                   traced_launches=device_launches(prof))
    log("layer-trace", arch=cfg.name, block=block.__name__, batch=B, seq=S,
        **out)


#: The new families' cells: (config, depth cut where one card's 80 GB
#: forces one, embed shapes (B, S, inner rung), batch kind, label).
FAMILY_CELLS = (
    ("rwkv6-3b", {}, ((4, 512, "vat"), (4, 1024, "flashvat")), "prefill",
     "rwkv6"),
    ("zamba2-2.7b", {}, ((4, 512, "vat"),), "prefill", "zamba2"),
    ("whisper-large-v3", {}, ((4, 512, "vat"),), "prefill", "whisper"),
    ("phi3.5-moe-42b-a6.6b", {"n_layers": 8}, ((4, 512, "vat"),), "prefill",
     "moe-phi35"),
    ("deepseek-v3-671b", {"n_layers": 1}, ((4, 512, "vat"),), "train",
     "mla-dsv3"),
)

#: ``model-parity``'s depths for the new families (deepseek-v3 is held on
#: the card by its ``decode`` phase, against the CPU by the tests).
PARITY_CUTS = (("phi3.5-moe-42b-a6.6b", {"n_layers": 1}),
               ("rwkv6-3b", {"n_layers": 2}),
               ("zamba2-2.7b", {"n_layers": 6}),
               ("whisper-large-v3", {"n_layers": 1, "n_enc_layers": 1}))


def model_size(torch, name, cut, dev="cuda"):
    """Prints the f32 weights of ``name`` at its published depth and at
    the cut (from the specs, on the meta device: nothing is allocated)
    beside the card's free memory; returns the cut config."""
    from repro_torch import configs
    from repro_torch.models import model as M
    full = configs.get_config(name)
    cfg = full.replace(**cut)

    def gb(c):
        meta = M.init_params(c, torch.Generator(), device="meta")
        return sum(t.numel() * 4 for t in tree_leaves(meta)) / 1e9

    free, total = torch.cuda.mem_get_info()
    log("model-size", arch=name, layers_published=full.n_layers,
        layers_run=cfg.n_layers, f32_gb_published=gb(full),
        f32_gb_run=gb(cfg), cut=cut or "none", card_free_gb=free / 1e9,
        card_total_gb=total / 1e9)
    return cfg


def phase_families(torch, rt, core, ref, ops, kern, build, dev="cuda"):
    """The fourteenth slice: each new family at its published widths
    (``FAMILY_CELLS``) through the embed rung, the router probe (moe) and
    a prefill → decode loop, one model at a time, deepseek-v3 last; then
    the card-against-CPU forwards (``PARITY_CUTS``) before deepseek-v3.
    Returns the launches of the embed fits by kernel."""
    from repro_torch import configs
    launches = {}
    for name, cut, shapes, kind, tag in FAMILY_CELLS:
        if name == "deepseek-v3-671b":
            for pname, pcut in PARITY_CUTS:
                phase_model_parity(torch, configs.get_config(pname), dev,
                                   **pcut)
                torch.cuda.empty_cache()
        cfg = model_size(torch, name, cut, dev)
        params, batch, counts = embed_model(
            torch, rt, ref, ops, kern, build, cfg, shapes, f"embed-{tag}",
            dev, kind=kind)
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        if cfg.family == "moe":
            phase_router_probe(torch, core, ref, ops, kern, cfg, params,
                               batch, f"router {tag}", dev)
        phase_decode(torch, cfg, params, f"decode-{tag}", dev)
        if cfg.family in ("ssm", "hybrid", "moe"):
            phase_layer_trace(torch, cfg, params, dev)
        del params, batch
        torch.cuda.empty_cache()
    return launches


def phase_embed(torch, rt, core, ref, ops, kern, build, dev="cuda"):
    """The embed rung on the card: a callable encoder, then full-width
    gemma-2b and internvl2-1b through ``fit_embeddings``, the probes over
    gemma's run, and the card-against-CPU forwards.  ``kern`` holds the
    wrappers ``pairwise_dist`` and ``prim_persist`` and ``seed_pivot``.
    Returns the launches of the embed fits by kernel."""
    from repro_torch import configs
    launches = phase_embed_encoder(torch, rt, build, dev)
    gemma = configs.get_config("gemma-2b")
    params, batch, counts = embed_model(
        torch, rt, ref, ops, kern, build, gemma,
        ((4, 512, "vat"), (4, 1024, "flashvat")), "embed-gemma", dev)
    for k, v in counts.items():
        launches[k] += v
    phase_embed_probes(torch, core, ref, ops, kern, gemma, params, batch,
                       dev)
    del params, batch
    torch.cuda.empty_cache()
    params, _, counts = embed_model(
        torch, rt, ref, ops, kern, build, configs.get_config("internvl2-1b"),
        ((4, 512, "vat"),), "embed-vlm", dev)
    for k, v in counts.items():
        launches[k] += v
    del params
    torch.cuda.empty_cache()
    for name in ("gemma-2b", "internvl2-1b"):
        phase_model_parity(torch, configs.get_config(name), dev)
        torch.cuda.empty_cache()
    return launches


# ------------------------------------------------------------- training ----

#: ``train-gemma``'s cell: gemma-2b at its published config (18 layers,
#: ``remat="full"``), f32 weights from ``init_params`` seed 0, AdamW, B 2,
#: S 1,024; 4 steps, a diag step after steps 2 and 4.
TRAIN_B, TRAIN_S, TRAIN_STEPS, TRAIN_DIAG = 2, 1024, 4, (2, 4)

#: The kernels a diag step launches, and how many times: each of the three
#: default probes launches row 1 on its maximin sample's (s, s) matrix and
#: twice in Hopkins, and row 3' once (``vat_from_dist``).
TRAIN_KERNELS = {"pairwise_dist": 9, "vat_prim_order": 3}
TRAIN_SYMBOLS = {"pairwise_dist": "pairwise_tile_kernel",
                 "vat_prim_order": "vat_prim_order_kernel"}


def card_state(torch, phase: str) -> None:
    """The card's name and power limit (nvidia-smi) and its free memory,
    before a phase."""
    free, total = torch.cuda.mem_get_info()
    log("card", before=phase, nvidia_smi=card_line(), free_gb=free / 1e9,
        total_gb=total / 1e9)


def train_flops(cfg, B: int, S: int) -> float:
    """f32 operations of one train step: the forward's products
    (``forward_flops``) and the vocabulary product, three times (forward,
    and the backward's two products per forward product), plus the layers'
    forward once more under ``remat="full"`` (recomputed in the
    backward)."""
    layers = forward_flops(cfg, B, S)
    head = 2.0 * B * S * cfg.d_model * cfg.padded_vocab
    return 3 * (layers + head) + (layers if cfg.remat == "full" else 0)


def adamw_bytes(params) -> int:
    """Bytes AdamW must move for f32 params: p, m and v read and written,
    the gradient read (28 bytes a parameter)."""
    return 28 * sum(t.numel() for t in tree_leaves(params))


def probe_kernels_vs_plain(torch, ref, ops, kern, rows, gen, label, s=128,
                           timed=False):
    """Rows 1 and 3' on a probe's own draws, against their plain versions:
    the maximin sample's (s, s) matrix and Hopkins's two blocks from the
    generator the probe program used (``gen``, fresh), then the Prim order
    of the sample's matrix, bit for bit the loop of plain masked argmins;
    ``timed`` adds ``probe_kernel_times``."""
    from repro_torch.core.hopkins import hopkins_draws, probe_count
    from repro_torch.core.svat import maximin_sample_from
    from repro_torch.core.vat import vat_order
    n = rows.shape[0]
    s = min(s, n)
    i0 = torch.randint(0, n, (), generator=gen, device=rows.device)
    cap = 4 * s
    hx = rows
    if n > cap:
        hx = rows.index_select(0, torch.randperm(
            n, generator=gen, device=rows.device)[:cap])
    sample = rows.index_select(0, maximin_sample_from(rows, s, i0))
    U, idx = hopkins_draws(hx, gen, probe_count(hx.shape[0]))
    out = {"sample": pairwise_vs_plain(
        torch, ref, kern["pairwise_dist"], sample, None, "euclidean", "gram",
        f"{label} sample")}
    out["hopkins_uniform"] = pairwise_vs_plain(
        torch, ref, kern["pairwise_dist"], U, hx, "euclidean", "gram",
        f"{label} hopkins U")
    out["hopkins_data"] = pairwise_vs_plain(
        torch, ref, kern["pairwise_dist"], hx.index_select(0, idx), hx,
        "euclidean", "gram", f"{label} hopkins data")
    R = ops.pairwise_dist(sample)
    got = vat_order(R)
    require(torch.equal(got, vat_order(R, argmin=ref.masked_argmin_ref)),
            f"{label}: vat_prim_order on the sample's matrix is not the "
            "loop's order")
    out["vat_prim_order"] = {"n": s, "bitwise_plain": True}
    out["shapes"] = {"sample": [s, s, rows.shape[1]],
                     "hopkins": [U.shape[0], hx.shape[0], rows.shape[1]]}
    if timed:
        out["timed"] = probe_kernel_times(torch, ref, kern, sample, U, hx, R)
    return out


def probe_kernel_times(torch, ref, kern, sample, U, hx, R) -> dict:
    """Rows 1 and 3' at a probe's shapes by CUDA events (100 calls after
    warm-up) beside their plain versions, ``torch.cdist`` and the bound:
    the (s, s) sample matrix, Hopkins's uniform block (m × 4s) and the
    Prim order of the sample's matrix."""
    from repro_torch.core.vat import vat_order
    out = {}
    for name, A, B in (("sample", sample, None), ("hopkins", U, hx)):
        m = None if B is None else B.shape[0]
        row = {"shape": [A.shape[0], A.shape[0] if m is None else m,
                         A.shape[1]],
               "ms": event_ms(torch, lambda: kern["pairwise_dist"](
                   A, B, metric="euclidean", form="gram"), reps=100),
               "plain_ms": event_ms(torch, lambda: ref.pairwise_dissim_ref(
                   A, B, metric="euclidean", form="gram"), reps=100),
               "library_ms": event_ms(torch, lambda: torch.cdist(
                   A, A if B is None else B), reps=100)}
        row["bound_ms"], row["bound_by"] = bound_ms(
            *pairwise_cost(A.shape[0], m, A.shape[1]))
        out[f"pairwise_dist_{name}"] = row
    n = R.shape[0]
    row = {"n": n, "ms": event_ms(torch, lambda: vat_order(R), reps=100),
           "plain_ms": event_ms(torch, lambda: vat_order(
               R, argmin=ref.masked_argmin_ref), reps=3, warmup=1),
           "library_ms": None}
    row["bound_ms"], row["bound_by"] = bound_ms(*prim_order_cost(n))
    out["vat_prim_order"] = row
    return out


def diag_split(torch, ref, ops, kern, cfg, mon, params, batch, step):
    """One diag step taken apart, by CUDA events: the tapped forward, the
    grad probe and each probe's trace (``_trace_parts`` with the program's
    generator), each trace equal bit for bit to the program's; then rows 1
    and 3' on each probe's draws against their plain versions."""
    from repro_torch.monitor import probes as P
    taps, taps_ms = event_once_ms(torch, lambda: P.probe_taps(
        cfg, params, batch))
    grads, grad_ms = event_once_ms(torch, lambda: P.probe_grads(
        cfg, params, batch, ("embed",)))
    traces, checks = {}, {}
    for i, spec in enumerate(mon.specs):
        arr = P._select(spec, params, taps, grads).detach()

        def gen():
            return torch.Generator(device=arr.device).manual_seed(
                P.probe_seed(mon.seed, step, i))
        parts, ms = event_once_ms(torch, lambda: P._trace_parts(
            arr, gen(), sample=spec.sample, thumbnail=spec.thumbnail))
        traces[spec.name] = {"ms": ms, "hopkins": float(parts[0]),
                             "block_score": float(parts[1]),
                             "k_est": float(parts[2])}
        checks[spec.name] = probe_kernels_vs_plain(
            torch, ref, ops, kern, P._rows(arr), gen(),
            f"train-gemma {spec.name}", s=spec.sample, timed=i == 0)
    return {"taps_forward_ms": taps_ms, "grad_probe_ms": grad_ms,
            "traces": traces}, checks


def phase_train_gemma(torch, ref, ops, kern, build, dev="cuda"):
    """The training slice at full width: gemma-2b (18 layers, d 2,048,
    vocabulary 256,000, ``remat="full"``), f32 weights from ``init_params``
    seed 0, AdamW (``warmup_steps=1``) through ``build_train_step(
    donate=True)``, B 2, S 1,024 from ``make_batch``; 4 steps, with
    ``TendencyMonitor.observe`` (``default_probes``) after steps 2 and 4.
    Checks: loss and gradient norm finite, the params moved, each probe's
    Hopkins and block score in [0, 1], rows 1 and 3' launched by the diag
    steps (the wrapper counts; the step-4 diag step is traced and the
    profiler's counts of the two kernels' symbols are printed beside
    them: a trace can lose launches) and held against their plain
    versions on the probes' own draws.  Returns the launches of the step-4 diag step
    by kernel."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.tokens import SyntheticCorpus, make_batch
    from repro_torch.monitor import TendencyMonitor
    from repro_torch.optim import adamw as O
    from repro_torch.train import steps as S
    from torch.profiler import ProfilerActivity, profile
    card_state(torch, "train-gemma")
    cfg = configs.get_config("gemma-2b")
    tc = TrainConfig(warmup_steps=1, total_steps=TRAIN_STEPS)
    base = peak_reset(torch)
    state, init_s = wall_s(torch, lambda: S.init_state(
        cfg, tc, torch.Generator(device=dev).manual_seed(0), device=dev))
    held_gb = (torch.cuda.memory_allocated() - base) / 1e9
    step = S.build_train_step(cfg, tc, donate=True)
    mon = TendencyMonitor(cfg, seed=0, device=dev)
    corpus = SyntheticCorpus(cfg.vocab, seed=tc.seed)
    shape = ShapeConfig("train", TRAIN_S, TRAIN_B, "train")
    before = {"embed": state.params["embed"][:8].clone(),
              "w_up": state.params["layers"]["w_up"][-1, :8].clone()}
    steps, diags, launches = [], {}, {}
    for i in range(TRAIN_STEPS):
        batch = {k: torch.as_tensor(v, device=dev) for k, v in make_batch(
            cfg, shape, step=i, corpus=corpus, device=dev).items()}
        (state, metrics), ms = event_once_ms(torch,
                                              lambda: step(state, batch))
        row = {k: float(v) for k, v in metrics.items()}
        require(all(np.isfinite(v) for v in row.values()),
                f"train-gemma step {i + 1}: metrics {row}")
        steps.append(dict(row, ms=ms))
        if i + 1 in TRAIN_DIAG:
            reset_counts(build)
            traced = i + 1 == TRAIN_STEPS
            tracer = (profile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA])
                      if traced else contextlib.nullcontext())
            with tracer as prof:
                summ, wall = wall_s(torch, lambda: mon.observe(
                    i + 1, state.params, batch))
            counts = build.launch_counts()
            missing = {k: counts.get(k, 0) for k, v in TRAIN_KERNELS.items()
                       if counts.get(k, 0) < v}
            require(not missing, f"train-gemma diag step {i + 1}: rows "
                    f"launched {missing}, want {TRAIN_KERNELS}")
            for name, s in summ.items():
                require(0 <= s["hopkins"] <= 1 and 0 <= s["block_score"] <= 1,
                        f"train-gemma probe {name} at step {i + 1}: {s}")
            diags[i + 1] = {"observe_ms": wall * 1e3, "probes": summ,
                            "traced": traced}
            launches = {k: v for k, v in counts.items() if v}
    by_symbol = kernel_counts(prof)
    profiled = {name: sum(n for k, n in by_symbol.items() if sym in k)
                for name, sym in TRAIN_SYMBOLS.items()} \
        if by_symbol else "not measured"
    split, checks = diag_split(torch, ref, ops, kern, cfg, mon,
                               state.params, batch, TRAIN_STEPS)
    same = all(split["traces"][n][f] == diags[TRAIN_STEPS]["probes"][n][f]
               for n in split["traces"]
               for f in ("hopkins", "block_score", "k_est"))
    moved = {k: float(torch.amax(torch.abs(v - (
        state.params["embed"][:8] if k == "embed"
        else state.params["layers"]["w_up"][-1, :8]))))
        for k, v in before.items()}
    require(all(v > 0 for v in moved.values()),
            f"train-gemma: params did not move: {moved}")
    # the optimizer alone, on one more step's gradients (a fifth update)
    _, grads = S.value_and_grad(state.params, cfg, batch)
    _, opt_ms = event_once_ms(torch, lambda: O.apply_opt(
        tc, state.params, grads, state.opt, donate=True))
    opt_bound = adamw_bytes(state.params) / PEAK_BYTES_PER_S * 1e3
    del grads
    flops = train_flops(cfg, TRAIN_B, TRAIN_S)
    warm = sorted(s["ms"] for s in steps[1:])
    step_ms = warm[len(warm) // 2]
    log("train-gemma", arch=cfg.name, layers=cfg.n_layers,
        d_model=cfg.d_model, vocab=cfg.padded_vocab, remat=cfg.remat,
        batch=TRAIN_B, seq=TRAIN_S, tokens=TRAIN_B * TRAIN_S,
        params_gb=params_gb(state.params), state_gb=held_gb, init_s=init_s,
        steps=steps, step_ms=step_ms, step_tflop=flops / 1e12,
        tflop_per_s=flops / step_ms / 1e9,
        step_bound_ms=flops / PEAK_F32_OPS_PER_S * 1e3,
        optimizer_ms=opt_ms, optimizer_bound_ms=opt_bound,
        optimizer_bound_by="bytes", diag=diags, diag_split=split,
        split_equals_observe=same, train_launches=launches,
        profiler_launches=profiled, profiler_shows_rows="not measured"
        if profiled == "not measured" else all(profiled.values()),
        kernels_vs_plain=checks, params_moved=moved,
        peak_gb=peak_gb(torch, base))
    require(same, "train-gemma: the diag step's split traces differ from "
            "the program's")
    del state, mon
    torch.cuda.empty_cache()
    return launches


def tree_ratio(torch, got, want) -> float:
    """The largest max |got - want| / max |want| over the leaves."""
    worst = 0.0
    for a, b in zip(tree_leaves(got), tree_leaves(want)):
        scale = float(torch.amax(torch.abs(b))) or 1.0
        worst = max(worst, float(torch.amax(torch.abs(
            a.float().cpu() - b.float()))) / scale)
    return worst


def phase_train_parity(torch, dev="cuda"):
    """The card's train step against the CPU's: phi3-mini-3.8b at full
    width and 1 layer, the same initial weights on both, B 1, S 128.  The
    loss, the gradient norm and every gradient leaf within 1e-4 of scale;
    then one AdamW update and one momentum-free Adafactor update with
    ``compress_grads`` on the CPU's gradients on both devices, the updated
    params within 1e-6 of scale."""
    from repro_torch import configs
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.tokens import make_batch
    from repro_torch.models import model as M
    from repro_torch.optim import adamw as O
    from repro_torch.optim import compression as C
    from repro_torch.train import steps as S
    card_state(torch, "train-parity")
    cfg = configs.get_config("phi3-mini-3.8b").replace(n_layers=1)
    base = peak_reset(torch)
    host = M.init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    params = tree_to(host, dev)
    batch = make_batch(cfg, ShapeConfig("parity", 128, 1, "train"),
                       device="cpu")
    (m_dev, g_dev), dev_s = wall_s(torch, lambda: S.value_and_grad(
        params, cfg, batch))
    (m_cpu, g_cpu), cpu_s = wall_s(torch, lambda: S.value_and_grad(
        host, cfg, batch))
    n_dev = float(O.clip_by_global_norm(g_dev, 1.0)[1])
    n_cpu = float(O.clip_by_global_norm(g_cpu, 1.0)[1])
    ratios = {"loss": abs(float(m_dev["loss"]) - float(m_cpu["loss"]))
              / abs(float(m_cpu["loss"])),
              "grad_norm": abs(n_dev - n_cpu) / n_cpu,
              "grads": tree_ratio(torch, g_dev, g_cpu)}
    require(all(r <= 1e-4 for r in ratios.values()),
            f"train-parity: card against CPU {ratios}, want <= 1e-4")
    del g_dev
    updates = {}
    for name, kw in (("adamw", {}),
                     ("adafactor_b1_0_compressed",
                      {"optimizer": "adafactor", "b1": 0.0,
                       "compress_grads": True})):
        tc = TrainConfig(warmup_steps=1, **kw)
        out = []
        for p, g in ((host, g_cpu), (params, tree_to(g_cpu, dev))):
            with torch.no_grad():
                if tc.compress_grads:
                    g, _ = C.compress(g, C.ef_init(p), tc.topk_frac)
                out.append(O.apply_opt(tc, p, g, O.init_opt(tc, p))[0])
        updates[name] = tree_ratio(torch, out[1], out[0])
    require(all(r <= 1e-6 for r in updates.values()),
            f"train-parity: updates on the same gradients {updates}, want "
            "<= 1e-6 of scale")
    log("train-parity", arch=cfg.name, layers=cfg.n_layers,
        d_model=cfg.d_model, batch=1, seq=128, ratio_over_scale=ratios,
        bound=1e-4, update_ratio_over_scale=updates, update_bound=1e-6,
        card_s=dev_s, cpu_s=cpu_s, peak_gb=peak_gb(torch, base))
    del params, host
    torch.cuda.empty_cache()


class timed_saves:
    """(step, bytes, s) of each ``ckpt.save`` while the block runs."""

    def __init__(self, ckpt):
        self.ckpt, self.saves = ckpt, []

    def __enter__(self):
        self.saved = self.ckpt.save

        def save(ckpt_dir, step, tree, **kw):
            t0 = time.perf_counter()
            path = self.saved(ckpt_dir, step, tree, **kw)
            s = time.perf_counter() - t0
            nbytes = sum(os.path.getsize(os.path.join(path, f))
                         for f in os.listdir(path))
            self.saves.append({"step": step, "bytes": nbytes, "s": s,
                               "gb_per_s": nbytes / s / 1e9})
            return path
        self.ckpt.save = save
        return self.saves

    def __exit__(self, *exc):
        self.ckpt.save = self.saved


def phase_train_resume(torch, dev="cuda"):
    """The loop on the card: ``train()`` of phi3-mini-3.8b at full width and
    1 layer, B 2, S 256, 6 steps, ``ckpt_every=3``, ``diag_every=3``,
    uninterrupted and interrupted after step 4 then resumed from the
    step-3 checkpoint: the same params and optimizer state bit for bit and
    the same tendency history (digest).  Checkpoints go under ``build/``;
    20 GB free there is required."""
    import shutil
    from repro_torch import configs
    from repro_torch.checkpoint import ckpt
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.monitor import AUX_NAME, TendencyHistory
    from repro_torch.train.loop import train
    card_state(torch, "train-resume")
    root = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    disk = shutil.disk_usage(root)
    log("train-resume-disk", path=root, total_gb=disk.total / 1e9,
        free_gb=disk.free / 1e9, want_free_gb=20)
    require(disk.free >= 20e9, f"train-resume: {disk.free / 1e9:.1f} GB "
            f"free under {root}, want 20")
    cfg = configs.get_config("phi3-mini-3.8b").replace(n_layers=1)
    shape = ShapeConfig("train", 256, 2, "train")
    base = peak_reset(torch)
    runs, logs = {}, []
    try:
        with timed_saves(ckpt) as saves:
            for name in ("full", "resumed"):
                tc = TrainConfig(total_steps=6, ckpt_every=3, diag_every=3,
                                 ckpt_dir=os.path.join(root, name))
                t0 = time.perf_counter()
                if name == "resumed":
                    try:
                        train(cfg, tc, shape, log=logs.append,
                              interrupt_at=4, device=dev)
                    except KeyboardInterrupt:
                        pass
                    else:
                        require(False, "train-resume: no interrupt")
                state, hist = train(cfg, tc, shape, log=logs.append,
                                    device=dev)
                torch.cuda.synchronize()
                history = TendencyHistory.from_arrays(
                    ckpt.load_aux(tc.ckpt_dir, AUX_NAME))
                runs[name] = {"state": dict(ckpt._walk(state)),
                              "history": history, "metrics": hist,
                              "s": time.perf_counter() - t0}
                del state
        a, b = runs["full"], runs["resumed"]
        require(list(a["state"]) == list(b["state"]),
                "train-resume: the states' leaves differ")
        differ = [k for k in a["state"]
                  if not torch.equal(a["state"][k], b["state"][k])]
        require(not differ, f"train-resume: resumed state differs from the "
                f"uninterrupted run's in {differ[:5]}")
        require(a["history"].steps == b["history"].steps == [3, 6]
                and a["history"].digest() == b["history"].digest(),
                f"train-resume: histories {a['history'].steps} "
                f"{b['history'].steps} digests differ")
        require(a["metrics"][3:] == b["metrics"],
                "train-resume: the resumed steps' metrics differ")
        require(any("[resume] restored step 3" in line for line in logs),
                "train-resume: the second run did not resume from step 3")
        log("train-resume", arch=cfg.name, layers=cfg.n_layers, batch=2,
            seq=256, steps=6, ckpt_every=3, diag_every=3, interrupt_at=4,
            leaves=len(a["state"]), same_state_bitwise=True,
            history_steps=a["history"].steps,
            history_digest=a["history"].digest(), same_history_digest=True,
            saves=saves, run_s={k: v["s"] for k, v in runs.items()},
            loss=[m["loss"] for m in a["metrics"]],
            peak_gb=peak_gb(torch, base))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    runs.clear()
    torch.cuda.empty_cache()


def phase_train(torch, ref, ops, kern, build, dev="cuda"):
    """The fifteenth slice: ``train-gemma``, ``train-parity`` and
    ``train-resume``.  Returns the launches of one diag step of the
    full-width phase by kernel."""
    launches = phase_train_gemma(torch, ref, ops, kern, build, dev)
    phase_train_parity(torch, dev)
    phase_train_resume(torch, dev)
    return launches


#: The dry run's cell (gemma-2b ``train_4k`` at its published config on
#: the 16 x 16 mesh of a fake world), the perf experiment beside it, and
#: the sweep of the ten smoke configs' train, prefill and decode steps on
#: the (4, 2) mesh of a fake world of 8 (``tools/dryrun_sweep.py``).
DRYRUN_OUT = os.path.join("build", "chip_smoke_dryrun.json")
#: rwkv6's prefill_32k on the same mesh: its WKV recurrence over 32,768
#: positions, which the dry run traces once (``models.common.scan``)
DRYRUN_RWKV_OUT = os.path.join("build", "chip_smoke_dryrun_rwkv.json")
#: deepseek-v3's train_4k at its optimized flags (experts over model x
#: data, group-limited routing), the same mesh: its moe dispatch and
#: combine keep the (E, cap, D) buffer expert-sharded
DRYRUN_DSV3_OUT = os.path.join("build", "chip_smoke_dryrun_dsv3.json")
#: its peak a rank must stay below half of the 774.23 GB a rank that
#: deepseek-v3's train_4k counted on this mesh while the moe dispatch held
#: its buffers whole on every rank
DSV3_PEAK_LIMIT = 774.23e9 / 2
#: gemma-2b train_4k's peak a rank and all-gathers on that mesh (torch
#: 2.11) while each layer's gathered weights were its checkpoint's saved
#: inputs: gathered inside the checkpointed body, the peak must fall below
#: the first and the backward's second gathers raise the second
DRYRUN_PEAK_OUTSIDE = 17.49e9
DRYRUN_GATHERS_OUTSIDE = 366
PERF_OUT = os.path.join("build", "chip_smoke_perf.json")
SWEEP_OUT = os.path.join("build", "chip_smoke_sweep.json")
HOST_RUNS: dict = {}

#: Ops the sweep may still unshard (``replicated_ops``), by (arch, kind):
#: {op: reason}.  Every other cell must unshard none.
SWEEP_REPLICATED_OK: dict = {}


def start_host_runs() -> None:
    """Start the dry run (gemma-2b ``train_4k``, rwkv6 ``prefill_32k`` and
    deepseek-v3 ``train_4k --optimized``), the perf experiment (``launch.perf --exp B2_ctx_vpad``: whisper decode
    on the fake world) and the smoke sweep as subprocesses that see no card
    (``CUDA_VISIBLE_DEVICES=""``): they trace on the host while the card
    phases run, and ``phase_dryrun`` reads them."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    for name, args, out in (
            ("dryrun", ["-m", "repro_torch.launch.dryrun", "--arch",
                        "gemma-2b", "--shape", "train_4k"], DRYRUN_OUT),
            ("dryrun-rwkv", ["-m", "repro_torch.launch.dryrun", "--arch",
                             "rwkv6-3b", "--shape", "prefill_32k"],
             DRYRUN_RWKV_OUT),
            ("dryrun-dsv3", ["-m", "repro_torch.launch.dryrun", "--arch",
                             "deepseek-v3-671b", "--shape", "train_4k",
                             "--optimized"], DRYRUN_DSV3_OUT),
            ("perf", ["-m", "repro_torch.launch.perf", "--exp",
                      "B2_ctx_vpad"], PERF_OUT),
            ("sweep", [os.path.join(ROOT, "tools", "dryrun_sweep.py")],
             SWEEP_OUT)):
        path = os.path.join(ROOT, out)
        if os.path.exists(path):
            os.remove(path)
        logf = open(path + ".log", "w")
        HOST_RUNS[name] = {
            "proc": subprocess.Popen(
                [sys.executable, *args, "--out", path], cwd=ROOT,
                env=env, stdout=logf, stderr=subprocess.STDOUT,
                start_new_session=True),
            "log": logf, "out": path, "t0": time.perf_counter()}


def stop_host_runs() -> None:
    """Kill what is left of the host runs (a failed smoke run)."""
    for run in HOST_RUNS.values():
        if run["proc"].poll() is None:
            with contextlib.suppress(ProcessLookupError):
                os.killpg(run["proc"].pid, 9)
            run["proc"].wait()
        run["log"].close()


def wait_host_run(name: str, deadline: float) -> dict:
    """The host run's records once it exits (before ``deadline`` on the
    perf clock), with its wall seconds."""
    run = HOST_RUNS[name]
    try:
        rc = run["proc"].wait(timeout=max(deadline - time.perf_counter(), 1))
    except subprocess.TimeoutExpired:
        stop_host_runs()
        raise SmokeFailure(f"{name}: the host run outlived its deadline")
    wall = time.perf_counter() - run["t0"]
    run["log"].close()
    with open(run["out"] + ".log") as f:
        tail = f.read()[-1500:]
    require(rc == 0 and os.path.exists(run["out"]),
            f"{name}: exit {rc}: {tail}")
    with open(run["out"]) as f:
        return {"records": json.load(f), "wall_s": wall}


def phase_launch_train(torch):
    """``python -m repro_torch.launch.train`` on the card: gemma-2b's
    smoke config for 4 steps, then resumed to 6 from its checkpoint
    (``diag_every`` 25: no diag step, so no kernel launch)."""
    import shutil
    ckpt = os.path.join(ROOT, "build", "chip_smoke_cli")
    shutil.rmtree(ckpt, ignore_errors=True)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               NCCL_SOCKET_IFNAME="lo")
    runs = []
    try:
        for steps in (4, 6):
            t0 = time.perf_counter()
            r = subprocess.run(
                [sys.executable, "-m", "repro_torch.launch.train", "--arch",
                 "gemma-2b", "--smoke", "--steps", str(steps), "--batch",
                 "2", "--seq", "128", "--ckpt-dir", ckpt], cwd=ROOT,
                env=env, capture_output=True, text=True, timeout=300)
            require(r.returncode == 0,
                    f"launch-train: exit {r.returncode}: {r.stderr[-1500:]}")
            lines = r.stdout.strip().splitlines()
            m = re.fullmatch(r"final loss (\S+) over (\d+) steps on 1 "
                             r"device\(s\)", lines[-1])
            require(m is not None and np.isfinite(float(m.group(1))),
                    f"launch-train: last line {lines[-1]!r}")
            require(any(ln.startswith("[device] cuda: ") for ln in lines),
                    "launch-train: the CLI did not run on cuda")
            runs.append({"steps": steps, "loss": float(m.group(1)),
                         "steps_run": int(m.group(2)),
                         "s": time.perf_counter() - t0, "lines": lines})
        require(any(ln.startswith("[resume] restored step 4")
                    for ln in runs[1]["lines"]),
                "launch-train: the second run did not resume from step 4")
        require([r["steps_run"] for r in runs] == [4, 2],
                f"launch-train: steps run {[r['steps_run'] for r in runs]}")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    log("launch-train", arch="gemma-2b (smoke)", batch=2, seq=128,
        steps=[4, 6], resumed_from=4, device=next(
            ln for ln in runs[0]["lines"] if ln.startswith("[device]")),
        loss=[r["loss"] for r in runs], run_s=[r["s"] for r in runs])


def phase_dryrun(torch, deadline: float):
    """The dry run's record (gemma-2b ``train_4k``, 16 x 16 of a fake
    world of 512 ranks, bfloat16, ``remat="full"``, ``seq_shard``): ok,
    FLOPs a rank > 0, all-gathers (FSDP over ``data``) beyond
    ``DRYRUN_GATHERS_OUTSIDE``, a peak a rank under 80 GB and under
    ``DRYRUN_PEAK_OUTSIDE`` (each layer gathered inside its checkpointed
    body); the roofline table at the card's constants; rwkv6
    ``prefill_32k``'s record on the same mesh: ok, FLOPs a rank > 0, its
    ``lower_s`` and collectives logged (no peak gate); deepseek-v3
    ``train_4k`` at its optimized flags: ok, no op unsharded, a peak a
    rank under ``DSV3_PEAK_LIMIT``;
    ``analytic_flops`` against ``train_flops`` for gemma-2b at B 2, S
    1,024; the perf experiment's record; and the smoke sweep: one line a
    cell, every cell ok, no op unsharded beyond ``SWEEP_REPLICATED_OK``.
    The counts are a fake world's, not times."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.launch import roofline
    dry = wait_host_run("dryrun", deadline)
    rec = dry["records"][0]
    require(rec.get("ok"), f"dryrun: {rec.get('error')}")
    colls = rec["collectives"]
    require(rec["flops_per_device"] > 0, "dryrun: no FLOPs counted")
    require(colls.get("all-gather", {}).get("count", 0) >= 1,
            f"dryrun: no all-gather in {colls}")
    require(rec["peak_bytes"] < min(80e9, DRYRUN_PEAK_OUTSIDE),
            f"dryrun: peak {rec['peak_bytes'] / 1e9:.2f} GB a rank, not "
            f"under {DRYRUN_PEAK_OUTSIDE / 1e9:.2f}")
    require(colls["all-gather"]["count"] > DRYRUN_GATHERS_OUTSIDE,
            f"dryrun: {colls['all-gather']['count']} all-gathers, not more "
            f"than {DRYRUN_GATHERS_OUTSIDE}: the backward does not gather "
            f"each layer again")
    cell = roofline.analyze(rec)
    gemma = get_config("gemma-2b")
    analytic = roofline.analytic_flops(gemma, ShapeConfig("t", 1024, 2,
                                                          "train"))
    log("dryrun", cell="gemma-2b train_4k 16x16", wall_s=dry["wall_s"],
        **{k: rec[k] for k in (
            "n_devices", "param_dtype", "lower_s", "flops_per_device",
            "bytes_accessed_per_device", "argument_bytes", "output_bytes",
            "temp_bytes", "peak_bytes", "collectives", "replicated_ops")},
        peak_gb=rec["peak_bytes"] / 1e9, roofline={
            "compute_s": cell.compute_s, "memory_s": cell.memory_s,
            "collective_s": cell.collective_s,
            "bottleneck": cell.bottleneck, "useful": cell.useful_ratio},
        gemma_b2_s1024_tflop={"analytic_flops": analytic["total"] / 1e12,
                              "train_flops": train_flops(gemma, 2, 1024)
                              / 1e12})
    print(roofline.markdown_table([rec]), flush=True)
    rwkv = wait_host_run("dryrun-rwkv", deadline)
    rrec = rwkv["records"][0]
    require(rrec.get("ok"), f"dryrun-rwkv: {rrec.get('error')}")
    require(rrec["flops_per_device"] > 0, "dryrun-rwkv: no FLOPs counted")
    log("dryrun-rwkv", cell="rwkv6-3b prefill_32k 16x16",
        wall_s=rwkv["wall_s"], **{k: rrec[k] for k in (
            "lower_s", "flops_per_device", "bytes_accessed_per_device",
            "temp_bytes", "peak_bytes", "collectives", "replicated_ops")})
    ds = wait_host_run("dryrun-dsv3", deadline)
    drec = ds["records"][0]
    require(drec.get("ok"), f"dryrun-dsv3: {drec.get('error')}")
    require(drec["replicated_ops"] == {},
            f"dryrun-dsv3: ops unsharded: {drec['replicated_ops']}")
    require(drec["peak_bytes"] < DSV3_PEAK_LIMIT,
            f"dryrun-dsv3: peak {drec['peak_bytes'] / 1e9:.2f} GB a rank, "
            f"not under {DSV3_PEAK_LIMIT / 1e9:.2f}")
    log("dryrun-dsv3", cell="deepseek-v3-671b train_4k 16x16 (optimized)",
        wall_s=ds["wall_s"], peak_gb=drec["peak_bytes"] / 1e9,
        **{k: drec[k] for k in (
            "overrides", "lower_s", "flops_per_device",
            "bytes_accessed_per_device", "argument_bytes", "temp_bytes",
            "peak_bytes", "collectives", "replicated_ops")})
    perf = wait_host_run("perf", deadline)
    prec = perf["records"][0]
    require(prec.get("ok"), f"dryrun-perf: {prec.get('error')}")
    log("dryrun-perf", exp=prec["exp"], wall_s=perf["wall_s"],
        **{k: prec[k] for k in ("arch", "shape", "mesh", "overrides",
                                "flops_per_device", "peak_bytes",
                                "collectives", "replicated_ops")})
    print(roofline.markdown_table([prec]), flush=True)
    check_sweep(wait_host_run("sweep", deadline))


def check_sweep(sweep: dict) -> None:
    """The smoke sweep's lines (``tools/dryrun_sweep.py --out``): one log
    line a cell; all 30 ok; no op unsharded beyond
    ``SWEEP_REPLICATED_OK``."""
    cells = sweep["records"]
    require(len(cells) == 30, f"dryrun-sweep: {len(cells)} cells, not 30")
    for c in cells:
        log("dryrun-sweep", arch=c["arch"], kind=c["kind"], ok=c["ok"],
            s=c["s"], **({k: c[k] for k in ("collectives", "replicated_ops",
                                           "flops_per_device", "peak_bytes")}
                         if c["ok"] else {"error": c["error"],
                                          "at": c["at"]}))
    bad = [(c["arch"], c["kind"], c.get("error")) for c in cells
           if not c["ok"]]
    require(not bad, f"dryrun-sweep: cells failed: {bad}")
    extra = {(c["arch"], c["kind"]): {
        op: n for op, n in c["replicated_ops"].items()
        if op not in SWEEP_REPLICATED_OK.get((c["arch"], c["kind"]), {})}
        for c in cells}
    extra = {k: v for k, v in extra.items() if v}
    require(not extra, f"dryrun-sweep: ops unsharded beyond "
            f"SWEEP_REPLICATED_OK: {extra}")
    log("dryrun-sweep-total", cells=len(cells), wall_s=sweep["wall_s"],
        unsharded={f"{c['arch']} {c['kind']}": c["replicated_ops"]
                   for c in cells if c["replicated_ops"]})


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs a CUDA GPU", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sys.path.insert(0, os.path.join(ROOT, "src"))
    sys.path.append(os.path.join(ROOT, "tools"))
    import repro_torch as rt
    from repro_torch import core
    from repro_torch.core.hopkins import probe_count
    from repro_torch.core.vat import _streamed_seed_pivot, vat_order
    from repro_torch.kernels import _build as build
    from repro_torch.kernels import ops, ref
    from repro_torch.api import registry
    from repro_torch.kernels import ivat_update as ivu
    from repro_torch.kernels.knn_graph import knn_topk_blocked, knn_topk_cuda
    from repro_torch.kernels.pairwise_dist import pairwise_dist_cuda
    from repro_torch.kernels.prim_persist import prim_persist_cuda
    from repro_torch.kernels.prim_stream import (prim_frontier_step_cuda,
                                                prim_stream_step_cuda)
    from repro_torch.kernels.prim_update import (masked_argmin_cuda,
                                                 vat_prim_order_cuda)
    import torch.distributed as dist
    from repro_torch.serve import ServeConfig, TendencyServer
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "repro" or m.startswith("repro.")]
    require(not bad, f"the port imported {bad}")

    t0 = time.perf_counter()
    start_host_runs()
    card = phase_environment(torch, build)
    gen = torch.Generator(device="cuda").manual_seed(0)
    errs = {"pairwise_dist": check_pairwise(torch, ref, ops,
                                            pairwise_dist_cuda, probe_count,
                                            gen),
            "masked_argmin": check_argmin(torch, ref, masked_argmin_cuda,
                                          gen),
            "vat_prim_order": check_vat_prim(torch, ref, ops,
                                             vat_prim_order_cuda, vat_order,
                                             gen)}
    launches, walls, rstars, big_launches = phase_main_path(
        torch, rt, ref, ops, build, vat_order)
    errs["ivat_from_vat"], R8 = check_ivat(torch, ref, ops, core, rstars)
    kernels = {"pairwise_dist": pairwise_dist_cuda,
               "masked_argmin": masked_argmin_cuda,
               "vat_prim_order": vat_prim_order_cuda}
    phase_profile(torch, rt, blobs(2048, 64, k=8, seed=0))
    flash = phase_flash_path(torch, rt, ref, ops, build, core,
                             prim_persist_cuda, prim_stream_step_cuda,
                             _streamed_seed_pivot)
    phase_profile(torch, rt, blobs(50_000, 64, k=8, seed=0),
                  label="flashvat n=50000")
    persist, step = phase_flash_times(torch, ref, ops, flash,
                                      prim_stream_step_cuda,
                                      prim_persist_cuda, _streamed_seed_pivot)
    rows = phase_times(torch, ref, kernels, rstars, gen, errs, launches,
                       big_launches)
    ivat = phase_ivat_times(torch, ref, ivu, rstars, R8, card)
    del R8
    row4 = ivat["n=2048"]
    rows.append({
        "name": "ivat_from_vat", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/ivat_update.cu",
        "replaces": "src/repro/kernels/ivat_update.py:73",
        "launches": launches["ivat_from_vat"],
        "max_abs_err": errs["ivat_from_vat"], "ms": row4["ms"],
        "timer": "cuda events", "profiler_ms": row4["profiler_ms"],
        "plain_ms": row4["plain_ms"], "bound_ms": row4["bound_ms"],
        "bound_by": row4["bound_by"], "library_ms": None,
        "library_ms_why": "no single PyTorch call computes minimax path "
                          "distances",
        "lanes_by_route": row4["lanes_by_route"],
        "serial_route_ms": row4["serial_route_ms"],
        "ms_by_input": {k: v["ms"] for k, v in ivat.items()},
        "bound_ms_by_input": {k: v["bound_ms"] for k, v in ivat.items()}})
    errs["prim_persist"] = persist["plain_edges_max_abs_err"]
    errs["prim_stream_step"] = flash["step_err"]
    for row, path_launches, source, replaces in (
            (persist, flash["launches"],
             "src/repro_torch/kernels/csrc/prim_persist.cu",
             "src/repro/kernels/prim_persist.py:319"),
            (step, flash["step_launches"],
             "src/repro_torch/kernels/csrc/prim_stream.cu",
             "src/repro/kernels/prim_stream.py:218")):
        name = row["kernel"]
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces,
                     "launches": path_launches[name],
                     "max_abs_err": errs[name], "ms": row["ms"],
                     "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                     "bound_by": row["bound_by"],
                     "library_ms": row["library_ms"],
                     **{k: row[k] for k in ("event_ms", "l2_floor_ms")
                        if k in row}})
    # the sharded path: the frontier kernel, then the engine over NCCL
    frontier_err = check_frontier_kernel(torch, ref, prim_frontier_step_cuda,
                                         gen)
    init_world_of_one(torch, dist)
    shard_launches, _ = phase_shard_path(torch, rt, ref, core, build, flash)
    rows.append(phase_frontier_times(torch, ref, prim_frontier_step_cuda,
                                     flash, frontier_err, shard_launches))
    phase_dvat(torch, rt, core, build)
    dist.destroy_process_group()
    Xk, knn_err = phase_knn_kernel(torch, ref, ops, knn_topk_cuda,
                                   knn_topk_blocked, pairwise_dist_cuda, gen)
    phase_approx_exact(torch, rt, ops, build, core)
    phase_approx_full_k(torch, rt, ref, build)
    approx_launches, Xa = phase_approx_path(torch, rt, ops, build, core,
                                            registry)
    phase_profile(torch, rt, demo_blobs(1_000_000)[0],
                  label="approx n=1000000")
    rows.append(phase_knn_times(torch, ref, knn_topk_cuda, Xk,
                                approx_launches, knn_err))
    rows.append(phase_knn_segmented(torch, ref, core, build, Xa,
                                    approx_launches, card))
    del Xk, Xa
    # the batched path: fit_many through the batched kernels
    errs.update(check_batch_kernels(torch, ref, gen, card))
    vat_launches, Xv = phase_batch_vat(torch, rt, ops, build, card)
    step_launches, Xf = phase_batch_flash(torch, rt, ops, core, build, card)
    phase_profile(torch, rt, Xf, label="flashvat fit_many b=4 n=50000",
                  many=True)
    rows.append(phase_knn_batch(torch, ref, build, gen, card))
    rows += phase_batch_times(torch, ref, ops, Xv, Xf, errs, vat_launches,
                              step_launches, card)
    # the eleventh slice: bigvat, streaming, the paper's evaluation, faults
    t_new = time.perf_counter()
    fv_big, X_big, assign_row = phase_bigvat_path(torch, rt, ref, ops, build,
                                                  core, card)
    phase_bigvat_memmap(torch, rt, fv_big, X_big)
    del fv_big, X_big
    phase_streaming(torch, core)
    phase_paper_eval(torch, rt, core)
    phase_cluster_scale(torch, core, build)
    phase_fault_site(torch, ops)
    new_s = time.perf_counter() - t_new
    # the twelfth slice: the serving layer on the card
    t_serve = time.perf_counter()
    served = phase_serve_mixed(torch, rt, build, card)
    phase_serve_pad(torch, rt, card)
    with TendencyServer(ServeConfig(window_s=0.001)) as srv:
        phase_serve_warm(torch, srv, card, {
            "vat_prim_order_kernel": next(
                r["ms"] for r in rows if r["name"] == "vat_prim_order"),
            "prim_persist_kernel": persist["ms"]})
        phase_serve_slo(torch, rt, srv, card)
    phase_serve_chaos(torch, card)
    serve_s = time.perf_counter() - t_serve
    # the thirteenth slice: the embed rung on the model zoo's forward
    t_embed = time.perf_counter()
    kern = {"pairwise_dist": pairwise_dist_cuda,
            "prim_persist": prim_persist_cuda,
            "seed_pivot": _streamed_seed_pivot}
    embedded = phase_embed(torch, rt, core, ref, ops, kern, build)
    embed_s = time.perf_counter() - t_embed
    # the fourteenth slice: the moe (MLA, MTP), ssm, hybrid and audio
    # families, the router probe, prefill and decode
    t_fam = time.perf_counter()
    for k, v in phase_families(torch, rt, core, ref, ops, kern,
                               build).items():
        embedded[k] = embedded.get(k, 0) + v
    family_s = time.perf_counter() - t_fam
    # the fifteenth slice: training at full width, parity, resume
    t_train = time.perf_counter()
    trained = phase_train(torch, ref, ops, kern, build)
    train_s = time.perf_counter() - t_train
    # the sixteenth slice: the launchers
    t_launch = time.perf_counter()
    phase_launch_train(torch)
    phase_dryrun(torch, deadline=t0 + 1_120)
    launch_s = time.perf_counter() - t_launch
    for row in rows:
        if row["name"] in served:
            row["served_launches"] = served[row["name"]]
        if row["name"] in embedded:
            row["embed_launches"] = embedded[row["name"]]
        row["train_launches"] = trained.get(row["name"], 0)
    row1 = next(r for r in rows if r["name"] == "pairwise_dist")
    row1["assignment_block"] = assign_row
    row1["ms_by_shape"]["4096x256x8"] = assign_row["ms"]
    row1["bound_ms_by_shape"]["4096x256x8"] = assign_row["bound_ms"]
    phase_certify(torch)
    log("done", total_s=time.perf_counter() - t0, new_phases_s=new_s,
        serve_phases_s=serve_s, embed_phases_s=embed_s,
        family_phases_s=family_s, train_phases_s=train_s,
        launch_phases_s=launch_s)
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        sys.exit(1)
    finally:
        stop_host_runs()
