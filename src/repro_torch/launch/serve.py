"""Serving launcher: synthetic concurrent load against TendencyServer.

Drives the real serving path on the card — build the program cache, fire
``--requests`` fits from ``--concurrency`` client threads, and report the
latency distribution (p50/p99), throughput, and scheduler counters
(coalesce rate, cache hits/misses/evictions, timeouts), beside the
device it ran on:

  PYTHONPATH=src python -m repro_torch.launch.serve --smoke
  PYTHONPATH=src python -m repro_torch.launch.serve --requests 64 \
      --concurrency 8 --sizes 90,120,200 --window-ms 5 --slo-ms 50
  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu

``--device cpu`` runs the plain PyTorch versions of the kernels (its
times are the CPU's, not the card's).
"""
from __future__ import annotations

import argparse
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

import torch

from repro_torch.serve import ServeConfig, TendencyServer


def _datasets(sizes: list[int], count: int, d: int, seed: int):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(count):
        n = sizes[i % len(sizes)]
        half = n // 2
        out.append(np.concatenate([
            rng.normal(size=(half, d)),
            rng.normal(size=(n - half, d)) + 7.0,
        ]).astype(np.float32))
    return out


def _pct(values: list[float], q: float) -> float:
    return float(np.percentile(np.asarray(values), q))


def main() -> None:
    ap = argparse.ArgumentParser(
        description="concurrent-load driver for the tendency server")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--concurrency", type=int, default=8)
    ap.add_argument("--window-ms", type=float, default=2.0)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--sizes", default="90,120,200",
                    help="comma-separated per-request point counts")
    ap.add_argument("--dim", type=int, default=4)
    ap.add_argument("--metric", default="euclidean")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="route through the cost-model router under "
                         "this latency budget")
    ap.add_argument("--timeout-s", type=float, default=120.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the fits run: cuda (the CUDA kernels, "
                         "default) or cpu (their plain PyTorch versions)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny fixed workload (CI-sized)")
    args = ap.parse_args()

    if args.smoke:
        args.requests, args.concurrency = 16, 4
        args.sizes, args.window_ms = "48,60", 5.0

    sizes = [int(s) for s in args.sizes.split(",") if s]
    data = _datasets(sizes, args.requests, args.dim, args.seed)
    config = ServeConfig(window_s=args.window_ms / 1e3,
                         max_batch=args.max_batch, device=args.device)

    with TendencyServer(config) as server:
        for n in sizes:  # no build inside the measured window: warm
            # the key the requests resolve (incl. SLO routing), at every
            # lane bucket a coalesced group can form
            b = 1
            while b <= args.max_batch:
                server.warm(n, args.dim, metric=args.metric,
                            slo_ms=args.slo_ms, batch=b)
                b *= 2

        latencies: list[float] = []

        def one(X) -> float:
            t0 = time.perf_counter()
            server.fit(X, metric=args.metric, slo_ms=args.slo_ms,
                       timeout_s=args.timeout_s)
            return time.perf_counter() - t0

        t_wall = time.perf_counter()
        with ThreadPoolExecutor(max_workers=args.concurrency) as pool:
            latencies = list(pool.map(one, data))
        t_wall = time.perf_counter() - t_wall
        stats = server.stats()

    qps = args.requests / max(t_wall, 1e-9)
    dev = torch.device(args.device)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu (plain PyTorch versions)")
    print(f"{args.requests} requests x {args.concurrency} clients, "
          f"sizes {sizes}, window {args.window_ms:.1f} ms, on {where}")
    print(f"latency p50 {1e3 * _pct(latencies, 50):.2f} ms   "
          f"p99 {1e3 * _pct(latencies, 99):.2f} ms   "
          f"throughput {qps:.1f} req/s")
    c = stats.cache
    print(f"batches {stats.dispatched_batches} "
          f"(coalesce rate {stats.coalesce_rate:.2f} req/batch)   "
          f"cache {c.hits} hits / {c.misses} misses / "
          f"{c.evictions} evictions   timeouts {stats.timeouts}   "
          f"rejected {stats.rejected}")


if __name__ == "__main__":
    main()
