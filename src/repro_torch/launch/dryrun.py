"""Dry run on a fake world: trace every (arch x shape x mesh) cell's step at
its production sharding, with no card and no data.

As ``repro/launch/dryrun.py``, which AOT-compiles each cell against 512
fake XLA host devices.  Here a fake process group of 512 ranks
(``torch.distributed``'s "fake" backend: every collective returns at once
and moves nothing) stands in for them; the 16 x 16 mesh takes the first
256.  Params, optimizer state, cache and
batch are ``DTensor``s on the production mesh with the shardspecs'
placements, over local tensors on the "meta" device (shapes and dtypes,
no storage), and the port's own step runs on them: ``build_train_step``,
``forward`` or ``build_serve_step``, as the reference's ``lower_cell``.
(``FakeTensorMode`` local tensors would do as well, but its fake
``arange`` breaks DTensor's ``_StridedShard`` size arithmetic, which the
sequence-sharded reshapes reach; "meta" tensors carry the same shapes.)

The record keeps the reference's keys, each a count on rank 0 of the
traced step, never a time on a card:

* ``flops_per_device`` — ``torch.utils.flop_counter``'s formulas on the
  *local* shapes of every product rank 0 runs (``FlopCounterMode`` itself
  sees a ``DTensor`` op's global shapes, so ``Census`` counts beneath the
  ``DTensor`` dispatch instead);
* ``collectives`` — kind -> {count, bytes} a rank: the count from
  ``CommDebugMode``, the bytes from the result's local shape (as the
  reference sums result shapes).  On the CPU-typed mesh of the fake world
  ``DTensor`` makes a shard-to-shard move (an all-to-all on NCCL) an
  all-gather and a local chunk, so such moves count as all-gathers;
* ``argument_bytes`` / ``output_bytes`` — the step's inputs' and outputs'
  local storage, each storage once; ``temp_bytes`` — the most storage the
  step held live beyond its arguments, ``peak_bytes`` their sum (live
  storage counted as it is made and freed: no allocator rounding or
  fragmentation);
* ``bytes_accessed_per_device`` — every local op's operands and results
  (unfused, so more than XLA's fused count);
* ``lower_s`` — the tracing wall time; ``compile_s`` is 0, since there is
  no compile step.

An op that ``DTensor`` cannot carry a partial value through takes its
input through ``models.sharding.settle`` first (the vocab-parallel
lookup and gather).  A torch function that ``DTensor`` cannot shard as
its inputs lie (no rule for the op, or a view that would split or merge a
sharded dim: which ones depends on the torch version) is run again on
unsharded inputs (``ReplicateFallback``); the census shows what that
costs, and the record's ``replicated_ops`` counts them by name.  A cell
that still fails is recorded ``ok: false`` with its error, and the run
carries on.

Usage:
  python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out results.json]
  python -m repro_torch.launch.dryrun --all --both-meshes --jobs 7 \
      --cell-timeout 2700 --out build/dryrun_all.json

``--out`` keeps every record, and a run with the same ``--out`` skips the
cells already ok, so a sweep resumes across runs.  ``--jobs`` traces each
cell in a process of its own (a record then also has the cell's
``wall_s`` and the process's ``host_peak_rss_gb``), and ``--cell-timeout``
records a cell that outlives it as not traced, with that cause.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import (tree_flatten, tree_leaves, tree_map_only,
                                 tree_unflatten)
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs import ARCHS, SHAPES, SUBQUADRATIC, cells, get_config
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.data.tokens import input_specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.shardspecs import (batch_shardings, cache_shardings,
                                           state_shardings)
from repro_torch.models import model as M
from repro_torch.models import sharding
from repro_torch.train import steps as S

# best-known beyond-paper flags per arch (the reference's EXPERIMENTS.md
# §Perf); all exact except route_groups (routing-local variant)
OPTIMIZED = {
    "deepseek-v3-671b": {"ep2d": True, "ce_chunk": 512, "momentum": False,
                         "route_groups": 8, "route_top_groups": 4},
    "whisper-large-v3": {"vocab_pad": 256, "head_pad": 32, "ce_chunk": 512},
    "internvl2-1b": {"vocab_pad": 256, "ce_chunk": 512},
    "*": {"ce_chunk": 512},
}

#: functional collectives -> the reference's HLO kind names
_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}


def optimized_overrides(arch: str, kind: str) -> dict:
    over = dict(OPTIMIZED.get(arch, OPTIMIZED["*"]))
    if kind != "train":  # train-only knobs
        over.pop("ce_chunk", None)
        over.pop("momentum", None)
    return over


def _train_config(cfg, momentum: bool = True) -> TrainConfig:
    # adafactor for the 671B config (factored 2nd moment), adamw otherwise
    opt = "adafactor" if cfg.name.startswith("deepseek") else "adamw"
    return TrainConfig(optimizer=opt, b1=0.9 if momentum else 0.0)


def fake_world(n: int = 512) -> None:
    """Make the default process group a fake world of ``n`` ranks (this
    process is rank 0), replacing any other.  Keep one world a process:
    the group names of a destroyed world can be found again by the next
    one's collectives, which then take the old group's size."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == n:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


# ----------------------------------------------------------- fallback ----

#: what ``DTensor`` raises for an op it cannot shard as its inputs lie
#: (the last: an index error of some versions' padding rule)
_NO_RULE = ("Sharding propagation failed",
            "does not have a sharding strategy",
            "without redistribution",
            "list index out of range")


def _unshard(t, mesh_dims):
    """``t`` redistributed to ``Replicate`` on the given mesh dims."""
    from torch.distributed.tensor import Replicate
    pl = tuple(Replicate() if j in mesh_dims else p
               for j, p in enumerate(t.placements))
    return t if pl == tuple(t.placements) else t.redistribute(
        t.device_mesh, pl)


def _unshard_tries(flat, idx):
    """The unsharded inputs to try, cheapest first: one mesh dim of one
    input (the last mesh dim first: "model" before "data"), then every
    mesh dim but those sharding an input's batch dim 0, of one input, then
    of all."""
    from torch.distributed.tensor import Shard
    tries = []
    for i in idx:
        pl = flat[i].placements
        tries += [{i: [j]} for j in reversed(range(len(pl)))
                  if not pl[j].is_replicate()]

    def off_batch(i):
        return [j for j, p in enumerate(flat[i].placements)
                if not (isinstance(p, Shard) and p.dim == 0)]
    tries += [{i: off_batch(i)} for i in idx]
    tries.append({i: off_batch(i) for i in idx})
    return tries


class ReplicateFallback(TorchDispatchMode):
    """Runs an op that ``DTensor`` cannot shard as its inputs lie by
    unsharding inputs first (what ``models.sharding.hint`` to ``Replicate``
    does), cheapest first (``_unshard_tries``); an op with no rule at all
    runs on every rank's whole copy of its inputs, its results replicated.
    An in-place op works on the unsharded copy and writes it back.  It
    acts on aten ops, so the backward's are covered too.  The census counts the collectives this
    costs (a try that fails is taken out of ``census`` and ``comm``
    again); ``ops`` counts the ops that needed it, by name."""

    def __init__(self, census=None, comm=None):
        super().__init__()
        self.ops: dict[str, int] = {}
        self._census, self._comm = census, comm

    def _snapshot(self):
        c, m = self._census, self._comm
        return (None if c is None else (c.flops, c.accessed, {
            k: dict(v) for k, v in c.coll.items()}),
            None if m is None else dict(m.comm_counts))

    def _restore(self, snap) -> None:
        if snap[0] is not None:
            c = self._census
            c.flops, c.accessed, c.coll = snap[0]
        if snap[1] is not None:
            self._comm.comm_counts.clear()
            self._comm.comm_counts.update(snap[1])

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if not any(issubclass(t, DTensor) for t in types):
            return func(*args, **kwargs)
        try:
            return func(*args, **kwargs)
        except Exception as e:  # noqa: BLE001 — DTensor's own errors
            if not any(s in str(e) for s in _NO_RULE):
                raise
            first = e
        name = func.name().split("::")[-1]
        self.ops[name] = self.ops.get(name, 0) + 1
        flat, tree = tree_flatten((args, kwargs))
        idx = [i for i, t in enumerate(flat) if isinstance(t, DTensor)]
        for which in _unshard_tries(flat, idx):
            snap = self._snapshot()
            trial = list(flat)
            for i, dims in which.items():
                trial[i] = _unshard(flat[i], dims)
            try:
                return self._run(func, flat, trial, tree, local=False)
            except Exception as e:  # noqa: BLE001
                if not any(s in str(e) for s in _NO_RULE):
                    raise
                self._restore(snap)
        trial = list(flat)
        for i in idx:
            trial[i] = _unshard(flat[i], range(flat[i].device_mesh.ndim))
        try:
            return self._run(func, flat, trial, tree, local=True)
        except Exception:  # noqa: BLE001
            raise first from None

    @staticmethod
    def _run(func, flat, trial, tree, *, local: bool):
        """``func`` on the trial inputs (their local tensors with
        ``local``: every rank's whole copy), results as ``DTensor``s, an
        in-place op's write copied back into its own input."""
        from torch.distributed.tensor import DTensor, Replicate
        mesh = next(t for t in trial if isinstance(t, DTensor)).device_mesh
        if local:
            trial = [t.to_local() if isinstance(t, DTensor) else t
                     for t in trial]
        a, k = tree_unflatten(trial, tree)
        out = func(*a, **k)
        if local:
            out = tree_map_only(torch.Tensor, lambda o: DTensor.from_local(
                o, mesh, [Replicate()] * mesh.ndim, run_check=False), out)
        if func._schema.is_mutable and trial[0] is not flat[0]:
            src = out if isinstance(out, DTensor) else a[0]
            if local:
                src = DTensor.from_local(a[0], mesh,
                                         [Replicate()] * mesh.ndim,
                                         run_check=False)
            flat[0].copy_(src.redistribute(mesh, flat[0].placements))
            return flat[0]
        return out


# ------------------------------------------------------------- census ----

def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class Census(TorchDispatchMode):
    """Per-rank counts of the ops that run on local tensors: product
    FLOPs, collectives' result bytes, operand and result bytes, and live
    storage.  A ``DTensor`` op is passed on (``NotImplemented``), so the
    mode sees the local ops and collectives it turns into; the ops by which
    ``DTensor`` propagates global shapes (on fake or "meta" tensors, by
    version) are not counted: ``shape_propagation`` marks them."""

    def __init__(self, args):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop = flop_registry
        self.flops = 0
        self.accessed = 0
        self.coll: dict[str, dict] = {}
        self.live = self.peak = 0
        self.shape_only = 0
        self._seen = WeakIdKeyDictionary()
        for t in _locals(args):
            self._seen[t.untyped_storage()] = True

    def _free(self, n: int) -> None:
        self.live -= n

    def _track(self, out) -> None:
        for t in tree_leaves(out):
            if not isinstance(t, torch.Tensor):
                continue
            st = t.untyped_storage()
            if st in self._seen:
                continue
            self._seen[st] = True
            n = st.nbytes()
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self.shape_only or any(isinstance(t, FakeTensor)
                                  for t in tree_leaves(args)):
            return out    # DTensor's sharding propagation at global shapes
        packet = func._overloadpacket
        if packet in self._flop:
            self.flops += self._flop[packet](*args, **kwargs, out_val=out)
        kind = _KINDS.get(packet.__name__) \
            if func.namespace == "_c10d_functional" else None
        if kind is not None:
            rec = self.coll.setdefault(kind, {"count": 0, "bytes": 0})
            rec["bytes"] += sum(_nbytes(t) for t in tree_leaves(out)
                                if isinstance(t, torch.Tensor))
        self.accessed += sum(_nbytes(t) for t in tree_leaves((args, out))
                             if isinstance(t, torch.Tensor))
        self._track(out)
        return out


@contextlib.contextmanager
def shape_propagation(census: Census):
    """Marks, on ``census``, the ops that ``DTensor``'s sharding
    propagator runs at global shapes to learn an output's shape (its
    ``_propagate_tensor_meta*`` methods, wrapped while this lasts)."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    saved = {}
    for name, raw in vars(ShardingPropagator).items():
        if not name.startswith("_propagate_tensor_meta") or isinstance(
                raw, (staticmethod, classmethod)) or not callable(raw):
            continue

        def marked(self, *a, _fn=raw, **k):
            census.shape_only += 1
            try:
                return _fn(self, *a, **k)
            finally:
                census.shape_only -= 1
        saved[name] = raw
        setattr(ShardingPropagator, name, marked)
    try:
        yield
    finally:
        for name, raw in saved.items():
            setattr(ShardingPropagator, name, raw)


def parse_collectives(comm, census: Census) -> dict:
    """The reference's census of collectives, kind -> {count, bytes} a
    rank: counts from ``CommDebugMode``, result bytes from ``Census``."""
    counts = {}
    for packet, n in comm.get_comm_counts().items():
        name = getattr(packet, "__name__", str(packet)).split(".")[-1]
        kind = _KINDS.get(name, name)
        counts[kind] = counts.get(kind, 0) + n
    return {kind: {"count": counts.get(kind, 0), "bytes": rec["bytes"]}
            for kind, rec in census.coll.items()}


def _locals(tree):
    """The local tensors of a tree's tensors, each storage once."""
    from torch.distributed.tensor import DTensor
    seen, out = set(), []
    for t in tree_leaves(tree):
        if isinstance(t, DTensor):
            t = t._local_tensor
        if isinstance(t, torch.Tensor):
            key = id(t.untyped_storage())
            if key not in seen:
                seen.add(key)
                out.append(t)
    return out


def _storage_bytes(tree) -> int:
    return sum(t.untyped_storage().nbytes() for t in _locals(tree))


# ---------------------------------------------------------- the cells ----

def stand_in(t: torch.Tensor, ns, mesh):
    """A ``DTensor`` of ``t``'s global shape and dtype with placements
    ``ns.placements``, over a "meta" local tensor."""
    from torch.distributed.tensor import DTensor, Shard
    local = list(t.shape)
    for i, p in enumerate(ns.placements):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    loc = torch.empty(local, dtype=t.dtype, device="meta")
    return DTensor.from_local(loc, mesh, ns.placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute(tree, shardings, mesh, leaf=stand_in):
    """``tree`` (dicts, NamedTuples, tuples, None, tensors) with each
    tensor ``t`` as ``leaf(t, its sharding, mesh)``: by default a
    ``DTensor`` stand-in with the sharding's placements."""
    if tree is None:
        return None
    if isinstance(tree, torch.Tensor):
        return leaf(tree, shardings, mesh)
    if isinstance(tree, dict):
        return {k: distribute(v, shardings[k], mesh, leaf)
                for k, v in tree.items()}
    parts = [distribute(v, s, mesh, leaf) for v, s in zip(tree, shardings)]
    return type(tree)(*parts) if hasattr(tree, "_fields") else tuple(parts)


def _pick_cfg(cfg: ModelConfig, kind: str, over: dict) -> ModelConfig:
    over = dict(over)
    if kind == "train":
        over.setdefault("remat", "full")
        over.setdefault("seq_shard", True)
    else:
        over.setdefault("remat", "none")
        over.setdefault("mtp", False)   # MTP head is train-only
    return cfg.replace(**over)


def build_step(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               tc: TrainConfig | None = None,
               param_dtype=torch.bfloat16):
    """(step, args) of one cell on ``mesh``: ``step(*args)`` runs the
    port's train step (state donated), forward or serve step on
    ``DTensor`` stand-ins at the production shardings."""
    specs = input_specs(cfg, shape, dtype=param_dtype)
    b_sh = batch_shardings(cfg, mesh, specs)
    batch = distribute(specs, b_sh, mesh)
    gen = torch.Generator()
    if shape.kind == "train":
        tc = tc or _train_config(cfg)
        st = S.init_state(cfg, tc, gen, param_dtype, device="meta")
        state = distribute(st, state_shardings(st, mesh), mesh)
        return S.build_train_step(cfg, tc, donate=True), (state, batch)
    params = M.init_params(cfg, gen, dtype=param_dtype, device="meta")
    params = distribute(params, sharding.param_shardings(params, mesh),
                         mesh)
    if shape.kind == "prefill":
        def fwd(params, batch):
            with torch.no_grad():
                return M.forward(params, cfg, batch)
        return fwd, (params, batch)
    B, L = shape.global_batch, shape.seq_len
    cache = M.init_cache(cfg, B, L, param_dtype, device="meta")
    cache = distribute(cache, cache_shardings(cfg, mesh, cache, B, L), mesh)

    def serve_step(params, cache, tokens, pos):
        # ``build_serve_step``'s step under ``no_grad``: an inference-mode
        # tensor cannot be a ``DTensor``'s local tensor
        with torch.no_grad():
            logits, cache = M.decode_step(params, cfg, tokens, cache, pos)
            nxt = S.greedy_next(logits)
        return nxt, cache
    return serve_step, (params, cache, batch["tokens"], 0)


def trace_step(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
               tc: TrainConfig | None = None,
               param_dtype=torch.bfloat16) -> dict:
    """Run one cell's step on ``mesh`` (a ``DeviceMesh`` of the fake
    world, set active for the hints) and return the census keys of the
    record."""
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication
    sharding.set_mesh(mesh)
    try:
        t0 = time.perf_counter()
        step, args = build_step(cfg, shape, mesh, tc=tc,
                                param_dtype=param_dtype)
        arg_bytes = _storage_bytes(args)
        comm = CommDebugMode()
        census = Census(args)
        fallback = ReplicateFallback(census, comm)
        with comm, census, implicit_replication(), fallback, \
                shape_propagation(census):
            out = step(*args)
        lower_s = time.perf_counter() - t0
        out_bytes = _storage_bytes(out)
        del out, step, args
    finally:
        sharding.set_mesh(None)
    colls = parse_collectives(comm, census)
    return {
        "n_devices": mesh.size(),
        "param_dtype": str(param_dtype).removeprefix("torch."),
        "lower_s": round(lower_s, 1), "compile_s": 0.0,
        "flops_per_device": float(census.flops),
        "bytes_accessed_per_device": float(census.accessed),
        "argument_bytes": arg_bytes,
        "output_bytes": out_bytes,
        "temp_bytes": census.peak,
        "peak_bytes": arg_bytes + census.peak,
        "collectives": colls,
        "replicated_ops": dict(sorted(fallback.ops.items())),
    }


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
               overrides: dict | None = None):
    """(cfg, shape, mesh, tc) of one cell, the fake world of 512 ranks
    brought up (both meshes take their ranks from it) and ``set_ep2d``
    applied: what ``run_cell`` traces."""
    shape = SHAPES[shape_name]
    over = dict(overrides or {})
    ep2d = over.pop("ep2d", False)
    momentum = over.pop("momentum", True)
    cfg = _pick_cfg(get_config(arch), shape.kind, over)
    fake_world(512)
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    sharding.set_ep2d(ep2d)
    tc = _train_config(cfg, momentum=momentum) if shape.kind == "train" \
        else None
    return cfg, shape, mesh, tc


def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             overrides: dict | None = None) -> dict:
    try:
        cfg, shape, mesh, tc = lower_cell(arch, shape_name,
                                          multi_pod=multi_pod,
                                          overrides=overrides)
        census = trace_step(cfg, shape, mesh, tc=tc)
    finally:
        sharding.set_ep2d(False)
    return {"arch": arch, "shape": shape_name,
            "overrides": dict(overrides or {}),
            "mesh": _mesh_name(multi_pod),
            **census, "ok": True}


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def _child_command(arch: str, shape: str, multi_pod: bool,
                   optimized: bool, out: str) -> list[str]:
    """The command that traces one cell into ``out``."""
    return ([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
             arch, "--shape", shape, "--out", out]
            + (["--multi-pod"] if multi_pod else [])
            + (["--optimized"] if optimized else []))


def _run_in_children(pending, args, record) -> None:
    """Each pending cell in a process of its own (this module run on that
    one cell), ``args.jobs`` at a time, the recurrent families' cells first
    (their Python loops over tokens or chunks trace longest); a cell past
    ``args.cell_timeout`` seconds is killed.  A child's record is passed to
    ``record`` with its wall time and the child's peak resident memory on
    the host (at least this process's own when it started the child); a
    child that dies or is killed gets a failed record with the cause.  A
    SIGTERM ends the run, its running cells killed."""
    import signal
    import subprocess
    out_dir = os.path.dirname(os.path.abspath(args.out)) if args.out else "."
    queue = sorted(pending, key=lambda c: c[0] not in SUBQUADRATIC)
    running = {}
    on_term = signal.signal(signal.SIGTERM, lambda *_: sys.exit(143))
    try:
        _drain(queue, running, args, record, out_dir)
    finally:
        signal.signal(signal.SIGTERM, on_term)
        for proc, log, *_ in running.values():
            os.killpg(proc.pid, signal.SIGKILL)
            os.waitpid(proc.pid, 0)
            log.close()


def _drain(queue, running, args, record, out_dir) -> None:
    """``_run_in_children``'s loop: start cells while slots are free, reap
    (or kill past the timeout) the ones that ended."""
    import signal
    import subprocess
    while queue or running:
        while queue and len(running) < args.jobs:
            arch, shape, mp = queue.pop(0)
            part = os.path.join(out_dir, f".dryrun-{arch}-{shape}-"
                                f"{_mesh_name(mp)}.json")
            if os.path.exists(part):
                os.remove(part)
            log = open(part + ".log", "w")
            proc = subprocess.Popen(
                _child_command(arch, shape, mp, args.optimized, part),
                stdout=log, stderr=subprocess.STDOUT, start_new_session=True)
            print(f"[dryrun] {arch} {shape} {_mesh_name(mp)} ... (pid "
                  f"{proc.pid})", flush=True)
            running[proc.pid] = (proc, log, part, (arch, shape, mp),
                                 time.perf_counter())
        time.sleep(0.5)
        for pid, (proc, log, part, cell, t0) in list(running.items()):
            wall = time.perf_counter() - t0
            done, status, usage = os.wait4(pid, os.WNOHANG)
            timed_out = (not done and args.cell_timeout
                         and wall > args.cell_timeout)
            if timed_out:
                os.killpg(pid, signal.SIGKILL)
                done, status, usage = os.wait4(pid, 0)
            if not done:
                continue
            proc.returncode = os.waitstatus_to_exitcode(status)
            del running[pid]
            log.close()
            arch, shape, mp = cell
            host = {"wall_s": round(wall, 1),
                    "host_peak_rss_gb": round(usage.ru_maxrss / 2**20, 2)}
            recs = []
            if os.path.exists(part):
                with open(part) as f:
                    recs = json.load(f)
                os.remove(part)
            if recs:
                rec = {**recs[-1], **host}
            else:
                with open(part + ".log") as f:
                    tail = f.read()[-1500:]
                cause = (f"not traced within {args.cell_timeout} s"
                         if timed_out else
                         f"the cell's process ended with {proc.returncode}")
                rec = {"arch": arch, "shape": shape, "mesh": _mesh_name(mp),
                       "ok": False, "error": f"TimeoutError: {cause}"
                       if timed_out else f"ChildProcessError: {cause}",
                       "traceback": tail, **host}
            os.remove(part + ".log")
            record(rec)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=sorted(ARCHS), default=None)
    ap.add_argument("--shape", choices=sorted(SHAPES), default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell for the chosen mesh")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--optimized", action="store_true",
                    help="apply best-known per-arch flags (§Perf)")
    ap.add_argument("--out", default="")
    ap.add_argument("--jobs", type=int, default=0,
                    help="trace each cell in a process of its own, this "
                         "many at a time (0: all in this process)")
    ap.add_argument("--cell-timeout", type=float, default=0,
                    help="with --jobs: seconds before a cell is killed "
                         "and recorded as not traced (0: no limit)")
    args = ap.parse_args(argv)

    if args.all:
        todo = [(a, s) for a in ARCHS for s in cells(a)]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape (or --all)")
        todo = [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results = []
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results if r.get("ok")}

    pending = []
    for arch, shape in todo:
        for mp in meshes:
            if (arch, shape, _mesh_name(mp)) in done:
                print(f"[skip] {arch} {shape} {_mesh_name(mp)} (cached)")
            else:
                pending.append((arch, shape, mp))

    def record(rec) -> None:
        nonlocal results
        # drop a stale failed record of this cell
        results = [r for r in results
                   if (r["arch"], r["shape"], r["mesh"])
                   != (rec["arch"], rec["shape"], rec["mesh"])]
        if rec.get("ok"):
            print(f"  ok: {rec['arch']} {rec['shape']} {rec['mesh']} "
                  f"flops/dev={rec['flops_per_device']:.3e} "
                  f"peak={rec['peak_bytes']/2**30:.2f}GiB "
                  f"lower={rec['lower_s']}s compile={rec['compile_s']}s",
                  flush=True)
        else:
            print(f"  FAIL: {rec['arch']} {rec['shape']} {rec['mesh']}: "
                  f"{rec['error']}", flush=True)
        results.append(rec)
        if args.out:
            with open(args.out, "w") as f:
                json.dump(results, f, indent=1)

    if args.jobs > 0:
        _run_in_children(pending, args, record)
    else:
        for arch, shape, mp in pending:
            print(f"[dryrun] {arch} {shape} {_mesh_name(mp)} ...",
                  flush=True)
            over = (optimized_overrides(arch, SHAPES[shape].kind)
                    if args.optimized else None)
            try:
                rec = run_cell(arch, shape, multi_pod=mp, overrides=over)
            except Exception as e:  # noqa: BLE001 — record and continue
                rec = {"arch": arch, "shape": shape, "mesh": _mesh_name(mp),
                       "ok": False, "error": f"{type(e).__name__}: {e}",
                       "traceback": traceback.format_exc()[-2000:]}
            record(rec)
    n_ok = sum(r.get("ok", False) for r in results)
    print(f"done: {n_ok}/{len(results)} cells ok")


if __name__ == "__main__":
    main()
