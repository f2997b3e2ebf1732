"""The port's dry run on a small fake world (``launch/dryrun.py``), held
against itself across meshes and against the reference's cell and
tables; the reference's own dry-run test cannot run under this jax (see
ROADMAP.md, queue 3), so it is no oracle here.

* The reference's ``DRYRUN_SMALL`` cell (``tests/test_sharding_launch.py``:
  the phi3.5-moe smoke config at d_model 64, 4 heads of 16, B 8, S 64,
  f32 state, mesh (4, 2) of an 8-rank fake world): the port's train step
  traces, with an all-gather or all-reduce and FLOPs > 0.
* A dense smoke config's train step (gemma-2b's, ``remat="full"``,
  ``seq_shard``): per-rank FLOPs x ranks on meshes (1, 1), (8, 1) and
  (4, 2) equal the one-rank count within 1e-12 relative (this config
  replicates no product); FSDP's all-gathers and reduce-scatters appear
  with a ``data`` axis; peak >= arguments.
* ``hint`` on a fake world redistributes a tensor to its resolved spec;
  ``ReplicateFallback`` runs an op with no sharding rule on whole copies,
  and leaves no storage to the cycle collector.
* Loop-carried state keeps one placement: the smoke rwkv6 and zamba2
  train steps (``seq_shard``, ``remat="full"``) make as many all-gathers
  at S 16 as at S 32 (the WKV loop and the SSD chunk loop run on each
  rank's heads, ``sharding.on_shards``), and unshard no op.
* rwkv6's WKV recurrence traced once (``common.scan`` on "meta" tensors)
  gives the step-by-step record (``common._ONCE_MIN`` patched) for the
  smoke config's train, prefill and decode at S 16, 64 and 256: FLOPs,
  bytes accessed, collectives, fallbacks and argument and output bytes
  exactly, the peak within 1 %; prefill at S 4,096 traces within 2x of
  S 64.
* The cells whose ops some torch versions route to ``Replicate`` (a
  product's merge of a split sequence, pads, rolls, the moe dispatch,
  attention's value product with split query heads) trace with
  ``replicated_ops == {}``.
* The moe buffer stays expert-sharded: three moe cells (deepseek-v3
  under ``set_ep2d`` with group routing, phi3.5-moe train and prefill)
  whose one-rank peak is mostly the moe's tensors unshard no op on
  (4, 2), and a rank's ``temp_bytes`` there is below (2, 2)'s and at most
  half the one-rank step's.
* Each layer's FSDP shards are gathered inside its checkpointed body
  (gemma-2b and phi3.5-moe smoke train steps on (4, 2), ``remat`` "full"
  and "dots"): at the step's peak at most two layers' gathered weights
  are live, and doubling the layers adds less than the added layers'
  gathered weights; FLOPs equal the counts pinned before the gathers
  moved.
* Each flag of the optimized mode (``head_pad``, ``vocab_pad``,
  ``ce_chunk``, ``momentum=False``) traces its smoke cell on (4, 2) with
  no more ops unsharded than the unflagged cell, and lowers what it
  exists to lower (fallbacks, argument bytes, FLOPs).
* On two pods ((2, 2, 2), deepseek-v3's smoke train step at 3 layers,
  with and without ``set_ep2d``) Adafactor's factored moments keep the
  state's placements, the experts' gradient reaches the optimizer laid
  out as the experts, and the step holds no more than the AdamW step.
* ``dryrun.OPTIMIZED`` and ``perf.EXPERIMENTS`` equal the reference's
  (read from its source, since importing the reference's launchers sets
  ``XLA_FLAGS`` for the process); ``lower_cell`` builds the production
  cell's config and meshes on a 512-rank fake world; ``main`` records a
  failed cell and carries on, and skips cells already ok; with ``--jobs``
  it runs each cell in a process of its own and records one that dies or
  outlives ``--cell-timeout`` with the cause.
"""
import ast
import json
import os
import sys
import time
import weakref

import pytest
import torch
import torch.distributed as dist

from repro.configs import base as jbase
from repro_torch.configs import smoke_config
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import perf
from repro_torch.models import common
from repro_torch.models import sharding as SH

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def world():
    """One fake world of 8 ranks for the file (a world a process: see
    ``dryrun.fake_world``); none left behind."""
    assert not dist.is_initialized()
    D.fake_world(8)
    yield
    dist.destroy_process_group()


@pytest.fixture(autouse=True)
def _no_mesh():
    yield
    SH.set_mesh(None)
    SH.set_ep2d(False)


def _mesh(shape):
    """A mesh over the first ranks of the world."""
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.arange(shape[0] * shape[1]).view(shape),
                      mesh_dim_names=("data", "model"))


def test_small_moe_cell_traces(world):
    """The reference's ``DRYRUN_SMALL`` on the port."""
    cfg = smoke_config("phi3.5-moe-42b-a6.6b").replace(
        d_model=64, n_heads=4, n_kv_heads=4, head_dim=16)
    rec = D.trace_step(cfg, ShapeConfig("t", 64, 8, "train"), _mesh((4, 2)),
                       tc=TrainConfig(), param_dtype=torch.float32)
    assert {"all-gather", "all-reduce"} & set(rec["collectives"])
    assert all(v["count"] > 0 and v["bytes"] > 0
               for v in rec["collectives"].values())
    assert rec["flops_per_device"] > 0 and rec["n_devices"] == 8
    assert rec["peak_bytes"] == rec["argument_bytes"] + rec["temp_bytes"]
    assert rec["compile_s"] == 0.0 and rec["param_dtype"] == "float32"


def test_dense_flops_agree_across_meshes(world):
    cfg = D._pick_cfg(smoke_config("gemma-2b"), "train", {})
    assert cfg.seq_shard and cfg.remat == "full"
    shape, recs = ShapeConfig("t", 64, 8, "train"), {}
    for mesh in ((1, 1), (8, 1), (4, 2)):
        recs[mesh] = D.trace_step(cfg, shape, _mesh(mesh), tc=TrainConfig(),
                                  param_dtype=torch.float32)
    one = recs[(1, 1)]["flops_per_device"]
    assert one > 0 and recs[(1, 1)]["collectives"] == {}
    for mesh in ((8, 1), (4, 2)):
        rec = recs[mesh]
        total = rec["flops_per_device"] * rec["n_devices"]
        assert abs(total - one) <= 1e-12 * one, (mesh, total, one)
        assert {"all-gather", "reduce-scatter"} <= set(rec["collectives"])
        assert rec["argument_bytes"] < recs[(1, 1)]["argument_bytes"]
        assert rec["peak_bytes"] >= rec["argument_bytes"] > 0


def test_hint_redistributes_and_fallback_replicates(world):
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor.debug import CommDebugMode
    mesh = _mesh((4, 2))
    SH.set_mesh(mesh)
    x = torch.zeros(8, 4, 6)
    h = SH.hint(x, "dp", None, "model")
    assert isinstance(h, DTensor)
    assert tuple(h.placements) == (Shard(0), Shard(2))
    assert h.to_local().shape == (2, 4, 3)
    assert SH.hint(h, "dp", None, "model") is h
    comm = CommDebugMode()
    with comm:
        r = SH.hint(h, None, None, None)
    assert tuple(r.placements) == (Replicate(), Replicate())
    assert comm.get_total_counts() > 0
    fb = D.ReplicateFallback()
    with fb:
        y = torch.renorm(h, 2, 1, 1.0)    # DTensor has no rule for renorm
    assert fb.ops == {"renorm": 1} and y.shape == (8, 4, 6)


def test_fallback_leaves_no_storage_to_the_cycle_collector(world):
    """An op run by ``ReplicateFallback`` frees its tries' storage when it
    returns, not when the cycle collector next runs: what the census
    counts live does not depend on the collector's timing."""
    import gc
    SH.set_mesh(_mesh((4, 2)))
    h = SH.hint(torch.empty(8, 4, 6000, device="meta"), "dp", None, "model")
    census = D.Census((h,))
    was = gc.isenabled()
    gc.collect()
    gc.disable()
    try:
        with census, D.ReplicateFallback(census) as fb:
            for _ in range(3):
                torch.renorm(h, 2, 1, 1.0)
            live = census.live
            gc.collect()
    finally:
        if was:
            gc.enable()
    assert fb.ops == {"renorm": 3}
    assert census.live == live


@pytest.mark.parametrize("arch", ["rwkv6-3b", "zamba2-2.7b"])
def test_loop_carried_state_keeps_one_placement(world, arch):
    cfg = D._pick_cfg(smoke_config(arch), "train", {})
    recs = [D.trace_step(cfg, ShapeConfig("t", S, 8, "train"), _mesh((4, 2)),
                         tc=TrainConfig()) for S in (16, 32)]
    gathers = [r["collectives"]["all-gather"]["count"] for r in recs]
    assert gathers[0] == gathers[1] > 0, gathers
    assert [r["replicated_ops"] for r in recs] == [{}, {}]


#: the records that the scan traced once must equal exactly, and the peak
#: beyond the arguments, which it must equal within 1 % (it is equal at
#: these shapes)
_EXACT = ("flops_per_device", "bytes_accessed_per_device", "collectives",
          "replicated_ops", "argument_bytes", "output_bytes")
_TEMP_RTOL = 0.01


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("S", [16, 64, 256])
def test_scan_traced_once_equals_step_by_step(world, kind, S, monkeypatch):
    """rwkv6's WKV recurrence traced once (``common.scan`` on "meta"
    tensors) against the same cell traced step by step (the module
    patched so that every S runs the loop)."""
    cfg = D._pick_cfg(smoke_config("rwkv6-3b"), kind, {})
    shape = ShapeConfig("t", S, 8, kind)
    tc = TrainConfig() if kind == "train" else None
    once = D.trace_step(cfg, shape, _mesh((4, 2)), tc=tc)
    monkeypatch.setattr(common, "_ONCE_MIN", 10**9)
    loop = D.trace_step(cfg, shape, _mesh((4, 2)), tc=tc)
    assert {k: once[k] for k in _EXACT} == {k: loop[k] for k in _EXACT}
    assert abs(once["temp_bytes"] - loop["temp_bytes"]) \
        <= _TEMP_RTOL * loop["temp_bytes"]
    assert once["flops_per_device"] > 0


def test_scan_trace_time_does_not_grow_with_S(world):
    """rwkv6's prefill at S 4,096 traces within 2x of S 64 (the best of
    three after a warm-up), with 64x the FLOPs."""
    cfg = D._pick_cfg(smoke_config("rwkv6-3b"), "prefill", {})

    def trace(S):
        return D.trace_step(cfg, ShapeConfig("t", S, 8, "prefill"),
                            _mesh((4, 2)))
    trace(64)
    best, flops = {64: float("inf"), 4096: float("inf")}, {}
    for S in (64, 4096) * 3:
        t0 = time.perf_counter()
        flops[S] = trace(S)["flops_per_device"]
        best[S] = min(best[S], time.perf_counter() - t0)
    assert best[4096] <= 2 * best[64], best
    assert flops[4096] == 64 * flops[64]


@pytest.mark.parametrize("arch,kind,batch", [
    ("gemma-2b", "train", 8), ("deepseek-v3-671b", "train", 8),
    ("phi3.5-moe-42b-a6.6b", "train", 8),
    ("phi3.5-moe-42b-a6.6b", "prefill", 8),
    ("whisper-large-v3", "train", 8), ("whisper-large-v3", "decode", 8),
    ("rwkv6-3b", "decode", 1), ("zamba2-2.7b", "decode", 1)])
def test_cells_trace_with_no_op_unsharded(world, arch, kind, batch):
    """B 1 is long_500k's decode: one stream, its vocabulary gathered for
    the argmax."""
    cfg = D._pick_cfg(smoke_config(arch), kind, {})
    rec = D.trace_step(cfg, ShapeConfig("t", 64, batch, kind),
                       _mesh((4, 2)),
                       tc=TrainConfig() if kind == "train" else None)
    assert rec["replicated_ops"] == {}
    assert rec["flops_per_device"] > 0


#: moe cells at B 64, S 32 (T 2,048 tokens), top-k 4, f32: the (1, 1)
#: step's peak is mostly the moe's (E, cap, D) buffer, its (E, cap, F)
#: products and its (K*T, D) entries (measured: 0.54, 0.68 and 0.86 of the
#: live bytes at the peak, in the order below; asserted above one half)
_MOE_CELLS = [
    ("deepseek-v3-671b", "train", {"n_experts": 16, "top_k": 4,
                                   "route_groups": 4, "route_top_groups": 2},
     True),
    ("phi3.5-moe-42b-a6.6b", "train", {"n_experts": 8, "top_k": 4}, False),
    ("phi3.5-moe-42b-a6.6b", "prefill", {"n_experts": 8, "top_k": 4}, False),
]


@pytest.mark.parametrize("arch,kind,over,ep2d", _MOE_CELLS,
                         ids=["dsv3-train-ep2d", "phi-train", "phi-prefill"])
def test_moe_buffer_stays_expert_sharded(world, monkeypatch, arch, kind,
                                         over, ep2d):
    """The moe dispatch and combine keep the (E, cap, D) buffer and the
    entries expert-sharded: on the (4, 2) mesh no op is unsharded, a
    rank's ``temp_bytes`` is below the (2, 2) mesh's (twice the token ranks
    lower it) and at most half the one-rank step's.  deepseek-v3 under
    ``set_ep2d`` (16 experts over model x data) with group-limited routing;
    phi3.5-moe with its experts over "model" and the slots over "data"."""
    tool = _sweep_tool(monkeypatch)
    cfg = D._pick_cfg(smoke_config(arch), kind, over)
    shape = ShapeConfig("t", 32, 64, kind)
    tc = TrainConfig() if kind == "train" else None
    temp, plain = {}, D.Census
    for mesh in ((1, 1), (2, 2), (4, 2)):
        monkeypatch.setattr(D, "Census", tool.LargestCensus
                            if mesh == (1, 1) else plain)
        SH.set_ep2d(ep2d)
        rec = D.trace_step(cfg, shape, _mesh(mesh), tc=tc,
                           param_dtype=torch.float32)
        temp[mesh] = rec["temp_bytes"]
        if mesh == (1, 1):
            E, K, T = cfg.n_experts, cfg.top_k, 64 * 32
            cap = int(K * T * cfg.capacity_factor / E)
            live, top = tool.LargestCensus.made[-1].at_peak
            moe = sum(nb for (_, shp, _), nb in top
                      if shp and shp[0] in (E, E * cap + 1, K * T))
            assert moe > live / 2, (moe, live)
    assert rec["replicated_ops"] == {}
    assert temp[(4, 2)] < temp[(2, 2)], temp
    assert temp[(4, 2)] <= temp[(1, 1)] / 2, temp


def _tree_pairs(a, b):
    """(path, leaf of a, leaf of b) of two trees of one structure."""
    if isinstance(a, dict):
        for k in a:
            for path, x, y in _tree_pairs(a[k], b[k]):
                yield f"{k}/{path}", x, y
    elif isinstance(a, tuple):
        for i, (x, y) in enumerate(zip(a, b)):
            yield from ((f"{i}/{p}", u, w) for p, u, w in _tree_pairs(x, y))
    elif a is not None:
        yield "", a, b


@pytest.mark.parametrize("ep2d", [False, True], ids=["ep", "ep2d"])
def test_adafactor_state_keeps_its_layout_on_two_pods(world, monkeypatch,
                                                      ep2d):
    """deepseek-v3's smoke train step on (2, 2, 2), 3 layers (so no
    stacked dim splits evenly over "pod"), under Adafactor: the new
    factored moments keep the state's placements (a mean over a sharded
    dim is completed), the experts' gradient reaches the optimizer laid
    out as the experts (under ``set_ep2d`` its sum over "pod" is done per
    layer), and the step's ``temp_bytes`` is at most the AdamW step's: the
    update unshards no stack of weights."""
    from torch.distributed.device_mesh import DeviceMesh
    from repro_torch.optim import adamw as O
    mesh = DeviceMesh("cpu", torch.arange(8).view(2, 2, 2),
                      mesh_dim_names=("pod", "data", "model"))
    real, moved = O.apply_opt, []

    def apply_opt(tc, params, grads, st, **kw):
        new_p, new_st = real(tc, params, grads, st, **kw)
        if tc.optimizer == "adafactor":
            moved.extend(
                p for p, old, new in _tree_pairs(st.v, new_st.v)
                if tuple(old.placements) != tuple(new.placements))
            moved.extend(
                p for p, w, g in _tree_pairs(params["layers"],
                                             grads["layers"])
                if p.startswith("e_")
                and tuple(w.placements) != tuple(g.placements))
        return new_p, new_st

    monkeypatch.setattr(O, "apply_opt", apply_opt)
    cfg = D._pick_cfg(smoke_config("deepseek-v3-671b"), "train",
                      {"n_experts": 16, "top_k": 4, "n_layers": 3})
    temp = {}
    for opt in ("adafactor", "adamw"):
        SH.set_ep2d(ep2d)
        rec = D.trace_step(cfg, ShapeConfig("t", 32, 16, "train"), mesh,
                           tc=TrainConfig(optimizer=opt),
                           param_dtype=torch.float32)
        temp[opt] = rec["temp_bytes"]
        assert rec["replicated_ops"] == {}
    assert moved == []
    assert temp["adafactor"] <= temp["adamw"], temp


class _GatheredCensus(D.Census):
    """``Census`` that also notes the bytes of gathered layer weights live
    when the step reaches its peak: ``gathered`` holds the local storages
    that ``sharding.gather_fsdp`` made for a layer's leaves."""

    made: list = []

    def __init__(self, args):
        super().__init__(args)
        self.gathered = weakref.WeakSet()
        self.gathered_at_peak = 0
        _GatheredCensus.made.append(self)

    def _track(self, out) -> None:
        super()._track(out)
        if self.live == self.peak:
            self.gathered_at_peak = sum(st.nbytes()
                                        for st in list(self.gathered))


#: ``flops_per_device`` of the train steps below (B 8, S 16, f32, (4, 2)),
#: at the smoke config's 2 layers and at 4, as counted while each layer was
#: gathered outside its checkpointed body: where the gather runs moves no
#: FLOP
_LAYER_FLOPS = {
    ("gemma-2b", "full"): (9699328, 18612224),
    ("gemma-2b", "dots"): (7995392, 15204352),
    ("phi3.5-moe-42b-a6.6b", "full"): (11927552, 23068672),
    ("phi3.5-moe-42b-a6.6b", "dots"): (11239424, 21692416),
}


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["gemma-2b", "phi3.5-moe-42b-a6.6b"])
def test_layer_gathers_stay_inside_the_remat(world, monkeypatch, arch,
                                             remat):
    """Each layer's FSDP shards are gathered inside its checkpointed body,
    as the reference's scan of the sharded stack through its remat'd body
    gathers them: at the train step's peak on (4, 2) the gathered weights
    of at most two layers are live, and doubling the layers adds less to
    ``temp_bytes`` than the added layers' gathered weights (what a
    checkpoint holding each layer's gathered weights as its inputs adds on
    top of their activations and gradients).  FLOPs are the pinned
    counts."""
    real = SH.gather_fsdp
    shapes: set = set()

    def gather(w):
        out = real(w)
        if out is not w and tuple(out.shape) in shapes \
                and _GatheredCensus.made:
            _GatheredCensus.made[-1].gathered.add(
                out.to_local().untyped_storage())
        return out

    monkeypatch.setattr(SH, "gather_fsdp", gather)
    monkeypatch.setattr(D, "Census", _GatheredCensus)
    base, mesh = smoke_config(arch), _mesh((4, 2))
    shape, recs = ShapeConfig("t", 16, 8, "train"), []
    for L in (base.n_layers, 2 * base.n_layers):
        cfg = D._pick_cfg(base, "train", {"remat": remat, "n_layers": L})
        SH.set_mesh(mesh)
        _, (state, _) = D.build_step(cfg, shape, mesh, tc=TrainConfig(),
                                     param_dtype=torch.float32)
        layers = state.params["layers"]
        shapes.clear()
        shapes.update(tuple(v.shape[1:]) for v in layers.values())
        per_layer = 0       # one layer's gathered weights, local bytes
        for v in layers.values():
            g = real(v[0])
            if g is not v[0]:
                per_layer += g.to_local().numel() * g.element_size()
        SH.set_mesh(None)
        rec = D.trace_step(cfg, shape, mesh, tc=TrainConfig(),
                           param_dtype=torch.float32)
        at_peak = _GatheredCensus.made[-1].gathered_at_peak
        assert 0 < at_peak <= 2 * per_layer, (L, at_peak, per_layer)
        assert rec["replicated_ops"] == {}
        recs.append(rec)
    grown = recs[1]["temp_bytes"] - recs[0]["temp_bytes"]
    assert 0 < grown < base.n_layers * per_layer, (grown, per_layer)
    assert tuple(r["flops_per_device"] for r in recs) == \
        _LAYER_FLOPS[arch, remat]


#: the optimized mode's flags, each on a smoke cell: (arch, kind, the
#: unflagged cell's overrides, the flag, the record keys the flag must
#: lower).  Three heads do not divide "model" (2), so the unpadded head
#: split falls back; a vocabulary of 123 does not either, so the unpadded
#: table and logits stay whole.
_FLAG_CELLS = [
    ("whisper-large-v3", "decode", {"n_heads": 3, "n_kv_heads": 3},
     {"head_pad": 4}, ("fallbacks",)),
    ("whisper-large-v3", "train", {"n_heads": 3, "n_kv_heads": 3},
     {"head_pad": 4}, ("fallbacks", "temp_bytes")),
    ("internvl2-1b", "train", {"vocab": 123}, {"vocab_pad": 64},
     ("argument_bytes", "flops_per_device")),
    ("internvl2-1b", "prefill", {"vocab": 123}, {"vocab_pad": 64},
     ("argument_bytes", "flops_per_device")),
    ("gemma-2b", "train", {}, {"ce_chunk": 16}, ()),
    ("deepseek-v3-671b", "train", {}, {"momentum": False},
     ("argument_bytes",)),
]


@pytest.mark.parametrize(
    "arch,kind,base,flag,lower", _FLAG_CELLS,
    ids=["head_pad-decode", "head_pad-train", "vocab_pad-train",
         "vocab_pad-prefill", "ce_chunk-train", "momentum-train"])
def test_optimized_flag_shards_no_less(world, arch, kind, base, flag,
                                       lower):
    """Each flag of ``launch.dryrun --optimized`` traces its smoke cell on
    (4, 2) with no op unsharded that the unflagged cell keeps sharded
    (``replicated_ops`` op by op at most the unflagged cell's), and lowers
    what it exists to lower: padded heads take away the head split's
    fallbacks, a padded vocabulary shards the table and the logits, no
    momentum drops the first moment; chunking the CE moves no FLOP."""
    recs = []
    for over in (base, {**base, **flag}):
        over = dict(over)
        momentum = over.pop("momentum", True)
        cfg = D._pick_cfg(smoke_config(arch), kind, over)
        tc = D._train_config(cfg, momentum) if kind == "train" else None
        rec = D.trace_step(cfg, ShapeConfig("t", 64, 8, kind), _mesh((4, 2)),
                           tc=tc)
        rec["fallbacks"] = sum(rec["replicated_ops"].values())
        recs.append(rec)
    plain, flagged = recs
    assert all(n <= plain["replicated_ops"].get(op, 0)
               for op, n in flagged["replicated_ops"].items()), recs
    for key in lower:
        assert flagged[key] < plain[key], (key, plain[key], flagged[key])
    if "head_pad" in flag:
        assert flagged["replicated_ops"] == {}
    if "ce_chunk" in flag:
        assert flagged["flops_per_device"] == plain["flops_per_device"]


def _ref_literal(module: str, name: str):
    src = open(os.path.join(ROOT, "src", "repro", "launch",
                            f"{module}.py")).read()
    for node in ast.parse(src).body:
        if isinstance(node, ast.Assign) and any(
                getattr(t, "id", None) == name for t in node.targets):
            return ast.literal_eval(node.value)
    raise KeyError(name)


def test_experiment_lists_equal_the_references():
    assert D.OPTIMIZED == _ref_literal("dryrun", "OPTIMIZED")
    assert perf.EXPERIMENTS == _ref_literal("perf", "EXPERIMENTS")
    assert D.optimized_overrides("deepseek-v3-671b", "decode") == {
        "ep2d": True, "route_groups": 8, "route_top_groups": 4}
    tc = D._train_config(smoke_config("deepseek-v3-671b"), momentum=False)
    assert (tc.optimizer, tc.b1) == ("adafactor", 0.0)
    assert jbase.TrainConfig().b1 == TrainConfig().b1


def test_sweep_cell_of_a_perf_experiment(world, monkeypatch, capsys):
    """``--exp NAME``: the ``launch.perf`` experiment's cell, mesh and
    flags (``--optimized``: ``launch.dryrun --optimized``'s), with the
    buffers live at its peak.  The production cell is stood in for by the
    smoke config's decode on (4, 2)."""
    tool = _sweep_tool(monkeypatch)
    calls = []

    def small_cell(arch, shape, multi_pod=False, overrides=None):
        calls.append((arch, shape, multi_pod, overrides))
        cfg = D._pick_cfg(smoke_config(arch), "decode", {})
        return D.trace_step(cfg, ShapeConfig("t", 16, 8, "decode"),
                            _mesh((4, 2)))

    monkeypatch.setattr(D, "run_cell", small_cell)
    tool.main(["--exp", "B3_head_pad", "--largest", "2"])
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert printed[-3]["live_at_peak_bytes"] > 0
    tool.main(["--cell", "internvl2-1b", "decode_32k", "--optimized"])
    assert calls == [
        ("whisper-large-v3", "decode_32k", False,
         {"vocab_pad": 256, "head_pad": 32}),
        ("internvl2-1b", "decode_32k", False, {"vocab_pad": 256})]


def test_lower_cell_on_a_production_world(world):
    """Last in the file: it replaces the world of 8 by one of 512."""
    cfg, shape, mesh, tc = D.lower_cell("gemma-2b", "train_4k",
                                        overrides={"ep2d": True})
    assert (cfg.remat, cfg.seq_shard, shape.global_batch) == ("full", True,
                                                               256)
    assert SH.mesh_sizes(mesh) == {"data": 16, "model": 16}
    assert SH.ep2d() and tc.optimizer == "adamw"
    cfg, shape, mesh, tc = D.lower_cell("whisper-large-v3", "decode_32k",
                                        multi_pod=True)
    assert (cfg.remat, cfg.mtp, tc) == ("none", False, None)
    assert mesh.size() == 512 and dist.get_world_size() == 512


def test_main_records_failures_and_skips_done_cells(tmp_path, monkeypatch,
                                                    capsys):
    calls = []

    def fake_run(arch, shape, *, multi_pod=False, overrides=None):
        calls.append((arch, shape, multi_pod))
        if multi_pod:
            raise RuntimeError("no rule")
        return {"arch": arch, "shape": shape, "ok": True,
                "mesh": "16x16", "flops_per_device": 1.0,
                "peak_bytes": 0, "lower_s": 0.1, "compile_s": 0.0}

    monkeypatch.setattr(D, "run_cell", fake_run)
    out = str(tmp_path / "r.json")
    args = ["--arch", "gemma-2b", "--shape", "decode_32k", "--both-meshes",
            "--out", out]
    D.main(args)
    recs = json.load(open(out))
    assert [r["ok"] for r in recs] == [True, False]
    assert recs[1]["error"] == "RuntimeError: no rule"
    D.main(args)
    assert "[skip] gemma-2b decode_32k 16x16" in capsys.readouterr().out
    assert calls[-1] == ("gemma-2b", "decode_32k", True)
    assert len(json.load(open(out))) == 2
    monkeypatch.setattr(D, "run_cell", lambda *a, **k: dict(
        fake_run(*a, **k), arch=a[0]))
    pout = str(tmp_path / "p.json")
    perf.main(["--exp", "B1_ctx_shard", "A1_ep2d", "--out", pout])
    precs = json.load(open(pout))
    assert [(r["exp"], r["ok"]) for r in precs] == [("A1_ep2d", False),
                                                    ("B1_ctx_shard", True)]


def test_main_runs_cells_in_children(tmp_path, monkeypatch, capsys):
    """``--jobs``: each cell's command in a process of its own; a record
    it writes is kept with the wall time and the host's peak memory, a
    process that fails or outlives ``--cell-timeout`` is recorded with the
    cause, and a second run retries only the cells not yet ok."""
    def command(arch, shape, multi_pod, optimized, out):
        rec = {"arch": arch, "shape": shape, "mesh": D._mesh_name(multi_pod),
               "ok": True, "flops_per_device": 1.0, "peak_bytes": 0,
               "lower_s": 0.1, "compile_s": 0.0}
        body = {"decode_32k": f"import json; json.dump([{rec!r}], "
                              f"open({out!r}, 'w'))",
                "prefill_32k": "import time; time.sleep(60)",
                "train_4k": "raise SystemExit(3)"}[shape]
        return [sys.executable, "-c", body]

    monkeypatch.setattr(D, "_child_command", command)
    out = str(tmp_path / "r.json")
    for shape in ("decode_32k", "prefill_32k", "train_4k"):
        D.main(["--arch", "gemma-2b", "--shape", shape, "--both-meshes",
                "--jobs", "2", "--cell-timeout", "1.5", "--out", out])
    recs = {(r["shape"], r["mesh"]): r for r in json.load(open(out))}
    assert len(recs) == 6
    for mesh in ("16x16", "2x16x16"):
        assert recs["decode_32k", mesh]["ok"]
        assert recs["decode_32k", mesh]["host_peak_rss_gb"] > 0
        assert recs["prefill_32k", mesh]["error"] == \
            "TimeoutError: not traced within 1.5 s"
        assert recs["train_4k", mesh]["error"] == \
            "ChildProcessError: the cell's process ended with 3"
    assert not [f for f in os.listdir(tmp_path) if f.startswith(".dryrun")]
    capsys.readouterr()
    D.main(["--arch", "gemma-2b", "--shape", "decode_32k", "--both-meshes",
            "--jobs", "2", "--out", out])
    assert capsys.readouterr().out.count("[skip]") == 2


# ------------------------------------------------- tools/dryrun_sweep.py ----

def _sweep_tool(monkeypatch):
    """``tools/dryrun_sweep.py`` as a module; the classes its options put
    into ``launch/dryrun.py`` are put back after the test."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "dryrun_sweep", os.path.join(ROOT, "tools", "dryrun_sweep.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    monkeypatch.setattr(D, "ReplicateFallback", D.ReplicateFallback)
    monkeypatch.setattr(D, "Census", D.Census)
    return tool


def _renorm_first(monkeypatch):
    """``models/model.py``'s norms after a ``renorm`` that changes no
    value and that ``DTensor`` has no rule for, so each unshards."""
    from repro_torch.models import model as MM
    real = MM.rms_norm
    monkeypatch.setattr(MM, "rms_norm", lambda x, w, eps: real(
        torch.renorm(x, 2, 0, 1e30), w, eps))


_SWEEP_WHERE = """
import importlib.util
import torch
spec = importlib.util.spec_from_file_location("dryrun_sweep", {tool!r})
tool = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tool)
from repro_torch.models import model as MM
real = MM.rms_norm
MM.rms_norm = lambda x, w, eps: real(torch.renorm(x, 2, 0, 1e30), w, eps)
tool.ARCHS = ["gemma-2b"]
tool.main(["--where", "--out", {out!r}])
"""


def test_sweep_where_names_each_fallback_site(tmp_path):
    """The sweep with ``--where --out`` (in a process of its own: the sweep
    makes its own fake world), gemma-2b alone, its norms after a
    ``renorm`` (``_renorm_first``): each unsharded op is named with its
    call site in ``repro_torch/models`` and its inputs' placements, and
    the counts add up to ``replicated_ops``."""
    import subprocess
    out = str(tmp_path / "sweep.json")
    code = _SWEEP_WHERE.format(
        tool=os.path.join(ROOT, "tools", "dryrun_sweep.py"), out=out)
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env=dict(os.environ, PYTHONPATH=os.path.join(
                              ROOT, "src")),
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = json.load(open(out))
    assert [(ln["arch"], ln["kind"], ln["ok"]) for ln in lines] == [
        ("gemma-2b", k, True) for k in ("train", "prefill", "decode")], lines
    for ln in lines:
        assert ln["replicated_ops"].get("renorm", 0) > 0, ln
        assert sum(ln["where"].values()) == sum(
            ln["replicated_ops"].values())
        assert all(" @ models/model.py:" in k or " @ bwd models/" in k
                   for k in ln["where"]), ln["where"]


def test_sweep_cell_where_on_the_multi_pod_mesh(world, monkeypatch,
                                                tmp_path, capsys):
    """``--cell ARCH SHAPE --where --multi-pod --out``: the cell's record
    on the 2 x 16 x 16 mesh with each fallback's count and bytes, and the
    ``--largest`` buffers live at the peak.  The production cell is
    stood in for by the smoke config's decode on (2, 2, 2) or (4, 2)."""
    from torch.distributed.device_mesh import DeviceMesh
    tool = _sweep_tool(monkeypatch)
    _renorm_first(monkeypatch)

    def small_cell(arch, shape, multi_pod=False, overrides=None):
        mesh = (DeviceMesh("cpu", torch.arange(8).view(2, 2, 2),
                           mesh_dim_names=("pod", "data", "model"))
                if multi_pod else _mesh((4, 2)))
        cfg = D._pick_cfg(smoke_config(arch), "decode", {})
        rec = D.trace_step(cfg, ShapeConfig("t", 16, 8, "decode"), mesh)
        return {**rec, "arch": arch, "shape": shape,
                "mesh": D._mesh_name(multi_pod)}

    monkeypatch.setattr(D, "run_cell", small_cell)
    out = str(tmp_path / "cell.json")
    tool.main(["--cell", "gemma-2b", "decode_32k", "--where", "--multi-pod",
               "--largest", "3", "--out", out])
    [rec] = json.load(open(out))
    assert rec["mesh"] == "2x16x16" and rec["n_devices"] == 8
    assert rec["where"] and all(
        k.startswith("renorm @ models/model.py:") and v["count"] > 0
        and v["bytes"] > 0 for k, v in rec["where"].items()), rec["where"]
    assert sum(v["count"] for v in rec["where"].values()) == \
        rec["replicated_ops"]["renorm"]
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert printed[-4]["live_at_peak_bytes"] > 0
    assert all(p["bytes"] > 0 and p["op"] for p in printed[-3:])


def test_sweep_table_prints_a_row_a_cell(monkeypatch, tmp_path, capsys):
    """``--table``: a ``launch.dryrun --out`` file as PERF.md's markdown
    table, one row a production cell, a column a mesh: the counts of an ok
    record, the cause (with wall and host memory) of a failed one, "not
    run" for a cell with no record."""
    from repro_torch.configs import ARCHS, cells
    tool = _sweep_tool(monkeypatch)
    recs = [{"arch": "gemma-2b", "shape": "train_4k", "mesh": "16x16",
             "ok": True, "flops_per_device": 2.498e14, "peak_bytes": 32.27e9,
             "collectives": {"all-gather": {"count": 366, "bytes": 1},
                             "reduce-scatter": {"count": 220, "bytes": 1},
                             "all-reduce": {"count": 45, "bytes": 1}},
             "replicated_ops": {"view": 54}, "lower_s": 9.3},
            {"arch": "gemma-2b", "shape": "train_4k", "mesh": "2x16x16",
             "ok": False, "error": "TimeoutError: not traced within 9 s",
             "wall_s": 9.1, "host_peak_rss_gb": 1.5}]
    path = tmp_path / "all.json"
    path.write_text(json.dumps(recs))
    tool.main(["--table", str(path)])
    rows = capsys.readouterr().out.splitlines()
    assert rows[0] == "| arch | shape | 16x16 | 2x16x16 |"
    assert len(rows) == 2 + sum(len(cells(a)) for a in ARCHS)
    assert ("| gemma-2b | train_4k | 2.498e+14; 32.27; 366/220/45; "
            "{view 54}; 9.3 | **no**: TimeoutError: not traced within 9 s "
            "(9.1 s, 1.5 GB host) |") in rows
    assert "| gemma-2b | prefill_32k | not run | not run |" in rows
