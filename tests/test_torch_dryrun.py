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
  ``ReplicateFallback`` runs an op with no sharding rule on whole copies.
* ``dryrun.OPTIMIZED`` and ``perf.EXPERIMENTS`` equal the reference's
  (read from its source, since importing the reference's launchers sets
  ``XLA_FLAGS`` for the process); ``lower_cell`` builds the production
  cell's config and meshes on a 512-rank fake world; ``main`` records a
  failed cell and carries on, and skips cells already ok.
"""
import ast
import json
import os

import pytest
import torch
import torch.distributed as dist

from repro.configs import base as jbase
from repro_torch.configs import smoke_config
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import perf
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
