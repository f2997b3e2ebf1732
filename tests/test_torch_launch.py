"""The port's launchers held on the CPU against the JAX package.

* ``data/tokens.py::input_specs``: "meta" stand-ins with the reference's
  shapes and dtypes for every arch x cell (the checks of the reference's
  ``test_input_specs_are_abstract`` and ``test_input_specs_cover_all_cells``).
* ``models/sharding.py``: ``spec_for`` through ``param_shardings`` for every
  leaf of all ten configs' param trees (the reference's by
  ``jax.eval_shape``, the port's on "meta", shapes equal) under
  ``FakeMesh`` sizes {16, 16}, {2, 16, 16} and {4, 2}, with 2-D expert
  parallelism off and on: the port's spec tuple == the reference's
  ``PartitionSpec``; the reference's rule cases; ``hint`` the identity
  without a mesh; the placements a spec turns into.
* ``launch/shardspecs.py``: ``state_shardings`` (AdamW, Adafactor, b1 0
  and 0.9), ``cache_shardings`` (every family, B 128 and B 1 at max_len
  32,768) and ``batch_shardings`` equal to the reference's, leaf for leaf
  in JAX's tree order (the reference's ``NamedSharding`` is replaced by a
  record of its spec, since a ``FakeMesh`` is no JAX mesh).
* ``launch/mesh.py``: the production mesh raises in a world smaller than
  256 ranks; the host mesh of a world of one.
* ``launch/roofline.py``: ``param_census``, ``analytic_flops``,
  ``analytic_hbm_bytes`` and ``analytic_collective_bytes`` equal to the
  reference's for every arch x cell x mesh and ``ep2d`` (within 1e-12
  relative; they agree exactly); ``analyze`` and ``markdown_table`` on a
  synthetic record give the reference's numerators over the card's
  constants; no TPU constant.
* Meta construction: ``init_params``, ``init_cache`` and ``init_state`` on
  "meta" have the CPU trees' paths, shapes and dtypes (all ten smoke
  configs).
* ``launch/train.py``: ``main([... "--device", "cpu"])`` for 3 steps, then
  resumed to 5 from its checkpoint.
* The elastic re-mesh: a checkpoint written by one rank restored into the
  shardspecs' placements by a spawned gloo world of four, stepped there
  (phi3-mini; rwkv6 and zamba2 under ``seq_shard`` with their loops on
  the shards; phi3.5-moe and deepseek-v3 with the moe dispatch on each
  rank's part of the expert buffer); ``moe_ffn`` on a gloo world of eight
  against one rank (``tests/_torch_moe_ep.py``).
"""
import functools
import os
import re
import signal
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.data import tokens as jtokens
from repro.launch import roofline as jroof
from repro.launch import shardspecs as jspecs
from repro.models import model as JM
from repro.models import sharding as JSH
from repro.train import steps as JS
from repro_torch.configs import ARCHS, SHAPES, cells, get_config, smoke_config
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.data.tokens import input_specs
from repro_torch.launch import roofline, shardspecs
from repro_torch.launch import train as cli
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.models import sharding as SH
from repro_torch.train import steps as S

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = ({"data": 16, "model": 16}, {"pod": 2, "data": 16, "model": 16},
          {"data": 4, "model": 2})


class FakeMesh:
    """The reference's spec-rule double (tests/test_sharding_launch.py)."""

    def __init__(self, sizes):
        self.axis_names = tuple(sizes)
        self.devices = np.empty(tuple(sizes.values()), object)


@pytest.fixture()
def ref_named(monkeypatch):
    """The reference's ``NamedSharding`` as a record of its spec."""
    def named(mesh, spec):
        return SimpleNamespace(spec=tuple(spec))
    monkeypatch.setattr(jspecs, "NamedSharding", named)
    monkeypatch.setattr(JSH, "NamedSharding", named)


@pytest.fixture()
def ep2d(request):
    on = request.param
    JSH.set_ep2d(on)
    SH.set_ep2d(on)
    yield on
    JSH.set_ep2d(False)
    SH.set_ep2d(False)


def _jdtype(t):
    return jnp.dtype(str(t.dtype).removeprefix("torch."))


def _jpath(kp) -> str:
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp)


def _torch_leaves(tree, leaf=torch.Tensor):
    """Leaves of a port tree in JAX's flatten order: dict keys sorted,
    NamedTuples and tuples by position, None dropped."""
    if tree is None:
        return []
    if isinstance(tree, leaf):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _torch_leaves(tree[k], leaf)]
    return [x for v in tree for x in _torch_leaves(v, leaf)]


def _paths(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jax.eval_shape(lambda: JM.init_params(
        jconfigs.get_config(arch), jax.random.PRNGKey(0), jnp.bfloat16))


@functools.lru_cache(maxsize=None)
def _meta_params(arch):
    return M.init_params(get_config(arch), torch.Generator(),
                         dtype=torch.bfloat16, device="meta")


# ----------------------------------------------------------- input_specs ----

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_input_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    for cell in cells(arch):
        shape = SHAPES[cell]
        got = input_specs(cfg, shape)
        want = jtokens.input_specs(jcfg, jconfigs.SHAPES[cell])
        assert list(got) == list(want), cell
        for k, t in got.items():
            assert t.device.type == "meta", (cell, k)
            assert tuple(t.shape) == want[k].shape, (cell, k)
            assert _jdtype(t) == want[k].dtype, (cell, k)
        assert "tokens" in got
        if shape.kind == "decode":
            assert got["tokens"].shape[1] == 1
        else:
            total = got["tokens"].shape[1] + (
                cfg.n_patches if cfg.family == "vlm" else 0)
            assert total == shape.seq_len
    f32 = input_specs(cfg, SHAPES["train_4k"], dtype=torch.float32)
    assert all(t.dtype in (torch.int32, torch.float32) for t in f32.values())


# --------------------------------------------------------- sharding rules ----

def test_spec_rules_tp_fsdp_and_fallback():
    """The reference's ``test_spec_rules_tp_fsdp`` and
    ``test_spec_divisibility_fallback`` on the port."""
    mesh = FakeMesh({"data": 16, "model": 16})
    assert SH.spec_for("layers/wq", (32, 4096, 4096), mesh) == \
        (None, "data", "model")
    assert SH.spec_for("layers/wo", (32, 4096, 4096), mesh) == \
        (None, "model", "data")
    assert SH.spec_for("layers/e_up", (32, 16, 4096, 6400), mesh) == \
        (None, "model", "data", None)
    assert SH.spec_for("embed", (32000, 4096), mesh) == ("model", "data")
    assert SH.spec_for("embed", (51866, 1280), mesh) == (None, "data")
    assert SH.spec_for("layers/wq", (2, 897, 1283), mesh) == (None,) * 3
    assert SH.spec_for("layers/ln1", (32, 4096), mesh) == (None, None)


@pytest.mark.parametrize("ep2d", [False, True], indirect=True)
@pytest.mark.parametrize("sizes", MESHES, ids=lambda s: "x".join(
    map(str, s.values())))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_shardings_match_reference(arch, sizes, ep2d):
    mesh = FakeMesh(sizes)
    ref = jax.tree_util.tree_flatten_with_path(_ref_params(arch))[0]
    port = dict(_paths(SH.param_shardings(_meta_params(arch), mesh)))
    shapes = dict(_paths(_meta_params(arch)))
    assert sorted(port) == sorted(_jpath(kp) for kp, _ in ref)
    for kp, leaf in ref:
        path = _jpath(kp)
        assert tuple(shapes[path].shape) == leaf.shape, path
        assert port[path].spec == tuple(JSH.spec_for(path, leaf.shape, mesh)), \
            (path, port[path].spec)


def test_placements_of_specs():
    """``Shard(dim)`` on every mesh dim an entry names (two names: both
    mesh dims, mesh order), ``Replicate`` elsewhere and on size-1 dims."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = FakeMesh({"pod": 2, "data": 16, "model": 16})
    assert SH.placements((("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert SH.placements((None, ("model", "data"), None), mesh) == \
        (Replicate(), Shard(1), Shard(1))
    assert SH.placements((), mesh) == (Replicate(),) * 3
    assert SH.placements(("data", "model"), FakeMesh(
        {"data": 4, "model": 1})) == (Shard(0), Replicate())


def test_hint_is_identity_without_a_mesh():
    SH.set_mesh(None)
    x = torch.ones(4, 4)
    assert SH.hint(x, "dp", "model") is x
    assert SH.settle(x) is x and SH.gather_fsdp(x) is x
    assert SH.dp_axes() is None
    SH.set_mesh(FakeMesh({"pod": 2, "data": 16, "model": 16}))
    try:
        assert SH.dp_axes() == ("pod", "data")
        assert SH.resolve((64, 3, 32), ("dp", "model", ("model", "data")),
                          SH._ACTIVE["mesh"]) == \
            (("pod", "data"), None, None)
    finally:
        SH.set_mesh(None)


# ------------------------------------------------------------ shardspecs ----

def _specs_of(tree):
    return [s.spec for s in _torch_leaves(tree, SH.NamedSharding)]


def _ref_specs(tree):
    return [s.spec for s in jax.tree.leaves(
        tree, is_leaf=lambda x: isinstance(x, SimpleNamespace))]


@pytest.mark.parametrize("opt,b1", [("adamw", 0.9), ("adafactor", 0.9),
                                    ("adafactor", 0.0), ("adamw", 0.0)])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_state_shardings_match_reference(ref_named, arch, opt, b1):
    from repro.configs.base import TrainConfig as JTrainConfig
    tc = TrainConfig(optimizer=opt, b1=b1)
    jtc = JTrainConfig(optimizer=opt, b1=b1)
    jstate = jax.eval_shape(lambda: JS.init_state(
        jconfigs.get_config(arch), jtc, jax.random.PRNGKey(0),
        jnp.bfloat16))
    state = S.init_state(get_config(arch), tc, torch.Generator(),
                         torch.bfloat16, device="meta")
    assert [tuple(t.shape) for t in _torch_leaves(state)] == \
        [x.shape for x in jax.tree.leaves(jstate)]
    for sizes in MESHES[:2]:
        mesh = FakeMesh(sizes)
        got = _specs_of(shardspecs.state_shardings(state, mesh))
        assert got == _ref_specs(jspecs.state_shardings(jstate, mesh)), sizes


@pytest.mark.parametrize("batch", [128, 1])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_shardings_match_reference(ref_named, arch, batch):
    L = 32_768
    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    jcache = jax.eval_shape(lambda: JM.init_cache(jcfg, batch, L,
                                                  jnp.bfloat16))
    cache = M.init_cache(cfg, batch, L, torch.bfloat16, device="meta")
    assert [(tuple(t.shape), _jdtype(t)) for t in _torch_leaves(cache)] == \
        [(x.shape, x.dtype) for x in jax.tree.leaves(jcache)]
    for sizes in MESHES[:2]:
        mesh = FakeMesh(sizes)
        got = _specs_of(shardspecs.cache_shardings(cfg, mesh, cache, batch,
                                                   L))
        want = _ref_specs(jspecs.cache_shardings(jcfg, mesh, jcache, batch,
                                                 L))
        assert got == want, sizes


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_batch_shardings_match_reference(ref_named, arch):
    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    for cell in cells(arch):
        specs = input_specs(cfg, SHAPES[cell])
        jsp = jtokens.input_specs(jcfg, jconfigs.SHAPES[cell])
        for sizes in MESHES:
            mesh = FakeMesh(sizes)
            got = shardspecs.batch_shardings(cfg, mesh, specs)
            want = jspecs.batch_shardings(jcfg, mesh, jsp)
            assert {k: v.spec for k, v in got.items()} == \
                {k: v.spec for k, v in want.items()}, (cell, sizes)


# ------------------------------------------------------------------ mesh ----

def test_production_mesh_needs_256_ranks():
    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="256 ranks"):
        make_production_mesh(device_type="cpu")
    mesh = make_host_mesh(device_type="cpu")     # brings up a world of one
    try:
        assert mesh.size() == 1 and SH.mesh_sizes(mesh) == \
            {"data": 1, "model": 1}
        with pytest.raises(RuntimeError, match="512 ranks"):
            make_production_mesh(multi_pod=True, device_type="cpu")
    finally:
        dist.destroy_process_group()


# -------------------------------------------------------------- roofline ----

def _close(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _close(a[k], b[k])
        return
    assert abs(a - b) <= 1e-12 * max(abs(a), abs(b)), (a, b)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_roofline_arithmetic_matches_reference(arch):
    cfg, jcfg = get_config(arch), jconfigs.get_config(arch)
    assert roofline.param_census(cfg) == jroof.param_census(jcfg)
    for cell in cells(arch):
        shape, jshape = SHAPES[cell], jconfigs.SHAPES[cell]
        for remat in (True, False):
            _close(roofline.analytic_flops(cfg, shape, remat=remat),
                   jroof.analytic_flops(jcfg, jshape, remat=remat))
        c, jc = cfg, jcfg
        if shape.kind == "train":
            c, jc = cfg.replace(seq_shard=True), jcfg.replace(seq_shard=True)
        for sizes in MESHES[:2]:
            for ctx in (True, False):
                _close(roofline.analytic_hbm_bytes(c, shape, sizes,
                                                   ctx_shard=ctx),
                       jroof.analytic_hbm_bytes(jc, jshape, sizes,
                                                ctx_shard=ctx))
            for on in (False, True):
                _close(roofline.analytic_collective_bytes(c, shape, sizes,
                                                          ep2d=on),
                       jroof.analytic_collective_bytes(jc, jshape, sizes,
                                                       ep2d=on))


def test_roofline_report_uses_the_cards_constants():
    recs = [
        {"arch": "gemma-2b", "shape": "train_4k", "mesh": "16x16",
         "n_devices": 256, "ok": True, "peak_bytes": 3 * 2**30,
         "collectives": {"all-gather": {"count": 5, "bytes": 10}}},
        {"arch": "whisper-large-v3", "shape": "decode_32k",
         "mesh": "2x16x16", "n_devices": 512, "ok": True, "exp": "B2",
         "overrides": {"vocab_pad": 256}, "collectives": {}},
        {"arch": "deepseek-v3-671b", "shape": "train_4k", "mesh": "16x16",
         "n_devices": 256, "ok": True,
         "overrides": {"ep2d": True, "momentum": False, "ce_chunk": 512},
         "collectives": {}},
    ]
    for rec in recs:
        got, want = roofline.analyze(rec), jroof.analyze(rec)
        _close(got.compute_s * roofline.PEAK_FLOPS_BF16,
               want.compute_s * jroof.PEAK_FLOPS)
        _close(got.memory_s * roofline.HBM_BW, want.memory_s * jroof.HBM_BW)
        _close(got.collective_s * roofline.NET_BW,
               want.collective_s * jroof.ICI_BW)
        assert (got.model_flops, got.useful_ratio, got.peak_gib) == \
            (want.model_flops, want.useful_ratio, want.peak_gib)
    f32 = roofline.analyze(dict(recs[0], param_dtype="float32"))
    _close(f32.compute_s * roofline.PEAK_FLOPS_F32,
           roofline.analyze(recs[0]).compute_s * roofline.PEAK_FLOPS_BF16)
    table = roofline.markdown_table(recs + [
        {"arch": "rwkv6-3b", "shape": "train_4k", "mesh": "16x16",
         "ok": False, "error": "boom"}]).splitlines()
    assert len(table) == 6 and "FAILED: boom" in table[-1]
    assert "all-gx5" in table[2]
    assert (roofline.PEAK_FLOPS_BF16, roofline.PEAK_FLOPS_F32,
            roofline.HBM_BW) == (989e12, 67e12, 3.35e12)
    src = open(roofline.__file__).read()
    assert not re.search(r"197e12|819e9|\bICI\b|v5e|TPU", src)


# ------------------------------------------------------ meta construction ----

@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_meta_trees_match_cpu_trees(arch):
    cfg = smoke_config(arch)
    tc = TrainConfig(optimizer="adafactor" if arch.startswith("deepseek")
                     else "adamw")

    def sig(tree):
        return [(tuple(t.shape), t.dtype) for t in _torch_leaves(tree)]

    gen = torch.Generator().manual_seed(0)
    cpu = S.init_state(cfg, tc, gen, torch.bfloat16, device="cpu")
    meta = S.init_state(cfg, tc, torch.Generator(), torch.bfloat16,
                        device="meta")
    assert [p for p, _ in _paths(meta.params)] == \
        [p for p, _ in _paths(cpu.params)]
    assert sig(meta) == sig(cpu)
    assert all(t.device.type == "meta" for t in _torch_leaves(meta))
    assert sig(M.init_cache(cfg, 2, 16, device="meta")) == \
        sig(M.init_cache(cfg, 2, 16, device="cpu"))


# ------------------------------------------------------------------ CLI ----

def test_train_cli_runs_and_resumes(tmp_path, capsys):
    args = ["--arch", "gemma-2b", "--smoke", "--batch", "2", "--seq", "16",
            "--device", "cpu", "--ckpt-dir", str(tmp_path / "ck")]
    cli.main(args + ["--steps", "3"])
    out = capsys.readouterr().out.splitlines()
    assert re.fullmatch(r"final loss \d+\.\d{4} over 3 steps on 1 "
                        r"device\(s\)", out[-1]), out[-1]
    assert "[device] cpu: cpu" in out
    first = float(out[-1].split()[2])
    cli.main(args + ["--steps", "5"])
    out = capsys.readouterr().out.splitlines()
    assert any(line.startswith("[resume] restored step 3") for line in out)
    assert re.fullmatch(r"final loss \d+\.\d{4} over 2 steps on 1 "
                        r"device\(s\)", out[-1]), out[-1]
    assert np.isfinite(first) and np.isfinite(float(out[-1].split()[2]))
    assert not dist.is_initialized()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            cli.main(["--arch", "gemma-2b", "--smoke", "--steps", "1"])


# --------------------------------------------------------- elastic re-mesh ----

def _elastic_remesh(tmp_path, arch: str) -> None:
    """A gloo world of one rank steps ``arch``'s config of
    ``tests/_torch_elastic.py`` once and saves; a spawned world of four
    (mesh (2, 2)) restores that checkpoint into the shardspecs' placements
    and steps again: the loss is finite, equal on every rank, and within
    ``LOSS_RTOL`` of the one-rank step from the same restored state, as is
    the gradient norm; the updated parameters are within ``PARAM_ATOL``."""
    import _torch_elastic as E
    from repro_torch.checkpoint import ckpt
    cfg = E.CFGS[arch]
    make_host_mesh(device_type="cpu")
    try:
        state = S.init_state(cfg, E.TC, torch.Generator().manual_seed(0),
                             device="cpu")
        state, metrics = S.build_train_step(cfg, E.TC)(state, E.batch(cfg))
        assert np.isfinite(float(metrics["loss"]))
        ckpt.save(str(tmp_path / "ck"), 1, state)
    finally:
        dist.destroy_process_group()
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, E.__file__, "4", str(tmp_path / "ck"),
         str(tmp_path / "store"), arch], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"the world of four outlived 240 s: {err[-2000:]}")
    line = [ln for ln in out.splitlines() if ln.startswith("ELASTIC_OK")]
    assert line, err[-3000:]
    _, loss, one, colls, _, _ = line[0].split()
    assert abs(float(loss) - float(one)) <= E.LOSS_RTOL * abs(float(one))
    assert int(colls) > 0


def test_elastic_remesh_one_rank_to_four(tmp_path):
    """The counterpart of ``tests/test_elastic.py`` on the phi3-mini smoke
    config (``_elastic_remesh``)."""
    _elastic_remesh(tmp_path, "phi3-mini-3.8b")


def test_elastic_remesh_rwkv6_sharded_loop(tmp_path):
    """rwkv6 with ``seq_shard`` and ``remat="full"`` on the world of four:
    its WKV loop runs on each rank's heads (``sharding.on_shards``) and its
    sublayers gather the sequence, on real values, and the loss, the
    gradient norm and the updated parameters still equal the one-rank
    step's (``u`` is whole beside a split batch: its gradient is summed
    over the ranks)."""
    _elastic_remesh(tmp_path, "rwkv6-3b")


def test_elastic_remesh_zamba2_sharded_loop(tmp_path):
    """zamba2 under ``seq_shard`` and ``remat="full"`` on the world of four:
    its SSD chunk loop runs on each rank's heads, with ``A`` whole beside a
    split batch and ``Bm``/``Cm`` whole beside split heads, and the step
    equals the one-rank step as ``_elastic_remesh`` checks."""
    _elastic_remesh(tmp_path, "zamba2-2.7b")


def test_elastic_remesh_phi35_moe_expert_parallel(tmp_path):
    """phi3.5-moe under ``seq_shard`` and ``remat="full"`` on the world of
    four: experts over "model", the buffer's slots over "data"; each rank
    writes its own tokens' entries and keeps its shard of the (E, cap, D)
    buffer (a reduce-scatter), and the combine sums each entry over
    "model".  The step equals the one-rank step as ``_elastic_remesh``
    checks."""
    _elastic_remesh(tmp_path, "phi3.5-moe-42b-a6.6b")


def test_elastic_remesh_deepseek_v3_ep2d(tmp_path):
    """deepseek-v3 (MLA, MTP, group-limited routing) with its experts over
    model x data (``set_ep2d``: one expert a rank), under ``seq_shard`` and
    ``remat="full"`` on the world of four: the step equals the one-rank
    step as ``_elastic_remesh`` checks."""
    _elastic_remesh(tmp_path, "deepseek-v3-671b")


def test_moe_expert_parallel_on_a_world_of_eight(tmp_path):
    """``moe_ffn`` on a spawned gloo world of eight ranks, mesh (2, 2, 2)
    (``tests/_torch_moe_ep.py``): experts over "model" with slots over
    ("pod", "data"), and over ("data", "model") with "pod" summing, each
    also at a batch the token ranks do not divide; output, aux and
    gradients equal the one rank's within ``RTOL``."""
    import _torch_moe_ep as EP
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.Popen(
        [sys.executable, EP.__file__, str(tmp_path / "store")], cwd=ROOT,
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        start_new_session=True)
    try:
        out, err = proc.communicate(timeout=240)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        out, err = proc.communicate()
        pytest.fail(f"the world of eight outlived 240 s: {err[-2000:]}")
    line = [ln for ln in out.splitlines() if ln.startswith("MOE_EP_OK")]
    assert line, err[-3000:]
    _, cases, out_gap, grad_gap = line[0].split()
    assert int(cases) == len(EP.CASES)
    assert float(out_gap) <= EP.RTOL and float(grad_gap) <= EP.RTOL
