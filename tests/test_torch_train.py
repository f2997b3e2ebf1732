"""The port's training stack held on the CPU against the JAX package, at
smoke size, with the reference's weights carried by ``params_from_numpy``
and inputs from a numpy seed.

* The optimizers on the same params and gradients: AdamW, Adafactor with
  and without momentum (bf16 first moment, factored second moment, update
  clipping), over several steps, within 2 ulps of each leaf's scale (the
  reductions and ``pow`` round in another order than XLA's); in place
  (``donate=True``) equal bit for bit to the copying route;
  ``clip_by_global_norm`` within 2 ulps; ``compress`` with its error
  feedback and ``cosine_lr`` bit for bit.
* ``loss_fn`` and its gradient against ``jax.value_and_grad`` for all ten
  smoke configs within 2e-5 of scale; chunked CE equal to full CE; the
  padded heads and vocabulary of the dry run's optimized mode
  (``head_pad``, ``vocab_pad``) in the forward and the loss within 2e-5
  of scale; the ``remat`` modes equal bit for bit.
* ``build_train_step``: the reference's ``test_forward_and_train_step``
  for every arch, the input state left as it was, ``donate`` equal bit for
  bit, the loss and the gradient norm against the reference's step;
  ``build_serve_step`` against the reference's.
* The reference's loop cases on the port's ``train(device="cpu")``: loss
  decreases, resume is bitwise deterministic, the straggler skip, and the
  ``internvl2-1b`` diagnostics run of ``tests/test_system.py``; and the
  reference's optimizer cases (a quadratic, compression, the clip, the
  momentum-free state).
"""
import inspect

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.data import tokens as jtokens
from repro.models import model as JM
from repro.optim import adamw as JO
from repro.optim import compression as JC
from repro.train import steps as JS
from repro_torch import configs
from repro_torch.checkpoint.ckpt import _walk
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.data.tokens import make_batch
from repro_torch.models import model as M
from repro_torch.optim import adamw as O
from repro_torch.optim import compression as C
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.train import steps as S
from repro_torch.train.loop import train

CPU = "cpu"
SHAPE = ShapeConfig("tiny", 32, 4, "train")
F32_ULP = 2.0 ** -23
ARCHS = sorted(jconfigs.ARCHS)
OPTS = {"adamw": dict(optimizer="adamw"),
        "adafactor": dict(optimizer="adafactor"),
        "adafactor_b1_0": dict(optimizer="adafactor", b1=0.0)}


def _tc(tmpdir, **kw):
    kw.setdefault("lr", 1e-2)
    kw.setdefault("total_steps", 10)
    kw.setdefault("ckpt_every", 4)
    kw.setdefault("diag_every", 5)
    return TrainConfig(ckpt_dir=str(tmpdir), **kw)


def _ulps(got: torch.Tensor, want) -> float:
    """max |got - want| in ulps of want's scale (f32)."""
    want = np.asarray(want, np.float32)
    scale = float(np.max(np.abs(want))) or 1.0
    diff = np.abs(got.detach().float().numpy() - want)
    return float(np.max(diff)) / (scale * F32_ULP)


def _tree(rng, shapes):
    if isinstance(shapes, dict):
        return {k: _tree(rng, v) for k, v in shapes.items()}
    return rng.normal(size=shapes).astype(np.float32)


SHAPES = {"w": (16, 24), "b": (24,),
          "layers": {"x": (2, 8, 12), "n": (2, 8)}}


def _jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _torch(tree):
    return tree_map(lambda a: torch.tensor(np.asarray(a)), tree)


def _clone(tree):
    return tree_map(lambda t: None if t is None else
                    tuple(x.clone() for x in t) if isinstance(t, tuple)
                    else t.clone(), tree)


# --------------------------------------------------------- optimizers ----


@pytest.mark.parametrize("opt", sorted(OPTS))
def test_optimizer_matches_reference(opt):
    rng = np.random.default_rng(0)
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, **OPTS[opt])
    jtc, tc = jbase.TrainConfig(**kw), TrainConfig(**kw)
    P = _tree(rng, SHAPES)
    jp, tp = _jax(P), _torch(P)
    js, ts = JO.init_opt(jtc, jp), O.init_opt(tc, tp)
    assert (ts.m is None) == (js.m is None) == (opt == "adafactor_b1_0")
    for _ in range(5):
        G = _tree(rng, SHAPES)
        jp, js = JO.apply_opt(jtc, jp, _jax(G), js)
        copy = O.OptState(ts.step, None if ts.m is None else _clone(ts.m),
                          _clone(ts.v))
        donated = _clone(tp)
        dp, ds = O.apply_opt(tc, donated, _torch(G), copy, donate=True)
        tp, ts = O.apply_opt(tc, tp, _torch(G), ts)
        for a, b in zip(tree_leaves(tp), tree_leaves(dp)):
            assert torch.equal(a, b)
        assert all(a is b for a, b in zip(tree_leaves(dp),
                                          tree_leaves(donated)))
        for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
            assert _ulps(b, a) <= 2.0
    assert int(ts.step) == int(js.step) == 5 and ts.step.dtype == torch.int32
    if ts.m is not None:
        for a, b in zip(jax.tree.leaves(js.m), tree_leaves(ts.m)):
            assert b.dtype == (torch.float32 if opt == "adamw"
                               else torch.bfloat16)
            assert _ulps(b.float(), np.asarray(a, np.float32)) <= 2.0 * (
                1 if opt == "adamw" else 2 ** 16)    # bf16: within its ulp
    jv = jax.tree.leaves(js.v)
    tv = [x for leaf in tree_leaves(ts.v)
          for x in (leaf if isinstance(leaf, tuple) else (leaf,))]
    assert [tuple(a.shape) for a in jv] == [tuple(b.shape) for b in tv]
    for a, b in zip(jv, tv):
        assert _ulps(b, a) <= 4.0


def test_adamw_bf16_params_match_reference():
    rng = np.random.default_rng(1)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=10)
    P = _tree(rng, SHAPES)
    jp = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), P)
    tp = tree_map(lambda a: torch.tensor(a).to(torch.bfloat16), P)
    js = JO.init_opt(jbase.TrainConfig(**kw), jp)
    ts = O.init_opt(TrainConfig(**kw), tp)
    G = _tree(rng, SHAPES)
    jp, js = JO.apply_opt(jbase.TrainConfig(**kw), jp, _jax(G), js)
    tp, ts = O.apply_opt(TrainConfig(**kw), tp, _torch(G), ts)
    for a, b in zip(jax.tree.leaves(jp), tree_leaves(tp)):
        assert b.dtype == torch.bfloat16
        want = np.asarray(a, np.float32)
        diff = np.abs(b.float().numpy() - want)
        assert np.max(diff) <= np.max(np.abs(want)) * 2.0 ** -8


@pytest.mark.parametrize("step", [0, 1, 50, 99, 100, 101, 500, 999, 1000,
                                  1200])
def test_cosine_lr_is_the_references(step):
    kw = dict(lr=3e-4, warmup_steps=100, total_steps=1000)
    want = JO.cosine_lr(jbase.TrainConfig(**kw), jnp.int32(step))
    got = O.cosine_lr(TrainConfig(**kw),
                      torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32 and got.ndim == 0
    assert np.float32(got) == np.asarray(want)


def test_clip_by_global_norm_matches_reference():
    rng = np.random.default_rng(2)
    G = _tree(rng, SHAPES)
    jg, jn = JO.clip_by_global_norm(_jax(G), 1.0)
    tg, tn = O.clip_by_global_norm(_torch(G), 1.0)
    assert abs(float(tn) - float(jn)) <= 2 * F32_ULP * float(jn)
    for a, b in zip(jax.tree.leaves(jg), tree_leaves(tg)):
        assert _ulps(b, a) <= 2.0
    inplace = _torch(G)
    held = tree_leaves(inplace)
    out, _ = O.clip_by_global_norm(inplace, 1.0, inplace=True)
    assert all(a is b for a, b in zip(held, tree_leaves(out)))
    for a, b in zip(tree_leaves(tg), held):
        assert torch.equal(a, b)


def test_compress_matches_reference_bit_for_bit():
    rng = np.random.default_rng(3)
    P = _tree(rng, SHAPES)
    jef, tef = JC.ef_init(_jax(P)), C.ef_init(_torch(P))
    for frac in (0.1, 0.3, 0.05):
        G = _tree(rng, SHAPES)
        jsent, jef = JC.compress(_jax(G), jef, frac)
        tsent, tef = C.compress(_torch(G), tef, frac)
        for a, b in zip(jax.tree.leaves(jsent), tree_leaves(tsent)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
        for a, b in zip(jax.tree.leaves(jef.residual),
                        tree_leaves(tef.residual)):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_topk_mask_matches_reference():
    x = np.random.default_rng(4).normal(size=(7, 9)).astype(np.float32)
    x[0, :3] = 5.0                              # ties at the threshold
    for frac in (0.01, 0.05, 0.5, 1.0):
        np.testing.assert_array_equal(
            C._topk_mask(torch.tensor(x), frac).numpy(),
            np.asarray(JC._topk_mask(jnp.asarray(x), frac)))


def test_adamw_and_adafactor_optimize_quadratic():
    for opt in ("adamw", "adafactor"):
        tc = TrainConfig(lr=0.1, warmup_steps=1, total_steps=2000,
                         optimizer=opt, weight_decay=0.0)
        params = {"w": torch.tensor([[3.0, -2.0], [1.0, 4.0]])}
        st = O.init_opt(tc, params)
        for _ in range(200):
            grads = {"w": 2 * params["w"]}       # d/dw ||w||^2
            params, st = O.apply_opt(tc, params, grads, st)
        assert float(torch.max(torch.abs(params["w"]))) < 0.5, opt


def test_gradient_compression_error_feedback():
    params = {"w": torch.zeros((8, 8))}
    ef = C.ef_init(params)
    g = {"w": torch.tensor(np.random.default_rng(0).normal(size=(8, 8)),
                           dtype=torch.float32)}
    sent1, ef = C.compress(g, ef, frac=0.1)
    assert int(torch.sum(sent1["w"] != 0)) <= 8   # top-k by magnitude
    # residual carries the unsent mass: sent + residual == accumulated grad
    torch.testing.assert_close(sent1["w"] + ef.residual["w"], g["w"],
                               atol=1e-6, rtol=0)
    sent2, ef2 = C.compress({"w": torch.zeros((8, 8))}, ef, frac=0.1)
    assert float(torch.sum(torch.abs(ef2.residual["w"]))) \
        < float(torch.sum(torch.abs(ef.residual["w"])))


def test_clip_by_global_norm():
    clipped, gn = O.clip_by_global_norm({"w": torch.full((10,), 10.0)},
                                        1.0)
    assert float(gn) == pytest.approx(np.sqrt(1000.0), rel=1e-5)
    assert float(torch.linalg.norm(clipped["w"])) == pytest.approx(
        1.0, rel=1e-4)


def test_momentum_free_adafactor_state_is_smaller():
    params = {"w": torch.zeros((64, 64)), "b": torch.zeros((64,))}
    st_m = O.init_opt(TrainConfig(optimizer="adafactor", b1=0.9), params)
    st_0 = O.init_opt(TrainConfig(optimizer="adafactor", b1=0.0), params)
    assert st_0.m is None and st_m.m is not None
    assert st_m.m["w"].dtype == torch.bfloat16
    assert [tuple(t.shape) for t in st_0.v["w"]] == [(64,), (64,)]
    tc = TrainConfig(optimizer="adafactor", b1=0.0, lr=0.1,
                     warmup_steps=1, total_steps=2000, weight_decay=0.0)
    p = {"w": torch.full((4, 4), 3.0)}
    st = O.init_opt(tc, p)
    for _ in range(200):
        p, st = O.apply_opt(tc, p, {"w": 2 * p["w"]}, st)
    assert float(torch.max(torch.abs(p["w"]))) < 0.5


# ------------------------------------------------------- loss and grad ----


def _params(name, **replace):
    cfg = jconfigs.smoke_config(name).replace(**replace)
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tcfg = configs.smoke_config(name).replace(**replace)
    return cfg, jp, tcfg, M.params_from_numpy(jax.device_get(jp), device=CPU)


def _batch(cfg, seq=16, B=2):
    """The reference's train batch (f32 extras) and the port's copy."""
    S_ = seq + (cfg.n_patches if cfg.family == "vlm" else 0)
    want = jtokens.make_batch(cfg, jbase.ShapeConfig("t", S_, B, "train"),
                              dtype=jnp.float32)
    got = {k: (torch.from_numpy(np.array(v))
               if k in ("patches", "enc_frames") else np.asarray(v))
           for k, v in want.items()}
    return got, want


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_grad_match_reference(name):
    cfg, jp, tcfg, tp = _params(name)
    got, want = _batch(cfg)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: JS.loss_fn(p, cfg, b), has_aux=True))(jp, want)
    metrics, grads = S.value_and_grad(tp, tcfg, got)
    total, m2 = S.loss_fn(tp, tcfg, got)
    assert float(total) == float(metrics["loss"])
    for k in ("loss", "ce", "aux"):
        assert metrics[k].dtype == torch.float32 and metrics[k].ndim == 0
        assert abs(float(metrics[k]) - float(jm[k])) \
            <= 2e-5 * max(abs(float(jm[k])), 1.0)
    flat = jax.tree_util.tree_flatten_with_path(jg)[0]
    leaves = tree_leaves(grads)
    assert len(flat) == len(leaves)
    for (kp, a), b in zip(flat, leaves):
        a = np.asarray(a)
        assert b.shape == a.shape, kp
        scale = float(np.max(np.abs(a))) or 1.0
        np.testing.assert_allclose(b.numpy(), a, rtol=0, atol=2e-5 * scale,
                                   err_msg=str(kp))
    for p in tree_leaves(tp):
        assert not p.requires_grad and p.grad is None


@pytest.mark.parametrize("name", ["gemma-2b", "deepseek-v3-671b"])
def test_chunked_ce_equals_full(name):
    cfg, _, tcfg, tp = _params(name)
    got, _ = _batch(cfg)
    got["labels"] = got["labels"].copy()
    got["labels"][0, 3] = -1
    full, fm = S.loss_fn(tp, tcfg, got)
    chunked, cm = S.loss_fn(tp, tcfg.replace(ce_chunk=4), got)
    jfull, _ = JS.loss_fn(JM.init_params(cfg, jax.random.PRNGKey(0)),
                          cfg.replace(ce_chunk=4), _batch(cfg)[1] | {
                              "labels": jnp.asarray(got["labels"])})
    np.testing.assert_allclose(float(chunked), float(full), rtol=1e-5)
    np.testing.assert_allclose(float(chunked), float(jfull), rtol=2e-5)
    _, gf = S.value_and_grad(tp, tcfg, got)
    _, gc = S.value_and_grad(tp, tcfg.replace(ce_chunk=4), got)
    for a, b in zip(tree_leaves(gf), tree_leaves(gc)):
        scale = float(torch.amax(torch.abs(a))) or 1.0
        assert float(torch.amax(torch.abs(a - b))) <= 2e-5 * scale


@pytest.mark.parametrize("name,replace", [
    ("whisper-large-v3", {"head_pad": 8}),
    ("phi3-mini-3.8b", {"head_pad": 8}),
    ("internvl2-1b", {"vocab": 123, "vocab_pad": 64}),
    ("whisper-large-v3", {"vocab": 123, "vocab_pad": 256, "head_pad": 32}),
], ids=["whisper-head_pad", "phi3-head_pad", "internvl-vocab_pad",
        "whisper-optimized"])
def test_padded_forward_and_loss_match_reference(name, replace):
    """The optimized mode's padding flags on one rank against the
    reference's forward and loss, on its own weights: the logits (padding
    rows masked to -1e30 in both) within 2e-5 of scale, the loss and its
    parts as ``test_loss_and_grad_match_reference``'s."""
    cfg, jp, tcfg, tp = _params(name, **replace)
    assert tcfg.eff_heads > tcfg.n_heads or tcfg.padded_vocab > tcfg.vocab
    got, want = _batch(cfg)
    jl, _ = JM.forward(jp, cfg, want)
    tl, _ = M.forward(tp, tcfg, got)
    jl = np.asarray(jl)
    assert tl.shape == jl.shape and tl.shape[-1] == tcfg.padded_vocab
    real = jl[..., :cfg.vocab]
    scale = float(np.max(np.abs(real)))
    np.testing.assert_allclose(tl[..., :cfg.vocab].numpy(), real, rtol=0,
                               atol=2e-5 * scale)
    np.testing.assert_array_equal(tl[..., cfg.vocab:].numpy(),
                                  jl[..., cfg.vocab:])
    _, jm = JS.loss_fn(jp, cfg, want)
    _, metrics = S.loss_fn(tp, tcfg, got)
    for k in ("loss", "ce", "aux"):
        assert abs(float(metrics[k]) - float(jm[k])) \
            <= 2e-5 * max(abs(float(jm[k])), 1.0)


@pytest.mark.parametrize("mode", ["full", "dots"])
@pytest.mark.parametrize("name", ["gemma-2b", "internvl2-1b",
                                  "phi3.5-moe-42b-a6.6b", "deepseek-v3-671b",
                                  "rwkv6-3b", "zamba2-2.7b",
                                  "whisper-large-v3"])
def test_remat_modes_give_equal_gradients(name, mode):
    """Rematerialized layers recompute the same bits: the gradient under
    ``remat`` "full" and "dots" equals "none"'s bit for bit on the CPU."""
    cfg, _, tcfg, tp = _params(name)
    got, _ = _batch(cfg)
    base_m, base = S.value_and_grad(tp, tcfg.replace(remat="none"), got)
    m, g = S.value_and_grad(tp, tcfg.replace(remat=mode), got)
    assert float(m["loss"]) == float(base_m["loss"])
    for a, b in zip(tree_leaves(base), tree_leaves(g)):
        assert torch.equal(a, b)


def test_remat_refuses_an_unknown_mode():
    cfg, _, tcfg, tp = _params("gemma-2b")
    got, _ = _batch(cfg)
    with pytest.raises(ValueError, match="remat"):
        S.value_and_grad(tp, tcfg.replace(remat="some"), got)


class _CountOps(TorchDispatchMode):
    """Counts the aten ops that run under it: matrix products and all."""

    def __init__(self):
        super().__init__()
        self.mm = self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops += 1
        self.mm += func in (torch.ops.aten.mm.default,
                            torch.ops.aten.addmm.default)
        return func(*args, **(kwargs or {}))


def test_remat_modes_recompute_what_they_do_not_save():
    """In the backward, "full" recomputes each layer's products (more
    ``mm``s than "none"), "dots" keeps them (as many ``mm``s as "none")
    and recomputes the rest (more ops than "none")."""
    cfg, _, tcfg, tp = _params("gemma-2b")
    got, _ = _batch(cfg)
    counts = {}
    for mode in ("none", "dots", "full"):
        live = tree_map(lambda p: p.detach().requires_grad_(), tp)
        total, _ = S.loss_fn(live, tcfg.replace(remat=mode), got)
        with _CountOps() as c:
            torch.autograd.grad(total, tree_leaves(live))
        counts[mode] = (c.mm, c.ops)
    assert counts["dots"][0] == counts["none"][0] < counts["full"][0]
    assert counts["none"][1] < counts["dots"][1] < counts["full"][1]


# --------------------------------------------------------- train step ----


@pytest.mark.parametrize("name", ARCHS)
def test_forward_and_train_step(name):
    """The counterpart of tests/test_models_smoke.py::
    test_forward_and_train_step, with the input state held unchanged, the
    in-place route equal bit for bit, and the loss and gradient norm
    against the reference's step on the same weights."""
    cfg, jp, tcfg, tp = _params(name)
    got, want = _batch(cfg)
    jtc = jbase.TrainConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    tc = TrainConfig(lr=1e-2, warmup_steps=1, total_steps=4)
    state = S.TrainState(params=tp, opt=O.init_opt(tc, tp), ef=None)
    logits, aux = M.forward(state.params, tcfg, got)
    assert logits.shape[0] == 2 and logits.shape[-1] == cfg.vocab
    assert bool(torch.all(torch.isfinite(logits)))
    before = [t.clone() for t in tree_leaves(state.params)]
    state2, metrics = S.build_train_step(tcfg, tc)(state, got)
    assert np.isfinite(float(metrics["loss"]))
    assert sorted(metrics) == ["aux", "ce", "grad_norm", "loss"]
    for a, b in zip(before, tree_leaves(state.params)):
        assert torch.equal(a, b)                 # input state unchanged
    assert int(state.opt.step) == 0 and int(state2.opt.step) == 1
    delta = sum(float(torch.sum(torch.abs(a - b)))
                for a, b in zip(tree_leaves(state.params),
                                tree_leaves(state2.params)))
    assert delta > 0                             # parameters changed
    donated = S.TrainState(params=tree_map(torch.clone, tp),
                           opt=O.init_opt(tc, tp), ef=None)
    state3, m3 = S.build_train_step(tcfg, tc, donate=True)(donated, got)
    assert state3.params["embed"] is donated.params["embed"]
    for a, b in zip(tree_leaves(state2.params), tree_leaves(state3.params)):
        assert torch.equal(a, b)
    for k in metrics:
        assert float(metrics[k]) == float(m3[k])
    jstate = JS.init_state(cfg, jtc, jax.random.PRNGKey(0))
    _, jm = jax.jit(JS.build_train_step(cfg, jtc))(
        jstate._replace(params=jp), want)
    for k in ("loss", "grad_norm"):
        assert abs(float(metrics[k]) - float(jm[k])) \
            <= 2e-5 * abs(float(jm[k]))


def test_train_step_with_compression_matches_reference_state():
    """The step's clip and error feedback on the same weights: the
    residual after one step within 2e-5 of the reference's scale."""
    cfg, jp, tcfg, tp = _params("phi3-mini-3.8b")
    got, want = _batch(cfg)
    kw = dict(lr=1e-2, warmup_steps=1, total_steps=4, compress_grads=True,
              topk_frac=0.5, optimizer="adafactor", b1=0.0)
    jtc, tc = jbase.TrainConfig(**kw), TrainConfig(**kw)
    js = JS.init_state(cfg, jtc, jax.random.PRNGKey(0))._replace(params=jp)
    ts = S.TrainState(params=tp, opt=O.init_opt(tc, tp), ef=C.ef_init(tp))
    js, jm = jax.jit(JS.build_train_step(cfg, jtc))(js, want)
    ts, tm = S.build_train_step(tcfg, tc)(ts, got)
    assert ts.opt.m is None
    flat = jax.tree.leaves(js.ef.residual)
    for a, b in zip(flat, tree_leaves(ts.ef.residual)):
        a = np.asarray(a)
        scale = float(np.max(np.abs(a))) or 1.0
        assert float(np.max(np.abs(b.numpy() - a))) <= 2e-5 * scale


def test_entry_points_default_to_the_card():
    for fn in (S.init_state, train, make_batch):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    cfg = configs.smoke_config("gemma-2b")
    tc = TrainConfig(compress_grads=True)
    st = S.init_state(cfg, tc, torch.Generator().manual_seed(0),
                      device=CPU)
    assert st.ef is not None and st.opt.step.dtype == torch.int32
    assert st.params["embed"].device.type == "cpu"


@pytest.mark.parametrize("name", ["gemma-2b", "rwkv6-3b", "zamba2-2.7b",
                                  "deepseek-v3-671b"])
def test_serve_step_matches_reference(name):
    cfg, jp, tcfg, tp = _params(name)
    B, P, steps = 2, 8, 4
    prompt = np.random.default_rng(5).integers(
        0, cfg.vocab, (B, P)).astype(np.int32)
    _, jcache, jpos = JM.prefill(jp, cfg, {"tokens": jnp.asarray(prompt)},
                                 P + steps, cache_dtype=jnp.float32)
    _, cache, pos = M.prefill(tp, tcfg, {"tokens": prompt}, P + steps,
                              cache_dtype=torch.float32)
    jstep = jax.jit(JS.build_serve_step(cfg))
    step = S.build_serve_step(tcfg)
    tok = prompt[:, -1:]
    for i in range(steps):
        jnxt, jcache = jstep(jp, jcache, jnp.asarray(tok), jpos + i)
        nxt, cache = step(tp, cache, tok, pos + i)
        assert nxt.dtype == torch.int32 and tuple(nxt.shape) == (B, 1)
        np.testing.assert_array_equal(nxt.numpy(), np.asarray(jnxt))
        tok = nxt.numpy()


# ----------------------------------------------------------- the loop ----


def test_loss_decreases(tmp_path):
    cfg = configs.smoke_config("gemma-2b")
    _, hist = train(cfg, _tc(tmp_path, total_steps=15), SHAPE,
                    log=lambda s: None, device=CPU)
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert any("vat_block_score" in h for h in hist)  # diagnostics ran


def test_resume_is_bitwise_deterministic(tmp_path):
    cfg = configs.smoke_config("phi3-mini-3.8b")
    a, b = tmp_path / "a", tmp_path / "b"
    state_full, hist_full = train(cfg, _tc(a, total_steps=8, ckpt_every=4),
                                  SHAPE, log=lambda s: None, device=CPU)
    tc2 = _tc(b, total_steps=8, ckpt_every=4)
    with pytest.raises(KeyboardInterrupt):
        train(cfg, tc2, SHAPE, log=lambda s: None, interrupt_at=5,
              device=CPU)
    logs = []
    state_res, hist_res = train(cfg, tc2, SHAPE, log=logs.append,
                                device=CPU)
    assert any("[resume] restored step 4" in line for line in logs)
    assert hist_res == hist_full[4:]
    full, res = dict(_walk(state_full)), dict(_walk(state_res))
    assert list(full) == list(res)
    for k in full:
        assert torch.equal(full[k], res[k]), k


def test_straggler_deadline_skips(tmp_path):
    cfg = configs.smoke_config("gemma-2b")
    logs = []
    _, hist = train(cfg, _tc(tmp_path, total_steps=4), SHAPE,
                    log=logs.append, step_deadline_s=1e-12, device=CPU)
    assert len(hist) == 0                    # every batch skipped, no hang
    assert any("straggler" in line for line in logs)


def test_vat_diagnostics_in_training(tmp_path):
    """The counterpart of tests/test_system.py::
    test_vat_diagnostics_in_training: internvl2-1b (patches in the batch)
    through the loop, two diag steps, Hopkins in [0, 1]."""
    cfg = configs.smoke_config("internvl2-1b")
    tc = TrainConfig(total_steps=6, diag_every=3, ckpt_every=100,
                     ckpt_dir=str(tmp_path), lr=1e-3)
    _, hist = train(cfg, tc, ShapeConfig("t", 32, 4, "train"),
                    log=lambda s: None, device=CPU)
    diag = [h for h in hist if "vat_block_score" in h]
    assert len(diag) == 2
    assert all(0 <= h["hopkins"] <= 1 for h in diag)


def test_loop_batches_are_make_batch(tmp_path):
    """The loop's batch of a step is ``make_batch``'s for that step, on
    the loop's device: one step from a fresh state equals the step
    function on that batch."""
    cfg = configs.smoke_config("gemma-2b")
    tc = _tc(tmp_path, total_steps=1, diag_every=100)
    state, hist = train(cfg, tc, SHAPE, log=lambda s: None, device=CPU)
    from repro_torch.data.tokens import SyntheticCorpus
    batch = make_batch(cfg, SHAPE, step=0,
                       corpus=SyntheticCorpus(cfg.vocab, seed=tc.seed),
                       device=CPU)
    fresh = S.init_state(cfg, tc, torch.Generator().manual_seed(tc.seed),
                         device=CPU)
    want, metrics = S.build_train_step(cfg, tc)(fresh, batch)
    assert hist[0]["loss"] == float(metrics["loss"])
    for a, b in zip(tree_leaves(want.params), tree_leaves(state.params)):
        assert torch.equal(a, b)
