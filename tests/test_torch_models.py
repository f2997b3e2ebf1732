"""The port's model zoo (``dense`` and ``vlm`` families; the others are
in ``test_torch_families.py`` and ``test_torch_decode.py``) held on the
CPU against the JAX package.

* ``configs``: every ``ARCHS`` entry and every ``smoke_config`` field for
  field, with the derived sizes; the shapes, ``TrainConfig``, ``cells``.
* ``data/tokens.py``: ``tokens`` and ``labels`` bit for bit, and the vlm
  ``patches`` bit for bit in bfloat16.
* The building blocks on the same seeded inputs: ``rms_norm``,
  ``layer_norm``, the RoPE tables and rotation, the four activations,
  ``attention`` (chunked and not, MHA / GQA / MQA, causal and not),
  ``gqa_block`` and ``dense_ffn``, within 2e-6 of each output's scale (f32
  products summed in another order; the activations within 1e-6).
* ``forward`` at smoke size for the five dense/vlm archs through
  ``params_from_numpy``: logits, ``return_hidden`` and ``taps`` at rtol =
  atol = 2e-5 (f32 through two layers, each a few matmuls and a softmax
  summed in another order than XLA's).
* The padding features (odd vocab, padded heads) as the reference's own
  tests state them, on the port.
* ``init_params``: the reference's leaf names and shapes; truncated
  draws.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.data import tokens as jtokens
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import model as JM
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.data import tokens
from repro_torch.models import attention, common, moe
from repro_torch.models import model as M

CPU = "cpu"
PORTED = ("gemma-2b", "phi3-mini-3.8b", "nemotron-4-15b", "starcoder2-7b",
          "internvl2-1b")
DERIVED = ("padded_vocab", "eff_heads", "eff_kv_heads", "q_dim", "kv_dim",
           "gated")


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, rel: float):
    want = np.asarray(want)
    scale = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=rel * scale)


def _params(name: str, *, seed: int = 0, **replace):
    """The reference's smoke-size weights, and the port's copy of them."""
    cfg = jconfigs.smoke_config(name).replace(**replace)
    jp = JM.init_params(cfg, jax.random.PRNGKey(seed))
    tcfg = configs.smoke_config(name).replace(**replace)
    return cfg, jp, tcfg, M.params_from_numpy(jax.device_get(jp), device=CPU)


# ------------------------------------------------------------ configs ----


def _fields(cfg) -> dict:
    return {**dataclasses.asdict(cfg),
            **{k: getattr(cfg, k) for k in DERIVED}}


@pytest.mark.parametrize("name", sorted(jconfigs.ARCHS))
def test_config_matches_reference(name):
    assert type(configs.ARCHS[name]) is base.ModelConfig
    assert _fields(configs.ARCHS[name]) == _fields(jconfigs.ARCHS[name])
    assert _fields(configs.get_config(name)) == _fields(
        jconfigs.get_config(name))
    assert _fields(configs.smoke_config(name)) == _fields(
        jconfigs.smoke_config(name))
    assert configs.cells(name) == jconfigs.cells(name)


def test_config_registry_matches_reference():
    assert list(configs.ARCHS) == list(jconfigs.ARCHS)
    assert configs.SUBQUADRATIC == jconfigs.SUBQUADRATIC
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jconfigs.SHAPES.items()}
    assert dataclasses.asdict(base.TrainConfig()) == \
        dataclasses.asdict(jbase.TrainConfig())
    with pytest.raises(KeyError, match="unknown arch"):
        configs.get_config("gpt-9")
    cfg = configs.get_config("gemma-2b").replace(vocab_pad=1024, head_pad=8)
    ref = jconfigs.get_config("gemma-2b").replace(vocab_pad=1024, head_pad=8)
    assert _fields(cfg) == _fields(ref)


# ------------------------------------------------------------- tokens ----


@pytest.mark.parametrize("name,shape", [
    ("gemma-2b", base.ShapeConfig("t", 48, 3, "train")),
    ("internvl2-1b", base.ShapeConfig("p", 300, 2, "prefill")),
    ("phi3-mini-3.8b", base.ShapeConfig("d", 64, 4, "decode")),
])
@pytest.mark.parametrize("step", [0, 5])
def test_make_batch_matches_reference(name, shape, step):
    jshape = jbase.ShapeConfig(shape.name, shape.seq_len, shape.global_batch,
                               shape.kind)
    for cfg, jcfg in ((configs.smoke_config(name),
                       jconfigs.smoke_config(name)),
                      (configs.get_config(name), jconfigs.get_config(name))):
        got = tokens.make_batch(cfg, shape, step, device=CPU)
        want = jtokens.make_batch(jcfg, jshape, step)
        assert sorted(got) == sorted(want)
        for key in ("tokens", "labels"):
            if key in want:
                assert got[key].dtype == np.int32
                np.testing.assert_array_equal(got[key], want[key])
        if "patches" in want:
            p = got["patches"]
            assert p.dtype == torch.bfloat16 and p.device.type == CPU
            np.testing.assert_array_equal(
                p.view(torch.int16).numpy(),
                np.asarray(want["patches"]).view(np.int16))


def test_corpus_is_the_references():
    got = tokens.SyntheticCorpus(1000, seed=3).batch(4, 40, step=2)
    want = jtokens.SyntheticCorpus(1000, seed=3).batch(4, 40, step=2)
    for key in ("tokens", "labels"):
        np.testing.assert_array_equal(got[key], want[key])


# ------------------------------------------------------ building blocks ----


def test_norms_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 7, 32)).astype(np.float32) * 3
    scale = rng.normal(size=32).astype(np.float32) * 0.1
    bias = rng.normal(size=32).astype(np.float32)
    _close(common.rms_norm(_t(x), _t(scale), 1e-5),
           jcommon.rms_norm(jnp.asarray(x), jnp.asarray(scale), 1e-5), 1e-6)
    _close(common.layer_norm(_t(x), _t(scale), _t(bias)),
           jcommon.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                              jnp.asarray(bias)), 1e-6)
    # f32 compute, cast back to the input's dtype
    xb = _t(x).to(torch.bfloat16)
    assert common.rms_norm(xb, _t(scale)).dtype == torch.bfloat16
    _close(common.sinusoidal_pos(12, 16, device=CPU),
           jcommon.sinusoidal_pos(12, 16), 1e-6)


@pytest.mark.parametrize("name", ["swiglu", "geglu", "gelu", "relu2"])
def test_activation_matches_reference(name):
    x = np.linspace(-6, 6, 1001, dtype=np.float32)
    _close(common.activation(name)(_t(x)),
           jcommon.activation(name)(jnp.asarray(x)), 1e-6)


def test_unknown_activation_raises():
    with pytest.raises(ValueError, match="unknown activation"):
        common.activation("tanh")


@pytest.mark.parametrize("dim,theta", [(16, 10_000.0), (256, 10_000.0),
                                       (64, 500_000.0)])
def test_rope_matches_reference(dim, theta):
    pos = np.arange(0, 4096, 37, dtype=np.int32)
    cos, sin = common.rope_freqs(_t(pos), dim, theta)
    jcos, jsin = jcommon.rope_freqs(jnp.asarray(pos), dim, theta)
    _close(cos, jcos, 2e-6)
    _close(sin, jsin, 2e-6)
    rng = np.random.default_rng(dim)
    x = rng.normal(size=(2, len(pos), 3, dim)).astype(np.float32)
    _close(common.apply_rope(_t(x), _t(np.asarray(jcos)), _t(np.asarray(jsin))),
           jcommon.apply_rope(jnp.asarray(x), jcos, jsin), 1e-6)


@pytest.mark.parametrize("heads", [(4, 4), (4, 2), (8, 1)],
                         ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("chunk", [0, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_attention_matches_reference(heads, chunk, causal):
    H, Hkv = heads
    B, S, hd = 2, 32, 16
    rng = np.random.default_rng(H * 10 + Hkv)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, S, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, S, Hkv, hd)).astype(np.float32)
    got = attention.attention(_t(q), _t(k), _t(v), causal=causal,
                              chunk=chunk)
    want = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal, chunk=chunk)
    assert got.shape == (B, S, H, hd)
    _close(got, want, 2e-6)


def test_attention_groups_query_heads_by_kv_head():
    """Query head g·rep + r reads KV head g: with rep = 2 and KV head 1's
    values zero, query heads 2 and 3 give zero and 0 and 1 do not."""
    rng = np.random.default_rng(0)
    q = _t(rng.normal(size=(1, 8, 4, 16)).astype(np.float32))
    k = _t(rng.normal(size=(1, 8, 2, 16)).astype(np.float32))
    v = _t(rng.normal(size=(1, 8, 2, 16)).astype(np.float32))
    v[:, :, 1] = 0
    out = attention.attention(q, k, v, causal=True)
    assert not out[:, :, 2:].any()
    assert bool(out[:, :, :2].abs().amax(dim=-1).gt(0).all())


@pytest.mark.parametrize("name", PORTED)
def test_blocks_match_reference(name):
    cfg, jp, tcfg, tp = _params(name)
    lp = {k: v[0] for k, v in tp["layers"].items()}
    jlp = {k: v[0] for k, v in jp["layers"].items()}
    rng = np.random.default_rng(1)
    h = rng.normal(size=(2, 16, cfg.d_model)).astype(np.float32)
    cos, sin = jcommon.rope_freqs(jnp.arange(16), cfg.head_dim,
                                  cfg.rope_theta)
    tcos, tsin = common.rope_freqs(torch.arange(16), tcfg.head_dim,
                                   tcfg.rope_theta)
    want, _ = jattn.gqa_block(jlp, jnp.asarray(h), cfg, cos, sin)
    got, cache = attention.gqa_block(lp, _t(h), tcfg, tcos, tsin)
    assert cache is None
    _close(got, want, 2e-6)
    _close(moe.dense_ffn(lp, _t(h), tcfg),
           jmoe.dense_ffn(jlp, jnp.asarray(h), cfg), 2e-6)


# ------------------------------------------------------------ forward ----


def _batches(name: str, cfg, seq: int = 16, B: int = 2):
    S = seq + (cfg.n_patches if cfg.family == "vlm" else 0)
    want = jtokens.make_batch(cfg, jbase.ShapeConfig("f", S, B, "prefill"),
                              dtype=jnp.float32)
    got = {k: (_t(v) if k == "patches" else np.asarray(v))
           for k, v in want.items()}
    return got, want


@pytest.mark.parametrize("name", PORTED)
def test_forward_matches_reference(name):
    cfg, jp, tcfg, tp = _params(name)
    got, want = _batches(name, cfg)
    logits, aux, taps = M.forward(tp, tcfg, got, taps=True)
    jlogits, jaux, jtaps = JM.forward(jp, cfg, want, taps=True)
    hidden, _ = M.forward(tp, tcfg, got, return_hidden=True)
    jhidden, _ = JM.forward(jp, cfg, want, return_hidden=True)
    assert logits.dtype == torch.float32 and float(aux) == float(jaux) == 0
    assert logits.shape == jlogits.shape == (2, 16, cfg.padded_vocab)
    assert hidden.shape == (2, 16, cfg.d_model)
    assert taps["layer_out"].shape == jtaps["layer_out"].shape
    for a, b in ((logits, jlogits), (hidden, jhidden),
                 (taps["layer_out"], jtaps["layer_out"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-5)
    # the last tap is the final hidden state (patch positions included)
    tail = taps["layer_out"][-1][:, -16:]
    np.testing.assert_array_equal(tail.numpy(), hidden.numpy())


def test_forward_accepts_tensor_tokens_and_bf16_params():
    cfg, jp, tcfg, tp = _params("gemma-2b")
    got, _ = _batches("gemma-2b", cfg)
    a, _ = M.forward(tp, tcfg, got)
    b, _ = M.forward(tp, tcfg, {"tokens": torch.from_numpy(got["tokens"])})
    assert torch.equal(a, b)
    tb = M.params_from_numpy(jax.device_get(
        jax.tree.map(lambda x: x.astype(jnp.bfloat16), jp)), device=CPU)
    assert tb["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tb["embed"].float().numpy(),
        np.asarray(jp["embed"].astype(jnp.bfloat16).astype(jnp.float32)))
    h, _ = M.forward(tb, tcfg, got, return_hidden=True)
    assert h.dtype == torch.bfloat16 and bool(torch.isfinite(h).all())


def test_vocab_padding_preserves_logits():
    """The counterpart of tests/test_perf_features.py::
    test_vocab_padding_preserves_logits, on the port."""
    cfg0 = configs.smoke_config("phi3-mini-3.8b").replace(vocab=123)
    cfgp = cfg0.replace(vocab_pad=64)                          # pads to 128
    assert cfgp.padded_vocab == 128
    p0 = M.init_params(cfg0, torch.Generator().manual_seed(0), device=CPU)
    pp = M.init_params(cfgp, torch.Generator().manual_seed(0), device=CPU)
    pp["embed"][:123] = p0["embed"]
    pp["lm_head"][:, :123] = p0["lm_head"]
    pp["layers"] = p0["layers"]
    pp["final_norm"] = p0["final_norm"]
    toks = np.asarray([[1, 2, 3, 4]], np.int32)
    l0, _ = M.forward(p0, cfg0, {"tokens": toks})
    lp, _ = M.forward(pp, cfgp, {"tokens": toks})
    np.testing.assert_allclose(lp[..., :123].numpy(), l0.numpy(), atol=1e-5)
    assert bool((torch.argmax(lp, -1) < 123).all())


def test_head_padding_exact_function():
    """The counterpart of tests/test_perf_features.py::
    test_head_padding_exact_function, on an MHA dense arch: the padded
    model with zero extra heads is the same function, bit for bit."""
    cfg0 = configs.smoke_config("phi3-mini-3.8b")
    cfgp = cfg0.replace(head_pad=8)
    assert cfgp.eff_heads == 8 and cfg0.eff_heads == 4
    p0 = M.init_params(cfg0, torch.Generator().manual_seed(0), device=CPU)
    pp = M.init_params(cfgp, torch.Generator().manual_seed(0), device=CPU)
    for w in ("wq", "wk", "wv"):
        pp["layers"][w] = torch.zeros_like(pp["layers"][w])
        pp["layers"][w][..., :p0["layers"][w].shape[-1]] = p0["layers"][w]
    pp["layers"]["wo"] = torch.zeros_like(pp["layers"]["wo"])
    pp["layers"]["wo"][..., :p0["layers"]["wo"].shape[-2], :] = \
        p0["layers"]["wo"]
    for w in pp["layers"]:
        if w not in ("wq", "wk", "wv", "wo"):
            pp["layers"][w] = p0["layers"][w]
    for k in ("embed", "lm_head", "final_norm"):
        pp[k] = p0[k]
    toks = np.asarray([[1, 2, 3, 4]], np.int32)
    l0, _ = M.forward(p0, cfg0, {"tokens": toks})
    lp, _ = M.forward(pp, cfgp, {"tokens": toks})
    assert torch.equal(l0, lp)


# --------------------------------------------------------------- init ----


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


@pytest.mark.parametrize("name", PORTED)
@pytest.mark.parametrize("replace", [{}, {"vocab": 123, "vocab_pad": 64}],
                         ids=["exact", "vocab_pad"])
def test_init_params_tree_matches_reference(name, replace):
    cfg = jconfigs.smoke_config(name).replace(**replace)
    tcfg = configs.smoke_config(name).replace(**replace)
    want = jax.eval_shape(lambda k: JM.init_params(cfg, k),
                          jax.random.PRNGKey(0))
    got = M.init_params(tcfg, torch.Generator().manual_seed(0), device=CPU)
    assert _shapes(got) == _shapes(want)
    assert list(got["layers"]) == sorted(got["layers"])
    assert all(v.dtype == torch.float32 for v in got["layers"].values())
    assert not got["final_norm"].any() and not got["layers"]["ln1"].any()
    again = M.init_params(tcfg, torch.Generator().manual_seed(0), device=CPU)
    assert all(torch.equal(again["layers"][k], v)
               for k, v in got["layers"].items())
    half = M.init_params(tcfg, torch.Generator().manual_seed(0),
                         dtype=torch.bfloat16, device=CPU)
    assert half["embed"].dtype == torch.bfloat16


def test_dense_init_is_a_truncated_normal():
    gen = torch.Generator().manual_seed(0)
    w = common.dense_init(gen, (256, 512), device=CPU)
    scale = 256 ** -0.5
    assert float(w.abs().max()) <= 2 * scale * (1 + 1e-6)
    # N(0, 1) truncated at ±2 has std 0.8796
    assert abs(float(w.std()) / scale - 0.8796) < 0.01
    assert abs(float(w.mean()) / scale) < 0.01
    e = common.dense_init(gen, (1000, 64), 0.02, dtype=torch.bfloat16,
                          device=CPU)
    assert e.dtype == torch.bfloat16
    assert float(e.float().abs().max()) <= 0.04 * (1 + 2 ** -7)
