"""The port's ``embed`` rung (DeepVAT) held on the CPU against the JAX
package.

* The reference's embed cases (``tests/test_monitor.py``: a zoo model's
  activations through the ladder, a callable encoder, the missing
  encoder), on the port.
* ``encode_batch`` against the reference's within 2e-5 (the forward's
  tolerance, ``tests/test_torch_models.py``), and ``meta.encoder`` the
  reference's string for the same weights.
* The ``embed`` order against the reference's: by spanning-tree weight
  within ``EXCESS_F32 = 1e-5`` on float activations (each package orders
  its own forward's activations, which differ in the last bits), bit for
  bit where the encoder's output is integer-valued.
* Inside the port, an ``embed`` fit equals the plain ``FastVAT().fit`` of
  the same activations bit for bit, on the ``vat`` and ``flashvat``
  rungs; an activation tensor on the fit's device is fitted where it is.
* The facade's errors with the reference's messages, and
  ``fit_embeddings`` refusing params on another device.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro
from repro import configs as jconfigs
from repro.configs.base import ShapeConfig as JShape
from repro.data import tokens as jtokens
from repro.models import model as JM
from repro.monitor import probes as jprobes
from repro_torch import FastVAT, configs
from repro_torch.api import registry
from repro_torch.api.registry import RungOptions
from repro_torch.api.result import ResultMeta
from repro_torch.configs.base import ShapeConfig
from repro_torch.data.tokens import make_batch
from repro_torch.models import model as M
from repro_torch.monitor import encode_batch

CPU = "cpu"
EXCESS_F32 = 1e-5
SHAPE = ShapeConfig("tiny", 32, 4, "train")


def _tree_weight(X, order):
    """Spanning-tree weight of a Prim ordering, f64 euclidean."""
    Y = np.float64(X[order])
    sq = np.sum(Y * Y, axis=1)
    d = np.sqrt(np.maximum(sq[:, None] + sq[None, :] - 2.0 * Y @ Y.T, 0))
    lower = np.tri(len(Y), k=-1, dtype=bool)
    return float(np.sum(np.min(np.where(lower, d, np.inf)[1:], axis=1)))


def _model(name: str, seed: int = 0):
    cfg = jconfigs.smoke_config(name)
    jp = JM.init_params(cfg, jax.random.PRNGKey(seed))
    return cfg, jp, configs.smoke_config(name), M.params_from_numpy(
        jax.device_get(jp), device=CPU)


def _batch(cfg, seq=32, B=4):
    S = seq + (cfg.n_patches if cfg.family == "vlm" else 0)
    want = jtokens.make_batch(cfg, JShape("e", S, B, "train"))
    got = {k: (torch.from_numpy(np.array(v.astype(jnp.float32)))
               .to(torch.bfloat16) if k == "patches" else np.asarray(v))
           for k, v in want.items()}
    return got, want


@pytest.fixture
def one_thread():
    """The CPU flashvat traversal is a loop of small torch ops: one intra-op
    thread keeps it from contending with the other test workers' threads
    (both fits of a comparison run under the same setting)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _same_fit(a: FastVAT, b: FastVAT):
    ra, rb = a.result, b.result
    assert torch.equal(ra.order, rb.order)
    assert torch.equal(ra.rstar, rb.rstar)
    assert np.array_equal(a.image(use_ivat=True), b.image(use_ivat=True))
    for f in ("sample_idx", "extension_labels", "group_sizes"):
        x, y = getattr(ra, f), getattr(rb, f)
        assert (x is None and y is None) or torch.equal(x, y)


# ------------------------------------------- the reference's own cases ----


def test_fit_embeddings_routes_through_rung_ladder():
    cfg = configs.smoke_config("gemma-2b")
    params = M.init_params(cfg, torch.Generator().manual_seed(0), device=CPU)
    batch = make_batch(cfg, SHAPE, device=CPU)
    fv = FastVAT(device=CPU)
    res = fv.fit_embeddings(params, cfg, batch).result
    n = SHAPE.global_batch * SHAPE.seq_len
    assert res.meta.method == "embed"
    assert res.meta.n == n
    assert res.meta.encoder is not None and res.meta.encoder.startswith(
        cfg.name + "@")
    assert res.order.shape == (n,)
    rep = fv.assess()
    assert rep.method == "embed"
    assert np.isfinite(rep.hopkins)


def test_fit_with_encoder_callable():
    rng = np.random.default_rng(0)
    X = np.vstack([rng.normal(0, 0.3, (60, 6)),
                   rng.normal(4, 0.3, (60, 6))]).astype(np.float32)

    def encoder(x):
        return torch.tanh(torch.as_tensor(x) @ torch.eye(6, 3))

    fv = FastVAT(seed=0, device=CPU)
    res = fv.fit(X, encoder=encoder).result
    assert res.meta.method == "embed"
    assert "encoder@" in res.meta.encoder      # qualname ends in .encoder
    assert res.order.shape == (120,)
    assert fv.assess().clustered                # two clear blobs survive


def test_embed_method_without_encoder_raises():
    with pytest.raises(ValueError, match="encoder") as got:
        FastVAT(method="embed", device=CPU).fit(np.zeros((10, 3), np.float32))
    with pytest.raises(ValueError, match="encoder") as want:
        repro.FastVAT(method="embed").fit(np.zeros((10, 3), np.float32))
    assert str(got.value) == str(want.value)


# ----------------------------------------------------- against repro ----


@pytest.mark.parametrize("name", ["gemma-2b", "starcoder2-7b",
                                  "internvl2-1b"])
def test_encode_batch_and_fingerprint_match_reference(name):
    cfg, jp, tcfg, tp = _model(name)
    got_b, want_b = _batch(cfg)
    acts = encode_batch(tp, tcfg, got_b)
    want = np.asarray(jprobes.encode_batch(jp, cfg, want_b))
    assert acts.dtype == torch.float32 and not acts.is_inference()
    assert acts.shape == want.shape == (4 * 32, cfg.d_model)
    np.testing.assert_allclose(acts.numpy(), want, rtol=2e-5, atol=2e-5)
    fv = FastVAT(device=CPU).fit_embeddings(tp, tcfg, got_b)
    ref = repro.FastVAT().fit_embeddings(jp, cfg, want_b)
    assert fv.result.meta.encoder == ref.result.meta.encoder
    assert fv.result.meta.n == ref.result.meta.n == 4 * 32
    # each package orders its own activations: by tree weight
    w_got = _tree_weight(want, fv.order())
    w_want = _tree_weight(want, ref.order())
    assert abs(w_got - w_want) <= EXCESS_F32 * w_want
    g, w = fv.assess(), ref.assess()
    assert 0 < g.hopkins < 1 and 0 < w.hopkins < 1


@pytest.mark.parametrize("n", [300, 2_100])
def test_integer_encoder_orders_bit_for_bit(n, one_thread):
    """An integer-valued encoder gives both packages the same activations:
    the orders (vat at 300, flashvat at 2,100) are equal bit for bit."""
    rng = np.random.default_rng(n)
    X = np.concatenate([rng.normal(size=(n // 2, 5)),
                        rng.normal(size=(n - n // 2, 5)) + 6]).astype(
                            np.float32)
    W = rng.normal(size=(5, 3)).astype(np.float32) * 4

    def tencode(x):
        return torch.round(torch.as_tensor(x) @ torch.from_numpy(W))

    def jencode(x):
        return jnp.round(jnp.asarray(x) @ jnp.asarray(W))

    np.testing.assert_array_equal(tencode(X).numpy(),
                                  np.asarray(jencode(X)))
    got = FastVAT(device=CPU, sample_size=64).fit(X, encoder=tencode)
    want = repro.FastVAT(sample_size=64).fit(X, encoder=jencode)
    assert got.result.meta.method == want.result.meta.method == "embed"
    np.testing.assert_array_equal(got.order(), want.order())
    g, w = got.assess(), want.assess()
    assert g.k_est == w.k_est
    assert abs(g.block_score - w.block_score) <= 1e-6


def test_facade_errors_match_reference():
    X = np.random.default_rng(0).normal(size=(40, 3)).astype(np.float32)
    cases = [
        (dict(metric="precomputed"), "x"),
        (dict(method="vat"), "x"),
    ]
    for kw, enc in cases:
        with pytest.raises(ValueError) as got:
            FastVAT(device=CPU, **kw).fit(X, encoder=enc)
        with pytest.raises(ValueError) as want:
            repro.FastVAT(**kw).fit(X, encoder=enc)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="needs an encoder"):
        registry.get_rung("embed").fit(
            torch.from_numpy(X), ResultMeta(method="embed", device=CPU),
            RungOptions())


def test_fit_embeddings_refuses_params_on_another_device():
    cfg, jp, tcfg, _ = _model("gemma-2b")
    on_meta = M.params_from_numpy(jax.device_get(jp), device="meta")
    got_b, _ = _batch(cfg)
    with pytest.raises(ValueError, match="params live on meta"):
        FastVAT(device=CPU).fit_embeddings(on_meta, tcfg, got_b)


# ----------------------------------------------------- inside the port ----


@pytest.mark.parametrize("name,seq", [("gemma-2b", 32),
                                      ("internvl2-1b", 550)],
                         ids=["vat", "flashvat"])
def test_embed_fit_equals_plain_fit(name, seq, one_thread):
    cfg, jp, tcfg, tp = _model(name)
    got_b, _ = _batch(cfg, seq=seq)
    fv = FastVAT(device=CPU).fit_embeddings(tp, tcfg, got_b)
    acts = encode_batch(tp, tcfg, got_b)
    plain = FastVAT(device=CPU).fit(acts)
    assert fv.result.meta.method == "embed"
    assert plain.method_resolved == ("vat" if seq == 32 else "flashvat")
    assert fv.result.meta.n == 4 * seq
    _same_fit(fv, plain)
    assert torch.equal(fv._X, acts)


def test_device_activations_are_fitted_in_place():
    """A tensor on the fit's device is copied there (no host round trip):
    the fit holds its own tensor of the same values."""
    rng = np.random.default_rng(1)
    acts = torch.tensor(rng.normal(size=(200, 8)), dtype=torch.float32)
    for fv in (FastVAT(device=CPU).fit(acts, encoder=lambda x: x),
               FastVAT(device=CPU).fit(acts)):
        assert fv._X is not acts and fv._X.device == acts.device
        assert torch.equal(fv._X, acts)
    # the embed rung keeps a device tensor, and takes a callable itself
    meta = ResultMeta(method="embed", device=CPU)
    res = registry.get_rung("embed").fit(
        acts.reshape(4, 50, 8), meta, RungOptions(encoder=torch.tanh))
    want = FastVAT(device=CPU).fit(torch.tanh(acts))
    assert res.meta.n == 200 and ".tanh@" in res.meta.encoder
    assert torch.equal(res.order, want.result.order)
    assert torch.equal(res.rstar, want.result.rstar)


def _two_blobs(seed: int = 2):
    rng = np.random.default_rng(seed)
    return torch.tensor(np.vstack([rng.normal(0, 0.3, (60, 6)),
                                   rng.normal(4, 0.3, (60, 6))]),
                        dtype=torch.float32)


def test_encoder_output_that_requires_grad_is_detached():
    """An ``nn.Module`` encoder's output carries autograd: the fit, its
    images and ``assess()`` run on a detached copy, equal to the plain fit
    of the detached activations."""
    X = _two_blobs()
    lin = torch.nn.Linear(6, 4)
    with torch.no_grad():
        lin.weight.copy_(torch.eye(4, 6))
        lin.bias.zero_()
    acts = lin(X)
    assert acts.requires_grad
    fv = FastVAT(device=CPU).fit(X, encoder=lin)
    assert not fv._X.requires_grad
    assert not fv.result.rstar.requires_grad
    assert fv.image().shape == (120, 120)
    assert fv.image(use_ivat=True).shape == (120, 120)
    assert fv.assess().clustered
    _same_fit(fv, FastVAT(device=CPU).fit(acts.detach()))
    plain = FastVAT(device=CPU).fit(acts)        # no encoder: the same
    assert not plain._X.requires_grad
    assert plain.image(use_ivat=True).shape == (120, 120)


@pytest.mark.parametrize("encoder", [None, "acts@0"],
                         ids=["plain", "embed"])
def test_callers_later_edit_does_not_reach_the_fit(encoder):
    """The fit keeps its own copy of a device tensor: an in-place edit by
    the caller after ``fit`` changes neither ``_X`` nor ``assess()``."""
    X = _two_blobs()
    fv = FastVAT(device=CPU).fit(X, encoder=encoder)
    kept, before = fv._X.clone(), fv.assess()
    X.mul_(0.0)
    assert torch.equal(fv._X, kept)
    after = fv.assess()
    assert (after.hopkins, after.block_score, after.k_est) == (
        before.hopkins, before.block_score, before.k_est)
