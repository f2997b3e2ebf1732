"""The port's moe (MLA, MTP), ssm, hybrid and audio families held on the
CPU against the JAX package, at smoke size.

* The blocks on the same seeded inputs, within 2e-5 of each output's
  scale (f32 products summed in another order than XLA's): ``attention``
  with ``q_offset``, ``gqa_block`` writing a cache, ``cross_block``,
  ``mla_block`` in its expanded and absorbed forms, ``moe_ffn`` (output,
  aux, logits, the same expert ids and so the same drops; group-limited
  routing with ties among zeroed experts; shared experts), the reference's
  capacity-conservation case; the dispatch's positions and the aux
  loss's token fractions (O(K*T)) against the one-hot formulas, bit for
  bit; ``rwkv_block`` (full, with its final state,
  stepped) and ``mamba_block`` (chunked with its final state, stepped).
* ``init_params``: the reference's leaf names and shapes for all ten
  configs, and the draws of the new families' special leaves.
* ``forward`` for the five new smoke configs through ``params_from_numpy``:
  logits, ``return_hidden``, aux (MTP with labels) and taps with
  ``router_logits``, at rtol = atol = 2e-5.
* The audio batch of ``make_batch`` against the reference's, and
  ``router_tendency`` on the same router logits.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.configs import base as jbase
from repro.core.svat import maximin_sample as jmaximin
from repro.data import tokens as jtokens
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mamba2 as jmamba
from repro.models import model as JM
from repro.models import moe as jmoe
from repro.models import rwkv6 as jrwkv
from repro.monitor import probes as jprobes
from repro_torch import configs
from repro_torch.configs import base
from repro_torch.data import tokens
from repro_torch.models import attention, common, mamba2, moe, rwkv6
from repro_torch.models import model as M
from repro_torch.monitor import router_tendency
from repro_torch.monitor.probes import _trace_parts_from

CPU = "cpu"
NEW = ("phi3.5-moe-42b-a6.6b", "deepseek-v3-671b", "rwkv6-3b",
       "zamba2-2.7b", "whisper-large-v3")
F32_ULP = 2.0 ** -23


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got: torch.Tensor, want, rel: float = 2e-5):
    want = np.asarray(want)
    scale = float(np.max(np.abs(want))) or 1.0
    assert got.shape == want.shape
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0,
                               atol=rel * scale)


def _params(name: str, *, seed: int = 0, **replace):
    """The reference's smoke-size weights, and the port's copy of them."""
    cfg = jconfigs.smoke_config(name).replace(**replace)
    jp = JM.init_params(cfg, jax.random.PRNGKey(seed))
    tcfg = configs.smoke_config(name).replace(**replace)
    return cfg, jp, tcfg, M.params_from_numpy(jax.device_get(jp), device=CPU)


def _layer(tree, i=0):
    return {k: v[i] for k, v in tree.items()}


def _rope(cfg, tcfg, start, n):
    dim = cfg.qk_rope_dim if cfg.use_mla else cfg.head_dim
    jc = jcommon.rope_freqs(jnp.arange(start, start + n), dim,
                            cfg.rope_theta)
    tc = common.rope_freqs(torch.arange(start, start + n), dim,
                           tcfg.rope_theta)
    return jc, tc


def _h(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------- attention ----


@pytest.mark.parametrize("chunk", [0, 4])
@pytest.mark.parametrize("offset", [0, 5])
@pytest.mark.parametrize("heads", [(4, 4), (4, 2)], ids=["mha", "gqa"])
def test_attention_q_offset_matches_reference(chunk, offset, heads):
    """Queries at absolute positions offset.. against a longer key axis
    (a cache): both branches mask by the absolute position."""
    H, Hkv = heads
    B, S, K, hd = 2, 8, 16, 16
    rng = np.random.default_rng(offset + chunk)
    q = rng.normal(size=(B, S, H, hd)).astype(np.float32)
    k = rng.normal(size=(B, K, Hkv, hd)).astype(np.float32)
    v = rng.normal(size=(B, K, Hkv, hd)).astype(np.float32)
    got = attention.attention(_t(q), _t(k), _t(v), causal=True, chunk=chunk,
                              q_offset=offset)
    want = jattn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=True, chunk=chunk, q_offset=offset)
    _close(got, want, 2e-6)


@pytest.mark.parametrize("pos,S", [(0, 4), (5, 1)], ids=["prefill", "step"])
def test_gqa_block_with_cache_matches_reference(pos, S):
    cfg, jp, tcfg, tp = _params("phi3-mini-3.8b")
    lp, jlp = _layer(tp["layers"]), _layer(jp["layers"])
    h = _h((2, S, cfg.d_model))
    (jcos, jsin), (tcos, tsin) = _rope(cfg, tcfg, pos, S)
    shape = (2, 12, cfg.eff_kv_heads, cfg.head_dim)
    prior = _h(shape, seed=2)
    jcache = jattn.KVCache(jnp.asarray(prior), jnp.asarray(prior * 2))
    cache = attention.KVCache(_t(prior), _t(prior * 2))
    want, wcache = jattn.gqa_block(jlp, jnp.asarray(h), cfg, jcos, jsin,
                                   cache=jcache, pos=pos)
    got, gcache = attention.gqa_block(lp, _t(h), tcfg, tcos, tsin,
                                      cache=cache, pos=pos)
    _close(got, want)
    # written in place: the same tensors, rows [pos, pos+S) replaced
    assert gcache.k is cache.k and gcache.v is cache.v
    _close(gcache.k, wcache.k)
    _close(gcache.v, wcache.v)
    np.testing.assert_array_equal(cache.k[:, :pos].numpy(), prior[:, :pos])


def test_cross_block_matches_reference():
    cfg, jp, tcfg, tp = _params("whisper-large-v3")
    jlp = {k[2:]: v[0] for k, v in jp["layers"].items() if k[:2] == "x_"}
    lp = {k[2:]: v[0] for k, v in tp["layers"].items() if k[:2] == "x_"}
    h = _h((2, 8, cfg.d_model))
    ek = _h((2, cfg.enc_seq, cfg.eff_kv_heads, cfg.head_dim), seed=3)
    ev = _h((2, cfg.enc_seq, cfg.eff_kv_heads, cfg.head_dim), seed=4)
    want = jattn.cross_block(jlp, jnp.asarray(h),
                             (jnp.asarray(ek), jnp.asarray(ev)), cfg)
    _close(attention.cross_block(lp, _t(h), (_t(ek), _t(ev)), tcfg), want)


@pytest.mark.parametrize("form", ["expanded", "absorbed"])
def test_mla_block_matches_reference(form):
    cfg, jp, tcfg, tp = _params("deepseek-v3-671b")
    lp, jlp = _layer(tp["layers"]), _layer(jp["layers"])
    pos, S = (0, 8) if form == "expanded" else (3, 2)
    h = _h((2, S, cfg.d_model))
    (jcos, jsin), (tcos, tsin) = _rope(cfg, tcfg, pos, S)
    if form == "expanded":
        want, _ = jattn.mla_block(jlp, jnp.asarray(h), cfg, jcos, jsin)
        got, none = attention.mla_block(lp, _t(h), tcfg, tcos, tsin)
        assert none is None
        _close(got, want)
        return
    c0 = _h((2, 10, cfg.kv_lora_rank), seed=5)
    r0 = _h((2, 10, cfg.qk_rope_dim), seed=6)
    want, wc = jattn.mla_block(jlp, jnp.asarray(h), cfg, jcos, jsin,
                               cache=jattn.MLACache(jnp.asarray(c0),
                                                    jnp.asarray(r0)), pos=pos)
    cache = attention.MLACache(_t(c0), _t(r0))
    got, gc = attention.mla_block(lp, _t(h), tcfg, tcos, tsin, cache=cache,
                                  pos=pos)
    _close(got, want)
    assert gc.c_kv is cache.c_kv
    _close(gc.c_kv, wc.c_kv)
    _close(gc.k_rope, wc.k_rope)


def test_mla_absorbed_decode_agrees_with_expanded_form():
    """Against a cache filled by the same tokens, the absorbed form gives
    the expanded form's outputs (the reference holds it at 2e-3)."""
    cfg, jp, tcfg, tp = _params("deepseek-v3-671b")
    lp = _layer(tp["layers"])
    h = _t(_h((1, 6, cfg.d_model)))
    (_, _), (tcos, tsin) = _rope(cfg, tcfg, 0, 6)
    want, _ = attention.mla_block(lp, h, tcfg, tcos, tsin)
    cache = attention.MLACache(torch.zeros(1, 8, cfg.kv_lora_rank),
                               torch.zeros(1, 8, cfg.qk_rope_dim))
    got, _ = attention.mla_block(lp, h, tcfg, tcos, tsin, cache=cache, pos=0)
    _close(got, want.numpy(), 2e-3)


# ---------------------------------------------------------------- moe ----


def _jax_ids(probs, cfg):
    """The reference's routing (group masking, then top-k) on probs."""
    T, E = probs.shape
    if cfg.route_groups > 1:
        G = cfg.route_groups
        gsz = E // G
        gscore = jnp.sum(jax.lax.top_k(probs.reshape(T, G, gsz),
                                       min(2, gsz))[0], axis=-1)
        _, gidx = jax.lax.top_k(gscore, cfg.route_top_groups)
        gmask = jnp.zeros((T, G), bool).at[jnp.arange(T)[:, None],
                                           gidx].set(True)
        probs = jnp.where(jnp.repeat(gmask, gsz, axis=1), probs, 0.0)
    return np.asarray(jax.lax.top_k(probs, cfg.top_k)[1])


def _drops(ids, cfg):
    """Entries past an expert's capacity, slot-major."""
    T = ids.shape[0]
    cap = max(int(cfg.top_k * T * cfg.capacity_factor / cfg.n_experts), 1)
    counts, drops = np.zeros(cfg.n_experts, int), 0
    for e in ids.T.reshape(-1):
        counts[e] += 1
        drops += counts[e] > cap
    return drops


@pytest.mark.parametrize("name,replace", [
    ("phi3.5-moe-42b-a6.6b", {}),
    ("phi3.5-moe-42b-a6.6b", {"capacity_factor": 0.5}),
    ("deepseek-v3-671b", {}),
    ("deepseek-v3-671b", {"route_groups": 2, "route_top_groups": 1,
                          "top_k": 3}),
], ids=["phi", "phi_drops", "dsv3_shared", "dsv3_groups_ties"])
def test_moe_ffn_matches_reference(name, replace):
    cfg, jp, tcfg, tp = _params(name, **replace)
    lp, jlp = _layer(tp["layers"]), _layer(jp["layers"])
    h = _h((2, 16, cfg.d_model))
    want, waux, wlogits = jmoe.moe_ffn(jlp, jnp.asarray(h), cfg,
                                       return_logits=True)
    got, aux, logits = moe.moe_ffn(lp, _t(h), tcfg, return_logits=True)
    assert logits.dtype == torch.float32 and logits.shape == (32,
                                                              cfg.n_experts)
    _close(logits, wlogits)
    # the same expert ids from the reference's routing of its own logits
    # and the port's of its own: so the same entries drop
    probs = torch.softmax(logits, -1)
    if cfg.route_groups > 1:
        G, gsz = cfg.route_groups, cfg.n_experts // cfg.route_groups
        gscore = moe._top_k(probs.reshape(32, G, gsz), 2)[0].sum(-1)
        keep = torch.zeros(32, G, dtype=torch.bool).scatter_(
            1, moe._top_k(gscore, cfg.route_top_groups)[1], True)
        probs = torch.where(keep.repeat_interleave(gsz, 1), probs, 0.0)
        assert int((probs == 0).sum(-1).min()) > 0   # ties among zeros
    ids = moe._top_k(probs, cfg.top_k)[1].numpy()
    want_ids = _jax_ids(jax.nn.softmax(wlogits, axis=-1), cfg)
    np.testing.assert_array_equal(ids, want_ids)
    assert _drops(ids, cfg) == _drops(want_ids, cfg)
    if "capacity_factor" in replace:
        assert _drops(ids, cfg) > 0
    _close(got, want)
    assert abs(float(aux) - float(waux)) <= 2e-5 * abs(float(waux))
    again, _ = moe.moe_ffn(lp, _t(h), tcfg)
    assert torch.equal(again, got)


def _routed_ids(seed: int, T: int, E: int, K: int, groups: int):
    """(T, K) expert ids from seeded router probabilities, routed as
    ``moe_ffn`` routes them (group-limited when ``groups``)."""
    rng = np.random.default_rng(seed)
    probs = torch.softmax(torch.from_numpy(
        rng.standard_normal((T, E)).astype(np.float32) * 2), -1)
    if groups:
        gsz = E // groups
        gscore = moe._top_k(probs.reshape(T, groups, gsz), 2)[0].sum(-1)
        keep = torch.zeros(T, groups, dtype=torch.bool).scatter_(
            1, moe._top_k(gscore, groups // 2)[1], True)
        probs = torch.where(keep.repeat_interleave(gsz, 1), probs, 0.0)
    return moe._top_k(probs, K)[1]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("T,E,K,groups", [
    (37, 4, 2, 0), (512, 16, 2, 0), (1000, 16, 4, 4), (4096, 256, 8, 8)])
def test_moe_positions_equal_the_one_hot_formulas(seed, T, E, K, groups):
    """``moe._positions`` and ``moe._token_fractions`` (O(K*T) memory)
    against the one-hot formulas they replace, bit for bit: each entry's
    position among its expert's entries, ``keep`` at capacities that drop
    entries and at ones that do not, and the aux loss's token fractions,
    over seeds, widths and group-limited routing."""
    import torch.nn.functional as F
    ids = _routed_ids(seed, T, E, K, groups)
    ids_f = ids.T.reshape(-1)
    oh = F.one_hot(ids_f, E)
    want = (oh.cumsum(0) * oh).sum(1) - 1
    pos = moe._positions(ids_f, E)
    assert pos.dtype == want.dtype and torch.equal(pos, want)
    drops = 0
    for factor in (0.25, 0.5, 1.25, 8.0):
        cap = max(int(K * T * factor / E), 1)
        assert torch.equal(pos < cap, want < cap)
        drops += int((want >= cap).sum())
    assert drops > 0
    frac = moe._token_fractions(ids[:, 0], E)
    want_frac = F.one_hot(ids[:, 0], E).float().mean(0)
    assert frac.dtype == torch.float32
    assert torch.equal(frac.view(torch.int32), want_frac.view(torch.int32))


def test_top_k_breaks_ties_to_the_lower_index():
    x = torch.tensor([[0.0, 3.0, 3.0, 0.0, 1.0, 3.0]])
    vals, idx = moe._top_k(x, 5)
    jv, ji = jax.lax.top_k(jnp.asarray(x.numpy()), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


def test_moe_capacity_conservation():
    """The counterpart of tests/test_models_smoke.py::
    test_moe_capacity_conservation: zero experts give zero output and a
    finite, positive aux loss."""
    cfg = configs.smoke_config("phi3.5-moe-42b-a6.6b").replace(
        n_experts=4, top_k=2, d_ff_expert=64, capacity_factor=8.0)
    gen = torch.Generator().manual_seed(0)
    D = cfg.d_model
    p = {"router": torch.randn(D, 4, generator=gen) * 0.1,
         "e_gate": torch.zeros(4, D, 64), "e_up": torch.zeros(4, D, 64),
         "e_down": torch.zeros(4, 64, D)}
    h = torch.randn(2, 8, D, generator=gen)
    out, aux = moe.moe_ffn(p, h, cfg)
    assert float(out.abs().max()) == 0.0
    assert np.isfinite(float(aux)) and float(aux) > 0


def test_moe_identity_experts_return_the_kept_tokens():
    """Every kept entry lands in exactly one buffer slot: with identity
    experts (relu2, up = I, down = I) and renormalized weights, a token
    none of whose entries dropped comes back as relu(x)^2."""
    cfg = configs.smoke_config("phi3.5-moe-42b-a6.6b").replace(
        act="relu2", capacity_factor=8.0)
    D, E = cfg.d_model, cfg.n_experts
    eye = torch.eye(D).expand(E, D, D).clone()
    gen = torch.Generator().manual_seed(1)
    p = {"router": torch.randn(D, E, generator=gen), "e_up": eye,
         "e_down": eye}
    h = torch.randn(2, 8, D, generator=gen)
    out, _ = moe.moe_ffn(p, h, cfg)
    torch.testing.assert_close(out, torch.relu(h) ** 2, rtol=1e-5,
                               atol=1e-5)


# --------------------------------------------------------------- rwkv ----


def test_rwkv_block_matches_reference():
    cfg, jp, tcfg, tp = _params("rwkv6-3b")
    lp, jlp = _layer(tp["layers"]), _layer(jp["layers"])
    h = _h((2, 12, cfg.d_model))
    want, wst = jrwkv.rwkv_block(jlp, jnp.asarray(h), cfg, return_state=True)
    got, st = rwkv6.rwkv_block(lp, _t(h), tcfg, return_state=True)
    _close(got, want)
    for a, b in zip(st, wst):
        _close(a, b)
    assert rwkv6.rwkv_block(lp, _t(h), tcfg)[1] is None
    # one step from that state
    x1 = _h((2, 1, cfg.d_model), seed=7)
    want1, wst1 = jrwkv.rwkv_block(jlp, jnp.asarray(x1), cfg, state=wst)
    got1, st1 = rwkv6.rwkv_block(lp, _t(x1), tcfg, state=st)
    _close(got1, want1)
    for a, b in zip(st1, wst1):
        _close(a, b)


def test_rwkv_steps_equal_the_full_sequence():
    cfg, _, tcfg, tp = _params("rwkv6-3b")
    lp = _layer(tp["layers"])
    h = _t(_h((2, 6, cfg.d_model)))
    full, fst = rwkv6.rwkv_block(lp, h, tcfg, return_state=True)
    st = rwkv6.init_rwkv_state(tcfg, 2, torch.float32, CPU)
    for t in range(6):
        out, st = rwkv6.rwkv_block(lp, h[:, t:t + 1], tcfg, state=st)
        _close(out, full[:, t:t + 1].numpy())
    for a, b in zip(st, fst):
        _close(a, b.numpy())


# -------------------------------------------------------------- mamba ----


@pytest.mark.parametrize("S", [16, 5], ids=["two_chunks", "short"])
def test_mamba_block_matches_reference(S):
    cfg, jp, tcfg, tp = _params("zamba2-2.7b")
    lp = {k: v[1, 0] for k, v in tp["layers"].items()}
    jlp = {k: v[1, 0] for k, v in jp["layers"].items()}
    u = _h((2, S, cfg.d_model))
    want, wst = jmamba.mamba_block(jlp, jnp.asarray(u), cfg,
                                   return_state=True)
    got, st = mamba2.mamba_block(lp, _t(u), tcfg, return_state=True)
    _close(got, want)
    for a, b in zip(st, wst):
        _close(a, b)
    x1 = _h((2, 1, cfg.d_model), seed=8)
    want1, wst1 = jmamba.mamba_block(jlp, jnp.asarray(x1), cfg, state=wst)
    got1, st1 = mamba2.mamba_block(lp, _t(x1), tcfg, state=st)
    _close(got1, want1)
    for a, b in zip(st1, wst1):
        _close(a, b)


def test_mamba_steps_equal_the_chunked_sequence():
    cfg, _, tcfg, tp = _params("zamba2-2.7b")
    lp = {k: v[0, 0] for k, v in tp["layers"].items()}
    u = _t(_h((1, 16, cfg.d_model)))
    full, fst = mamba2.mamba_block(lp, u, tcfg, return_state=True)
    st = mamba2.init_mamba_state(tcfg, 1, torch.float32, CPU)
    for t in range(16):
        out, st = mamba2.mamba_block(lp, u[:, t:t + 1], tcfg, state=st)
        _close(out, full[:, t:t + 1].numpy(), 1e-5)
    _close(st.ssm, fst.ssm.numpy(), 1e-5)
    _close(st.conv, fst.conv.numpy(), 1e-5)


def test_mamba_refuses_a_length_off_the_chunk():
    cfg, _, tcfg, tp = _params("zamba2-2.7b")
    lp = {k: v[0, 0] for k, v in tp["layers"].items()}
    with pytest.raises(ValueError, match="not divisible by ssm chunk 8"):
        mamba2.mamba_block(lp, torch.zeros(1, 12, cfg.d_model), tcfg)


# --------------------------------------------------------------- init ----


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = tuple(v.shape)
    return out


@pytest.mark.parametrize("name", sorted(jconfigs.ARCHS))
def test_init_params_tree_matches_reference_all_configs(name):
    cfg = jconfigs.smoke_config(name)
    tcfg = configs.smoke_config(name)
    want = jax.eval_shape(lambda k: JM.init_params(cfg, k),
                          jax.random.PRNGKey(0))
    got = M.init_params(tcfg, torch.Generator().manual_seed(0), device=CPU)
    assert _shapes(got) == _shapes(want)
    again = M.init_params(tcfg, torch.Generator().manual_seed(0), device=CPU)
    assert all(torch.equal(a, b) for a, b in zip(
        _leaves(got), _leaves(again)))
    # the full config's tree, shapes only
    full = M.init_params(configs.get_config(name), torch.Generator(),
                         device="meta")
    fwant = jax.eval_shape(lambda k: JM.init_params(
        jconfigs.get_config(name), k), jax.random.PRNGKey(0))
    assert _shapes(full) == _shapes(fwant)


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def test_init_params_special_leaves():
    rw = M.init_params(configs.smoke_config("rwkv6-3b"),
                       torch.Generator().manual_seed(0), device=CPU)["layers"]
    for k in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "cm_mu_k", "cm_mu_r"):
        assert bool((rw[k] == 0.5).all())
    assert bool((rw["w0"] == torch.tensor(-4.6)).all())
    mb = M.init_params(configs.smoke_config("zamba2-2.7b"),
                       torch.Generator().manual_seed(0), device=CPU)["layers"]
    a = torch.exp(mb["a_log"])
    assert bool(((a >= 1.0) & (a <= 16.0)).all())
    dt = torch.nn.functional.softplus(mb["dt_bias"])
    assert bool(((dt >= 1e-3 * 0.999) & (dt <= 1e-1 * 1.001)).all())
    assert bool((mb["skip_d"] == 1).all()) and not mb["norm"].any()
    assert abs(float(mb["conv"].std()) - 0.1) < 0.02
    ds = M.init_params(configs.smoke_config("deepseek-v3-671b"),
                       torch.Generator().manual_seed(0), device=CPU)
    assert ds["mtp_block"]["mtp_proj"].shape == (128, 64)
    assert not ds["layers"]["q_norm"].any()


# ------------------------------------------------------------ forward ----


def _batch(cfg, kind="prefill", seq=16, B=2):
    want = jtokens.make_batch(cfg, jbase.ShapeConfig("f", seq, B, kind),
                              dtype=jnp.float32)
    got = {k: (_t(v) if k in ("patches", "enc_frames") else np.asarray(v))
           for k, v in want.items()}
    return got, want


@pytest.mark.parametrize("name", NEW)
def test_forward_matches_reference(name):
    cfg, jp, tcfg, tp = _params(name)
    kind = "train" if name == "deepseek-v3-671b" else "prefill"
    got, want = _batch(cfg, kind)
    logits, aux, taps = M.forward(tp, tcfg, got, taps=True)
    jlogits, jaux, jtaps = JM.forward(jp, cfg, want, taps=True)
    hidden, _ = M.forward(tp, tcfg, got, return_hidden=True)
    jhidden, _ = JM.forward(jp, cfg, want, return_hidden=True)
    assert logits.dtype == torch.float32
    assert logits.shape == jlogits.shape == (2, 16, cfg.padded_vocab)
    assert sorted(taps) == sorted(jtaps)
    for a, b in ((logits, jlogits), (hidden, jhidden),
                 (taps["layer_out"], jtaps["layer_out"])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-5)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=2e-5, atol=0)
    if cfg.family == "moe":
        assert taps["router_logits"].shape == (cfg.n_layers, 32,
                                               cfg.n_experts)
        np.testing.assert_allclose(taps["router_logits"].numpy(),
                                   np.asarray(jtaps["router_logits"]),
                                   rtol=2e-5, atol=2e-5)
        assert float(aux) > 0
    if cfg.family == "hybrid":
        assert taps["layer_out"].shape[0] == cfg.n_layers // cfg.attn_every
    tail = taps["layer_out"][-1]
    np.testing.assert_array_equal(tail.numpy(), hidden.numpy())


def test_mtp_runs_only_with_labels():
    cfg, jp, tcfg, tp = _params("deepseek-v3-671b")
    got, want = _batch(cfg, "train")
    _, aux = M.forward(tp, tcfg, got)
    _, aux0 = M.forward(tp, tcfg, {"tokens": got["tokens"]})
    _, jaux0 = JM.forward(jp, cfg, {"tokens": want["tokens"]})
    np.testing.assert_allclose(float(aux0), float(jaux0), rtol=2e-5)
    assert float(aux) > float(aux0)
    # the MTP term alone: 0.3 * CE / count of its shifted labels
    _, jaux = JM.forward(jp, cfg, want)
    np.testing.assert_allclose(float(aux) - float(aux0),
                               float(jaux) - float(jaux0), rtol=1e-4)


@pytest.mark.parametrize("chunk", [0, 4])
def test_ce_from_hidden_matches_reference(chunk):
    cfg, jp, tcfg, tp = _params("phi3.5-moe-42b-a6.6b")
    h = _h((2, 16, cfg.d_model))
    labels = np.random.default_rng(0).integers(-1, cfg.vocab, size=(2, 16))
    want = JM.ce_from_hidden(jp, cfg, jnp.asarray(h), jnp.asarray(labels),
                             chunk=chunk)
    got = M.ce_from_hidden(tp, tcfg, _t(h), _t(labels), chunk=chunk)
    for a, b in zip(got, want):
        np.testing.assert_allclose(float(a), float(b), rtol=2e-6)


# ------------------------------------------------- batches and probes ----


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_audio_batch_matches_reference(kind):
    shape = base.ShapeConfig("a", 24, 2, kind)
    jshape = jbase.ShapeConfig("a", 24, 2, kind)
    for cfg, jcfg in ((configs.smoke_config("whisper-large-v3"),
                       jconfigs.smoke_config("whisper-large-v3")),
                      (configs.get_config("whisper-large-v3"),
                       jconfigs.get_config("whisper-large-v3"))):
        got = tokens.make_batch(cfg, shape, 3, device=CPU)
        want = jtokens.make_batch(jcfg, jshape, 3)
        assert sorted(got) == sorted(want)
        for key in ("tokens", "labels"):
            if key in want:
                np.testing.assert_array_equal(got[key], want[key])
        f = got["enc_frames"]
        assert f.dtype == torch.bfloat16 and f.shape == (2, cfg.enc_seq,
                                                         cfg.d_model)
        np.testing.assert_array_equal(
            f.view(torch.int16).numpy(),
            np.asarray(want["enc_frames"]).view(np.int16))


def test_router_tendency_matches_reference_on_the_same_logits():
    """The reference's router logits of a smoke forward, fed to both
    packages with the reference's draws: the same maximin sample, k_est
    and block score, rstar within an ulp."""
    cfg, jp, tcfg, tp = _params("phi3.5-moe-42b-a6.6b")
    _, want_b = _batch(cfg, seq=64)
    _, _, jtaps = JM.forward(jp, cfg, want_b, taps=True)
    logits = np.asarray(jtaps["router_logits"][-1])        # (128, E)
    key = jax.random.PRNGKey(5)
    want = jprobes.router_tendency(jnp.asarray(logits), key, sample=32)
    k_s, _, _ = jax.random.split(key, 3)
    i0 = int(np.asarray(jmaximin(jnp.asarray(logits), 32, k_s))[0])
    _, score, k_est, rstar, _ = _trace_parts_from(
        _t(logits), i0, None, torch.Generator().manual_seed(0), sample=32,
        thumbnail=0)
    np.testing.assert_allclose(rstar.numpy(), np.asarray(want.rstar),
                               rtol=4 * F32_ULP, atol=1e-7)
    assert int(k_est) == int(want.k_est)
    assert abs(float(score) - float(want.block_score)) <= 1e-6
    # the port's own router logits agree with the reference's, and its
    # router_tendency reads them through the same report
    got_b, _ = _batch(cfg, seq=64)
    _, _, taps = M.forward(tp, tcfg, got_b, taps=True)
    np.testing.assert_allclose(taps["router_logits"][-1].numpy(), logits,
                               rtol=2e-5, atol=2e-5)
    rep = router_tendency(taps["router_logits"][-1],
                          torch.Generator().manual_seed(0), sample=32)
    assert rep.rstar.shape == (32, 32) and 0 <= float(rep.hopkins) <= 1
