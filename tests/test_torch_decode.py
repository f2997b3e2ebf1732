"""The port's decode path held on the CPU against the JAX package, at
smoke size, for every family.

* ``init_cache``: the reference's tree of shapes and dtypes for all ten
  configs, in both cache dtypes.
* ``prefill`` then ``decode_step`` against the reference's own prefill and
  steps on the reference's weights (``params_from_numpy``): the cases of
  tests/test_prefill.py, each output within 2e-5 of its scale; the caches
  and the returned position too.
* The port's own prefill → decode against its own forward on weights from
  ``init_params``: the cases of tests/test_prefill.py and
  tests/test_models_smoke.py (MLA, GQA, RWKV, Mamba), at the reference's
  tolerances (2e-3; 5e-3 and 1e-2 for hybrid).
* What the port adds: host positions, the KV cache written in place, the
  bfloat16 cache by default, and the refusals.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import model as JM
from repro_torch import configs
from repro_torch.models import model as M

CPU = "cpu"
PROMPT = [3, 5, 7, 11]
CONT = [2, 9]
DTYPES = {"float32": (torch.float32, jnp.float32),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _close(got, want, rel: float = 2e-5):
    want = np.asarray(want, dtype=np.float32)
    scale = float(np.max(np.abs(want))) or 1.0
    got = got.float().numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale)


def _parity_cfg(name):
    """The reference test's config: capacity 16 so the prefill drops
    nothing (decode never drops), no MTP."""
    kw = {}
    if name == "deepseek-v3-671b":
        kw = {"mtp": False, "capacity_factor": 16.0}
    if name == "phi3.5-moe-42b-a6.6b":
        kw = {"capacity_factor": 16.0}
    return kw


def _extra(name, seed=0):
    rng = np.random.default_rng(seed)
    if name == "whisper-large-v3":
        return {"enc_frames": rng.normal(size=(1, 16, 64)).astype(np.float32)}
    if name == "internvl2-1b":
        return {"patches": rng.normal(size=(1, 4, 64)).astype(np.float32)}
    return {}


def _tree(tree):
    """A cache as nested tuples of numpy arrays (NamedTuples included)."""
    if isinstance(tree, dict):
        return {k: _tree(v) for k, v in sorted(tree.items())}
    if isinstance(tree, (tuple, list)):
        return tuple(_tree(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.float().numpy()
    return np.asarray(jnp.asarray(tree, jnp.float32))


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    if isinstance(tree, tuple):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}{i}/"))
        return out
    return {prefix: tree}


# ---------------------------------------------------------- init_cache ----


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("name", sorted(jconfigs.ARCHS))
def test_init_cache_matches_reference(name, dtype):
    tdt, jdt = DTYPES[dtype]
    cfg, tcfg = jconfigs.smoke_config(name), configs.smoke_config(name)
    want = JM.init_cache(cfg, 2, 8, jdt)
    got = M.init_cache(tcfg, 2, 8, tdt, device=CPU)
    assert sorted(got) == sorted(want)
    for key in want:
        assert type(got[key]).__name__ == type(want[key]).__name__
        gl = jax.tree.leaves(want[key])
        tl = list(_flat(_tree_tensors(got[key])).values())
        assert [tuple(a.shape) for a in tl] == [a.shape for a in gl]
        for a, b in zip(tl, gl):
            assert str(a.dtype).split(".")[-1] == str(b.dtype)
            assert a.device.type == CPU and not a.any()


def _tree_tensors(tree):
    if isinstance(tree, (tuple, list)):
        return tuple(_tree_tensors(v) for v in tree)
    return tree


# ------------------------------------------- prefill/decode vs repro ----


@pytest.mark.parametrize("name", ["phi3-mini-3.8b", "deepseek-v3-671b",
                                  "phi3.5-moe-42b-a6.6b", "rwkv6-3b",
                                  "zamba2-2.7b", "whisper-large-v3",
                                  "internvl2-1b"])
def test_prefill_and_decode_match_reference(name):
    kw = _parity_cfg(name)
    cfg = jconfigs.smoke_config(name).replace(**kw)
    tcfg = configs.smoke_config(name).replace(**kw)
    jp = JM.init_params(cfg, jax.random.PRNGKey(0))
    tp = M.params_from_numpy(jax.device_get(jp), device=CPU)
    extra = _extra(name)
    jbatch = {"tokens": jnp.asarray([PROMPT], jnp.int32),
              **{k: jnp.asarray(v) for k, v in extra.items()}}
    batch = {"tokens": np.asarray([PROMPT], np.int32),
             **{k: _t(v) for k, v in extra.items()}}
    wl, wcache, wpos = JM.prefill(jp, cfg, jbatch, max_len=16,
                                  cache_dtype=jnp.float32)
    gl, cache, pos = M.prefill(tp, tcfg, batch, max_len=16,
                               cache_dtype=torch.float32)
    assert isinstance(pos, int) and pos == int(wpos)
    _close(gl, wl)
    want_c, got_c = _flat(_tree(wcache)), _flat(_tree(cache))
    assert sorted(want_c) == sorted(got_c)
    for k in want_c:
        _close(torch.from_numpy(got_c[k]), want_c[k])
    for i, tok in enumerate(CONT):
        wl, wcache = JM.decode_step(jp, cfg, jnp.asarray([[tok]], jnp.int32),
                                    wcache, jnp.int32(pos + i))
        gl, cache = M.decode_step(tp, tcfg, np.asarray([[tok]], np.int32),
                                  cache, pos + i)
        assert gl.shape == (1, 1, cfg.padded_vocab)
        _close(gl, wl)
    for k, v in _flat(_tree(wcache)).items():
        _close(torch.from_numpy(_flat(_tree(cache))[k]), v)


# ------------------------------------ prefill/decode vs its own forward ----


@pytest.mark.parametrize("name,atol", [
    ("phi3-mini-3.8b", 5e-3), ("deepseek-v3-671b", 5e-3),
    ("rwkv6-3b", 5e-3), ("zamba2-2.7b", 1e-2),
    ("whisper-large-v3", 5e-3), ("internvl2-1b", 5e-3)])
def test_prefill_parity(name, atol):
    """The counterpart of tests/test_prefill.py on the port alone: prefill
    logits match the full forward on the prompt, and decode continues to
    match from the absolute position prefill returns."""
    tcfg = configs.smoke_config(name).replace(**_parity_cfg(name))
    params = M.init_params(tcfg, torch.Generator().manual_seed(0),
                           device=CPU)
    extra = {k: _t(v) for k, v in _extra(name).items()}
    full, _ = M.forward(params, tcfg, {
        "tokens": np.asarray([PROMPT + CONT], np.int32), **extra})
    lp, cache, pos = M.prefill(params, tcfg, {
        "tokens": np.asarray([PROMPT], np.int32), **extra}, max_len=16,
        cache_dtype=torch.float32)
    np.testing.assert_allclose(lp.numpy(), full[:, :len(PROMPT)].numpy(),
                               atol=atol, rtol=atol)
    assert pos == len(PROMPT) + (tcfg.n_patches if name == "internvl2-1b"
                                 else 0)
    for i, tok in enumerate(CONT):
        lg, cache = M.decode_step(params, tcfg, np.asarray([[tok]]), cache,
                                  pos + i)
        np.testing.assert_allclose(lg[:, 0].numpy(),
                                   full[:, len(PROMPT) + i].numpy(),
                                   atol=atol, rtol=atol)


@pytest.mark.parametrize("name,replace,toks,atol,seed", [
    ("deepseek-v3-671b", {"mtp": False, "n_layers": 1,
                          "capacity_factor": 16.0}, [3, 5, 7, 11], 2e-3, 1),
    ("phi3-mini-3.8b", {"n_layers": 2}, [3, 5, 7, 11, 2], 2e-3, 2),
    ("rwkv6-3b", {"n_layers": 2}, [3, 5, 7, 11], 2e-3, 3),
    ("zamba2-2.7b", {}, [3, 5, 7, 11, 2, 9, 1, 4], 5e-3, 4),
], ids=["mla", "gqa", "rwkv", "mamba"])
def test_decode_matches_prefill_logits(name, replace, toks, atol, seed):
    """The counterparts of tests/test_models_smoke.py's decode cases:
    token-by-token decode from an empty f32 cache against the forward."""
    tcfg = configs.smoke_config(name).replace(**replace)
    params = M.init_params(tcfg, torch.Generator().manual_seed(seed),
                           device=CPU)
    t = np.asarray([toks], np.int32)
    full, _ = M.forward(params, tcfg, {"tokens": t})
    cache = M.init_cache(tcfg, 1, 8, torch.float32, device=CPU)
    outs = []
    for i in range(len(toks)):
        lg, cache = M.decode_step(params, tcfg, t[:, i:i + 1], cache, i)
        outs.append(lg[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               atol=atol, rtol=atol)


# ---------------------------------------------------- the port's own ----


def test_kv_cache_is_written_in_place():
    tcfg = configs.smoke_config("phi3-mini-3.8b")
    params = M.init_params(tcfg, torch.Generator().manual_seed(0),
                           device=CPU)
    cache = M.init_cache(tcfg, 1, 8, torch.float32, device=CPU)
    k0 = cache["kv"].k
    _, out = M.decode_step(params, tcfg, np.asarray([[3]]), cache, 2)
    assert out["kv"].k is k0
    assert not k0[:, :, :2].any() and not k0[:, :, 3:].any()
    assert bool(k0[:, :, 2].abs().gt(0).any())


@pytest.mark.parametrize("name", ["deepseek-v3-671b", "rwkv6-3b",
                                  "zamba2-2.7b", "whisper-large-v3"])
def test_default_cache_is_bfloat16_and_runs(name):
    tcfg = configs.smoke_config(name)
    params = M.init_params(tcfg, torch.Generator().manual_seed(0),
                           device=CPU)
    extra = {k: _t(v) for k, v in _extra(name).items()}
    lp, cache, pos = M.prefill(params, tcfg, {
        "tokens": np.asarray([PROMPT * 2], np.int32), **extra}, max_len=12)
    dtypes = {str(a.dtype) for a in _flat(_tree_tensors(
        tuple(cache.values()))).values()}
    assert "torch.bfloat16" in dtypes
    lg, cache = M.decode_step(params, tcfg, np.asarray([[2]]), cache, pos)
    assert lg.dtype == torch.float32 and bool(torch.isfinite(lg).all())
    assert lp.shape == (1, 8, tcfg.padded_vocab)


def test_mamba_prefill_refuses_a_prompt_off_the_chunk():
    tcfg = configs.smoke_config("zamba2-2.7b")
    params = M.init_params(tcfg, torch.Generator().manual_seed(0),
                           device=CPU)
    with pytest.raises(ValueError, match="not divisible by ssm chunk"):
        M.prefill(params, tcfg, {"tokens": np.ones((1, 12), np.int32)}, 16)


def test_decode_runs_on_the_params_device():
    """Everything follows the params: tensors from init_cache on the CPU,
    tokens as numpy or as a tensor."""
    tcfg = configs.smoke_config("rwkv6-3b")
    params = M.init_params(tcfg, torch.Generator().manual_seed(0),
                           device=CPU)
    cache = M.init_cache(tcfg, 2, 4, device=CPU)
    a, _ = M.decode_step(params, tcfg, np.asarray([[1], [2]]), cache, 0)
    b, _ = M.decode_step(params, tcfg, torch.tensor([[1], [2]]), cache, 0)
    assert torch.equal(a, b) and a.device.type == CPU
