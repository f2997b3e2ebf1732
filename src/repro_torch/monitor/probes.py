"""Declarative tendency probes over a training step, and the DeepVAT
front end.

As ``repro/monitor/probes.py``.  A `ProbeSpec` names one tensor stream
inside the model — the embedding table, a layer's activations (the
``taps=True`` hook of ``models/model.py``'s forward), MoE router logits,
or a gradient leaf — and how to summarize it (maximin sample size,
optional rstar thumbnail).  `_trace_parts` is the shared tendency math:
VAT of a maximin sample of s points (``kernels.ops.pairwise_dist`` and the
Prim kernel ``vat_prim_order`` on the card) and Hopkins on a bounded
uniform subsample, so a report costs O(s²) whatever the height of the
activation matrix.

`run_probes` runs the whole probe tree as one program (`_probe_program`,
built once per (cfg, specs)): the tapped forward with no gradient iff a
layer or router probe is present, the gradient of the training loss iff a
grad probe is present — for the probed leaves only (``torch.autograd.grad``
on them), the reference's ``jax.grad`` values for less work — then
`_trace_parts` for each probe.  The census (`probe_dispatch_stats`) moves
when a program is built, never on a warm call.

The random draws come from ``torch.Generator``s: probe i of a diag step
draws from a generator seeded by (seed, step, i), in place of the
reference's ``fold_in(key, i)``.  JAX's split keys cannot be reproduced in
torch, so ``_trace_parts_from`` takes the draws themselves, and two
packages can be fed the same sample.

``encode_batch``, ``model_fingerprint`` and ``callable_fingerprint`` are
the ``embed`` rung's front end (``FastVAT.fit_embeddings``,
``FastVAT.fit(X, encoder=…)``).
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.hopkins import hopkins
from repro_torch.core.svat import maximin_sample_from
from repro_torch.core.vat import block_structure_score, vat_from_dist
from repro_torch.kernels import ops as kops

# ------------------------------------------------------------ census ----

# Build-time census (house pattern, cf. serve/server.py's): the counters
# move only when a probe program is built — a warm diag step moves
# neither.  "programs" counts built probe programs, "traces" the builds of
# their bodies (one each: the port runs eagerly); the monitor test pins
# one diag step == exactly one program.
_DIAG_CENSUS = {"programs": 0, "traces": 0}


def probe_dispatch_stats() -> dict:
    """Snapshot of the probe-program census: {"programs", "traces"}."""
    return dict(_DIAG_CENSUS)


# ------------------------------------------------------------- specs ----

_KINDS = ("embedding", "layer", "router", "grad")


@dataclasses.dataclass(frozen=True)
class ProbeSpec:
    """One declarative probe: which tensor stream, how to summarize it.

    kind:
      "embedding" — the (V, D) token embedding table.
      "layer"     — per-layer activations from the tapped forward pass;
                    `layer` indexes the stacked (L, B, S, D) tap (-1 =
                    final layer).
      "router"    — MoE router logits (L, T, E) from the tapped forward
                    pass; `layer` indexes as above.  MoE configs only.
      "grad"      — a gradient leaf of the training loss; `target` is a
                    "/"-joined path into the params tree (e.g. "embed",
                    "layers/w_up").

    sample:    maximin sample size s; the probe costs O(s²).
    thumbnail: side of the optional downsampled rstar image carried in
               the trace (0 = no thumbnail; scalars only).
    """
    name: str
    kind: str
    layer: int = -1
    target: str = "embed"
    sample: int = 128
    thumbnail: int = 0

    def __post_init__(self):
        if self.kind not in _KINDS:
            raise ValueError(f"unknown probe kind {self.kind!r}; "
                             f"expected one of {_KINDS}")


@dataclasses.dataclass(frozen=True)
class TendencyTrace:
    """Per-probe tendency summary: 0-d tensors (and an optional (t, t)
    thumbnail) on the probed tensor's device, with the spec that made
    them."""
    hopkins: torch.Tensor       # 0-d f32 in [0, 1]
    block_score: torch.Tensor   # 0-d f32 in [0, 1]
    k_est: torch.Tensor         # 0-d, estimated number of diagonal blocks
    thumbnail: torch.Tensor | None  # (t, t) f32 downsampled rstar, or None
    spec: ProbeSpec


def default_probes(cfg, *, sample: int = 128,
                   thumbnail: int = 0) -> tuple[ProbeSpec, ...]:
    """Default probe tree for a model config.

    Embedding table + final-layer activations + embedding gradient, plus
    router logits for MoE families.  The embedding probe comes first.
    """
    specs = [
        ProbeSpec("embed_table", "embedding", sample=sample,
                  thumbnail=thumbnail),
        ProbeSpec("acts_final", "layer", layer=-1, sample=sample,
                  thumbnail=thumbnail),
    ]
    if cfg.family == "moe":
        specs.append(ProbeSpec("router", "router", layer=-1, sample=sample,
                               thumbnail=thumbnail))
    specs.append(ProbeSpec("grad_embed", "grad", target="embed",
                           sample=sample, thumbnail=thumbnail))
    return tuple(specs)


# ------------------------------------------------------ trace innards ----


def _rows(acts: torch.Tensor) -> torch.Tensor:
    return acts.reshape(-1, acts.shape[-1]).float()


def _trace_parts_from(acts, i0, hrows, generator, *, sample, thumbnail):
    """``_trace_parts`` from given draws: the maximin start ``i0`` and the
    Hopkins subsample's rows ``hrows`` (None: every row); ``generator``
    draws the Hopkins probes."""
    acts = _rows(acts)
    s = min(sample, acts.shape[0])
    idx = maximin_sample_from(acts, s, i0)
    res = vat_from_dist(kops.pairwise_dist(acts.index_select(0, idx)))
    score, k_est = block_structure_score(res.rstar)
    hx = acts if hrows is None else acts.index_select(0, hrows)
    h = hopkins(hx, generator)
    thumb = None
    if thumbnail > 0:
        t = min(thumbnail, s)
        ti = torch.round(torch.linspace(0, s - 1, t,
                                        device=acts.device)).long()
        thumb = res.rstar[ti][:, ti]
    return h, score, k_est, res.rstar, thumb


def _trace_parts(acts, generator, *, sample, thumbnail, hopkins_cap=0):
    """Shared tendency math: (hopkins, block_score, k_est, rstar, thumb).

    VAT runs on a maximin sample of s points; Hopkins runs on a bounded
    *uniform* subsample (maximin would bias it toward 0.5) of at most
    `hopkins_cap` points (default 4*s), so the whole trace stays O(s²)
    regardless of the activation matrix height.  ``generator`` (on acts'
    device) makes the reference's three draws in turn: the maximin start,
    the uniform subsample, the Hopkins probes.
    """
    acts = _rows(acts)
    n = acts.shape[0]
    s = min(sample, n)
    i0 = torch.randint(0, n, (), generator=generator, device=acts.device)
    cap = hopkins_cap if hopkins_cap > 0 else 4 * s
    hrows = None
    if n > cap:
        hrows = torch.randperm(n, generator=generator,
                               device=acts.device)[:cap]
    return _trace_parts_from(acts, i0, hrows, generator, sample=sample,
                             thumbnail=thumbnail)


class TendencyReport(NamedTuple):
    hopkins: torch.Tensor        # 0-d in [0, 1]
    block_score: torch.Tensor    # diagonal-contrast score in [0, 1]
    k_est: torch.Tensor          # estimated number of diagonal blocks
    rstar: torch.Tensor          # (s, s) VAT image of the sample


def activation_report(acts: torch.Tensor, generator: torch.Generator, *,
                      sample: int = 128,
                      hopkins_cap: int = 0) -> TendencyReport:
    """Cluster-tendency report for a (n, d) activation matrix (any
    leading shape; flattened to rows), on its device.

    Subsamples to `sample` points by maximin so the VAT cost is O(s^2),
    and bounds the Hopkins input to `hopkins_cap` (default 4*sample)
    uniformly-sampled rows — the whole report is O(s²), independent of
    batch size.  ``generator`` lives on acts' device.
    """
    h, score, k_est, rstar, _ = _trace_parts(
        acts, generator, sample=sample, thumbnail=0,
        hopkins_cap=hopkins_cap)
    return TendencyReport(hopkins=h, block_score=score, k_est=k_est,
                          rstar=rstar)


def embedding_tendency(embed_table: torch.Tensor,
                       generator: torch.Generator,
                       sample: int = 128) -> TendencyReport:
    """Tendency of a (vocab, d) embedding table (collapse detector)."""
    return activation_report(embed_table, generator, sample=sample)


def router_tendency(router_logits: torch.Tensor,
                    generator: torch.Generator,
                    sample: int = 128) -> TendencyReport:
    """Tendency of (tokens, n_experts) router logits (specialization
    check).

    k_est ~ 1 => router collapse; k_est >~ top_k => healthy specialization.
    """
    return activation_report(router_logits, generator, sample=sample)


# ----------------------------------------------------- probe program ----


def _leaf(tree, path: str):
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node


def _select(spec: ProbeSpec, params, taps, grads):
    if spec.kind == "embedding":
        return params["embed"]
    if spec.kind == "layer":
        return taps["layer_out"][spec.layer]
    if spec.kind == "router":
        if "router_logits" not in taps:
            raise ValueError(f"probe {spec.name!r}: router probes need a "
                             "moe-family config")
        return taps["router_logits"][spec.layer]
    if spec.kind == "grad":
        return _leaf(grads, spec.target)
    raise ValueError(spec.kind)


def probe_seed(seed: int, step: int, index: int) -> int:
    """The seed of probe ``index``'s generator at a diag ``step``: a
    SeedSequence of (seed, step, index), so every probe of every step
    draws its own stream."""
    state = np.random.SeedSequence([int(seed), int(step), int(index)])
    return int(state.generate_state(1, np.uint64)[0])


def probe_taps(cfg, params, batch) -> dict:
    """The tapped forward's taps, with no gradient."""
    from repro_torch.models import model as M
    with torch.no_grad():
        return M.forward(params, cfg, batch, taps=True)[2]


def probe_grads(cfg, params, batch, targets) -> dict:
    """The training loss's gradient for the "/"-joined leaf paths in
    ``targets`` only: a tree of those leaves."""
    from repro_torch.train import steps as S
    if "labels" not in batch:
        raise ValueError("grad probes need a batch with 'labels'")
    return S.value_and_grad(params, cfg, batch, targets=targets)[1]


@functools.lru_cache(maxsize=64)
def _probe_program(cfg, specs: tuple[ProbeSpec, ...]):
    """Build the probe tree's program: ``diag(params, batch, seed, step)
    -> {name: TendencyTrace}``.

    lru-cached on (cfg, specs) so repeated monitors (across train calls,
    tests, benches) reuse the program; the census distinguishes cache hits
    (no movement) from builds.
    """
    need_taps = any(s.kind in ("layer", "router") for s in specs)
    targets = tuple(sorted({s.target for s in specs if s.kind == "grad"}))

    def diag(params, batch, seed: int, step: int):
        taps = probe_taps(cfg, params, batch) if need_taps else {}
        grads = probe_grads(cfg, params, batch, targets) if targets else None
        out = {}
        for i, spec in enumerate(specs):
            arr = _select(spec, params, taps, grads).detach()
            gen = torch.Generator(device=arr.device).manual_seed(
                probe_seed(seed, step, i))
            h, score, k_est, _, thumb = _trace_parts(
                arr, gen, sample=spec.sample, thumbnail=spec.thumbnail)
            out[spec.name] = TendencyTrace(hopkins=h, block_score=score,
                                           k_est=k_est, thumbnail=thumb,
                                           spec=spec)
        return out

    _DIAG_CENSUS["programs"] += 1
    _DIAG_CENSUS["traces"] += 1
    return diag


def run_probes(cfg, specs, params, batch, *, seed: int = 0,
               step: int = 0):
    """Run the probe tree as one program -> {name: TendencyTrace}, its
    tensors on the params' device; deterministic in (seed, step)."""
    return _probe_program(cfg, tuple(specs))(params, batch, seed, step)


# ------------------------------------------- embeddings front-end ----


def encode_batch(params, cfg, batch) -> torch.Tensor:
    """Final hidden states of a forward pass, flattened to (B*S, d_model)
    f32 rows on the params' device.

    The DeepVAT front end: `FastVAT.fit_embeddings` runs the rung ladder
    on these activations instead of raw inputs.  The forward runs under
    ``torch.inference_mode``; the rows come back as an ordinary tensor.
    """
    from repro_torch.models import model as M
    with torch.inference_mode():
        h, _ = M.forward(params, cfg, batch, return_hidden=True)
        rows = h.reshape(-1, h.shape[-1]).float()
    return rows.clone()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def model_fingerprint(cfg, params) -> str:
    """Stable short fingerprint of (config, weights) for ResultMeta — the
    reference's string for the same weights.

    Hashes the architecture identity plus the f32 bytes of the first
    embedding row's first 8 entries, so two checkpoints of the same arch
    fingerprint differently but a re-created identical model fingerprints
    the same.
    """
    n_params = sum(int(np.prod(x.shape)) for x in _leaves(params))
    emb = params["embed"]
    head = emb[0, : min(8, emb.shape[-1])].detach().float().cpu().numpy()
    ident = f"{cfg.name}:{cfg.family}:{cfg.n_layers}:{cfg.d_model}:{n_params}"
    digest = hashlib.sha1(ident.encode() + head.tobytes()).hexdigest()
    return f"{cfg.name}@{digest[:12]}"


def callable_fingerprint(fn) -> str:
    """Best-effort short fingerprint of an arbitrary encoder callable."""
    code = getattr(fn, "__code__", None)
    payload = code.co_code if code is not None else repr(fn).encode()
    name = getattr(fn, "__qualname__", type(fn).__name__)
    return f"{name}@{hashlib.sha1(payload).hexdigest()[:12]}"
