"""Token batches: the synthetic corpus, the batches the model zoo reads,
and their shape stand-ins.

As ``repro/data/tokens.py``: a deterministic Zipf-ish token stream with
local structure (bigram templates mixed with noise), host-side numpy, so
``tokens`` and ``labels`` are the reference's bit for bit.  The extras of
a family (``patches`` for vlm, ``enc_frames`` for audio) are drawn the
reference's way on the host and become tensors of ``dtype`` on ``device``.
``input_specs(cfg, shape)`` is what a (train|prefill|decode) step
consumes, as ``device="meta"`` tensors: the dry run
(``launch/dryrun.py``) traces against these, and ``make_batch`` produces
concrete matches.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig


def _text_len(cfg: ModelConfig, seq_len: int) -> int:
    """Text-token count for a shape (VLM cells reserve patch positions)."""
    if cfg.family == "vlm":
        return seq_len - cfg.n_patches
    return seq_len


def input_specs(cfg: ModelConfig, shape: ShapeConfig, *,
                dtype: torch.dtype = torch.bfloat16) -> dict:
    """Shape stand-ins ("meta" tensors) for every model input of this
    cell: ``tokens`` (and ``labels`` for train) int32, ``patches`` (vlm)
    and ``enc_frames`` (audio) in ``dtype``."""
    B, S = shape.global_batch, shape.seq_len

    def meta(*dims, dt=torch.int32):
        return torch.empty(dims, dtype=dt, device="meta")

    if shape.kind == "decode":
        return {"tokens": meta(B, 1)}
    T = _text_len(cfg, S)
    specs = {"tokens": meta(B, T)}
    if shape.kind == "train":
        specs["labels"] = meta(B, T)
    if cfg.family == "vlm":
        specs["patches"] = meta(B, cfg.n_patches, cfg.d_model, dt=dtype)
    if cfg.family == "audio":
        specs["enc_frames"] = meta(B, cfg.enc_seq, cfg.d_model, dt=dtype)
    return specs


class SyntheticCorpus:
    """Deterministic structured token stream (host-side, numpy).

    Tokens follow mixed bigram templates: each stream picks one of
    `n_templates` cyclic patterns plus Zipf noise, giving a model a
    learnable conditional distribution.
    """

    def __init__(self, vocab: int, seed: int = 0, n_templates: int = 8):
        self.vocab = vocab
        self.rng = np.random.default_rng(seed)
        self.templates = self.rng.integers(
            0, vocab, size=(n_templates, 64), dtype=np.int32)

    def batch(self, batch: int, seq: int, step: int = 0) -> dict:
        # hash of an int tuple is deterministic (no string hash seed)
        rng = np.random.default_rng(hash((step, batch, seq)) % (2**32))
        t_idx = rng.integers(0, len(self.templates), size=batch)
        offs = rng.integers(0, 64, size=batch)
        base = np.stack([
            np.resize(np.roll(self.templates[t], -o), seq + 1)
            for t, o in zip(t_idx, offs)])
        noise = rng.zipf(1.5, size=(batch, seq + 1)) % self.vocab
        mask = rng.random((batch, seq + 1)) < 0.15
        stream = np.where(mask, noise, base).astype(np.int32)
        return {"tokens": stream[:, :-1], "labels": stream[:, 1:]}


def make_batch(cfg: ModelConfig, shape: ShapeConfig, step: int = 0,
               corpus: SyntheticCorpus | None = None,
               dtype: torch.dtype = torch.bfloat16, device="cuda") -> dict:
    """A batch of ``shape`` for ``cfg``: numpy int32 ``tokens`` (and
    ``labels`` for a train shape), plus ``patches`` (vlm) or
    ``enc_frames`` (audio) as ``dtype`` tensors on ``device``, drawn from
    ``default_rng(step + 7)`` in float64 and rounded to float32, then to
    ``dtype``."""
    corpus = corpus or SyntheticCorpus(cfg.vocab)
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        b = corpus.batch(B, 1, step)
        return {"tokens": b["tokens"]}
    T = _text_len(cfg, S)
    out = dict(corpus.batch(B, T, step))
    if shape.kind != "train":
        out.pop("labels")
    rng = np.random.default_rng(step + 7)

    def extra(rows: int) -> torch.Tensor:
        draw = rng.normal(size=(B, rows, cfg.d_model)).astype(np.float32)
        return torch.from_numpy(draw).to(device=device, dtype=dtype)

    if cfg.family == "vlm":
        out["patches"] = extra(cfg.n_patches)
    if cfg.family == "audio":
        out["enc_frames"] = extra(cfg.enc_seq)
    return out
