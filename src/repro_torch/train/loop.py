"""Fault-tolerant training loop, as ``repro/train/loop.py``.

* **checkpoint/restart** — atomic step-tagged checkpoints every
  `ckpt_every` steps and at the last; on start the loop restores the
  latest checkpoint and *deterministically skips* the data stream to the
  restored step, so an interrupted run and an uninterrupted run end with
  the same params bit for bit.
* **straggler mitigation** — host-side data dispatch has a per-step
  deadline; a late batch is skipped and logged rather than stalling the
  step.
* **device-elastic** — checkpoints hold host arrays, so a restart may come
  up on another device.
* **tendency monitor** — every `diag_every` steps `TendencyMonitor`
  runs its probe program (embedding table, final-layer activations, MoE
  router logits, the embedding's gradient) as one program, appends to a
  `TendencyHistory` serialized atomically alongside the checkpoint, and
  reports per-probe OK/WARN/COLLAPSE drift states in the log line.

The step updates the state in place (``build_train_step(donate=True)``);
each step's batch comes from ``make_batch`` and is moved to ``device``
once.
"""
from __future__ import annotations

import time
from typing import Callable

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.data.tokens import SyntheticCorpus, make_batch
from repro_torch.monitor import STATE_CODES, TendencyMonitor
from repro_torch.train import steps as S


def train(cfg: ModelConfig, tc: TrainConfig, shape: ShapeConfig,
          *, steps: int | None = None, log: Callable[[str], None] = print,
          step_deadline_s: float = 0.0, param_dtype=torch.float32,
          interrupt_at: int | None = None,
          monitor: TendencyMonitor | None = None, device="cuda"):
    """Run (or resume) training on ``device``; returns (state, history list
    of metric dicts).

    interrupt_at: test hook — raise KeyboardInterrupt after that step to
    simulate a node failure between checkpoint and completion.
    monitor: optional pre-built TendencyMonitor (custom probes/thresholds);
    defaults to `TendencyMonitor(cfg, seed=tc.seed, device=device)`.
    """
    steps = steps or tc.total_steps
    train_step = S.build_train_step(cfg, tc, donate=True)
    corpus = SyntheticCorpus(cfg.vocab, seed=tc.seed)
    mon = monitor if monitor is not None else TendencyMonitor(
        cfg, seed=tc.seed, device=device)

    gen = torch.Generator(device=device).manual_seed(tc.seed)
    state = S.init_state(cfg, tc, gen, param_dtype, device=device)
    start = 0
    restored, manifest = ckpt.restore(tc.ckpt_dir, state)
    if restored is not None:
        state, start = restored, manifest["step"]
        mon.restore(tc.ckpt_dir, start)
        log(f"[resume] restored step {start} from {tc.ckpt_dir} "
            f"({len(mon.history)} tendency rows)")

    history = []
    skipped = 0
    for step in range(start, steps):
        t0 = time.monotonic()
        batch = make_batch(cfg, shape, step=step, corpus=corpus,
                           device=device)
        if step_deadline_s and (time.monotonic() - t0) > step_deadline_s:
            skipped += 1           # straggler: drop the batch, keep cadence
            log(f"[straggler] step {step}: data late, skipped "
                f"({skipped} total)")
            continue
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in batch.items()}
        state, metrics = train_step(state, batch)

        if (step + 1) % tc.diag_every == 0:
            summ = mon.observe(step + 1, state.params, batch)
            emb = summ[mon.specs[0].name]
            metrics = dict(metrics, vat_block_score=emb["block_score"],
                           vat_k_est=emb["k_est"], hopkins=emb["hopkins"])
            for name, s in summ.items():
                metrics[f"tendency/{name}/block_score"] = s["block_score"]
                metrics[f"tendency/{name}/k_est"] = s["k_est"]
                metrics[f"tendency/{name}/hopkins"] = s["hopkins"]
                metrics[f"tendency/{name}/state"] = STATE_CODES[s["state"]]
            log(f"[tendency] step {step + 1}: {mon.status_line(summ)}")
        history.append({k: float(v) for k, v in metrics.items()})
        if (step + 1) % tc.ckpt_every == 0 or step == steps - 1:
            path = ckpt.save(tc.ckpt_dir, step + 1, state,
                             aux_arrays=mon.save_arrays())
            log(f"[ckpt] step {step + 1} -> {path}")
        if step % 10 == 0:
            log(f"step {step}: loss={history[-1]['loss']:.4f}")
        if interrupt_at is not None and step + 1 >= interrupt_at:
            raise KeyboardInterrupt(f"simulated failure at step {step + 1}")
    return state, history
