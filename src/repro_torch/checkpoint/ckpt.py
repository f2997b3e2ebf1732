"""Fault-tolerant checkpointing: atomic, step-tagged, device-elastic.

As ``repro/checkpoint/ckpt.py``, on trees of tensors:

* Atomic: write to ``<dir>/tmp.<step>`` then ``os.replace`` to
  ``step_<n>`` — a crash mid-write never corrupts the latest checkpoint.
* Step-tagged with retention of the last `keep` checkpoints.
* Device-elastic: tensors are saved as host arrays, so a restart may load
  them onto another device (``restore`` casts and moves each leaf to its
  template's dtype and device).
* Self-describing and shared with the reference: the tree is stored as a
  flattened path->array npz under the reference's key names, plus a small
  JSON manifest.  A ``NamedTuple`` field is ``.name`` (JAX's
  ``GetAttrKey``), a dict key its name (in sorted order), a tuple or list
  index its number, and ``None`` holds no leaf: ``.params/embed``,
  ``.opt/.step``, ``.opt/.v/layers/w_up/0``.  So a checkpoint written by
  either package restores in the other — weights and optimizer state.
* bf16 leaves are saved as f32 (npz has no bf16; the upcast is lossless)
  and cast back to the template's dtype on restore.

The sidecar sites ``ckpt.aux_write`` and ``ckpt.aux_read`` of
``repro_torch.faults`` are live here.
"""
from __future__ import annotations

import json
import os
import shutil
import warnings
from typing import Any

import numpy as np
import torch

from repro_torch import faults


class CorruptSidecar(RuntimeError):
    """An aux sidecar exists but cannot be read (truncated/corrupt zip).

    ``load_aux`` raises this only under ``strict=True``; the default
    policy is recover-and-warn (return None), because a torn sidecar
    must never abort a training resume — the weights checkpoint itself
    is still valid (docs/robustness.md).
    """


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walk(tree: Any, prefix: tuple = ()):
    """(path, leaf) pairs in JAX's flattening order."""
    if tree is None:
        return
    if _is_namedtuple(tree):
        for name, v in zip(tree._fields, tree):
            yield from _walk(v, prefix + (f".{name}",))
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], prefix + (str(k),))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from _walk(v, prefix + (str(i),))
    else:
        yield "/".join(prefix), tree


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:   # npz can't store bf16;
            t = t.float()               # f32 upcast is lossless
        return t.cpu().numpy()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return arr


def _flatten(tree: Any) -> dict[str, np.ndarray]:
    return {path: _host(leaf) for path, leaf in _walk(tree)}


def _rebuild(template: Any, load, prefix: tuple = ()):
    """The template's structure with each leaf from ``load(path, leaf)``."""
    if template is None:
        return None
    if _is_namedtuple(template):
        return type(template)(*(
            _rebuild(v, load, prefix + (f".{name}",))
            for name, v in zip(template._fields, template)))
    if isinstance(template, dict):
        return {k: _rebuild(v, load, prefix + (str(k),))
                for k, v in template.items()}
    if isinstance(template, (tuple, list)):
        return type(template)(_rebuild(v, load, prefix + (str(i),))
                              for i, v in enumerate(template))
    return load("/".join(prefix), template)


def save(ckpt_dir: str, step: int, tree: Any, *, extra: dict | None = None,
         aux_arrays: dict[str, dict[str, np.ndarray]] | None = None,
         keep: int = 3) -> str:
    """Atomically publish one checkpoint step.

    `aux_arrays` maps sidecar names to flat array dicts (e.g. the
    monitor's `{"tendency_history": {...}}`); each is written as
    ``<name>.npz`` inside the step directory *before* the atomic
    publish, so weights and sidecars commit — and are garbage-collected
    — together.
    """
    os.makedirs(ckpt_dir, exist_ok=True)
    tmp = os.path.join(ckpt_dir, f"tmp.{step}")
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **_flatten(tree))
    for name, arrays in (aux_arrays or {}).items():
        aux_path = os.path.join(tmp, f"{name}.npz")
        np.savez(aux_path, **arrays)
        # fault-injection site: chaos tests corrupt/truncate the sidecar
        # file through the real write path (disarmed: a no-op)
        faults.fault_point("ckpt.aux_write", path=aux_path,
                           context={"name": name, "step": step})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump({"step": step, **(extra or {})}, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)                      # atomic publish
    _gc(ckpt_dir, keep)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_")]
    return max(steps) if steps else None


def restore(ckpt_dir: str, template: Any, step: int | None = None):
    """Load into the structure of `template`: each tensor leaf comes back
    as a tensor of its template's dtype on its template's device (a numpy
    leaf as a numpy array of its dtype).

    Returns (tree, manifest) or (None, None) when no checkpoint exists.
    """
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        return None, None
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)

    with np.load(os.path.join(path, "arrays.npz")) as data:
        def load(p, leaf):
            arr = data[p]
            if tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(f"{p}: ckpt {arr.shape} != {leaf.shape}")
            if isinstance(leaf, torch.Tensor):
                return torch.from_numpy(arr).to(device=leaf.device,
                                                dtype=leaf.dtype)
            return np.asarray(arr, dtype=np.asarray(leaf).dtype)
        tree = _rebuild(template, load)
    return tree, manifest


def load_aux(ckpt_dir: str, name: str, step: int | None = None, *,
             strict: bool = False) -> dict[str, np.ndarray] | None:
    """Load a sidecar ``<name>.npz`` saved via `save(aux_arrays=...)`.

    Returns the arrays dict, or None when the checkpoint (or the
    sidecar) doesn't exist — older checkpoints without the sidecar
    restore cleanly.

    An *unreadable* sidecar (truncated file, torn zip directory, a
    member that fails CRC) is recovered by policy: by default it warns
    and returns None — the caller resumes as if the sidecar were
    missing, because the weights checkpoint is still good.
    ``strict=True`` raises :class:`CorruptSidecar` instead.
    """
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        return None
    path = os.path.join(ckpt_dir, f"step_{step:08d}", f"{name}.npz")
    if not os.path.exists(path):
        return None
    try:
        # fault-injection site: chaos tests model read failures (raise)
        # or corrupt the file in place just before the real read
        faults.fault_point("ckpt.aux_read", path=path,
                           context={"name": name, "step": step})
        with np.load(path, allow_pickle=False) as data:
            out = {}
            for k in data.files:
                out[k] = data[k]      # per-member read may hit a bad CRC
            return out
    except Exception as exc:  # noqa: BLE001 — torn zip/CRC/pickle refuse
        if strict:
            raise CorruptSidecar(
                f"sidecar {path} is unreadable: {exc!r}") from exc
        warnings.warn(f"[ckpt] sidecar {name!r} at step {step} is "
                      f"unreadable ({exc!r}); resuming without it",
                      RuntimeWarning, stacklevel=2)
        return None


def _gc(ckpt_dir: str, keep: int) -> None:
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
                   if d.startswith("step_"))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:08d}"),
                      ignore_errors=True)
