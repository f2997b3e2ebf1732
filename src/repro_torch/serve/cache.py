"""LRU-bounded program cache; the reference's ``repro/serve/cache.py``.

Every distinct fit program the server can dispatch is named by a
:class:`ProgramKey` — the full set of knobs that change what runs.  The
cache maps keys to built programs (``serve.server._build_program``: the
rung's batched fitter bound to the key's meta and options; the kernel
library is loaded once, when a server on the card starts), so no request
binds a program twice: a warm-cache request calls the stored program and
builds nothing (tests/test_torch_serve.py pins this with a build census).

The key contract: if a knob can change the kernels a program launches or
the shapes it runs at, it MUST appear in the key.  That is rung, padded
shape (b_bucket, n_bucket, d), metric, device and device-set fingerprint,
the flashvat engine, the sample size, and the numerics shield's resolved
plan (tile form + storage dtype).  The reference's kNN fan-out is not
key material here: no servable rung reads it.  Seeds and request deadlines
are runtime data, not key material.

Capacity is a hard bound: inserting past it evicts the least recently
used program.  Hit/miss/eviction counters are exposed via
:meth:`ProgramCache.stats` and surface in the server's ``stats()``.
"""
from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Any, Callable

import torch


@dataclasses.dataclass(frozen=True)
class ProgramKey:
    """Identity of one built fit program.

    Attributes:
      rung: registry rung name ("vat", "ivat", "flashvat", ...).
      b_bucket: padded lane count (0 while the request is queued and
        the group size is still unknown; see :meth:`with_batch`).
      n_bucket: padded row count (exact n for rungs that cannot be
        row-padded, e.g. flashvat's band renderer).
      d: feature dimension (never padded — it changes the math).
      metric: dissimilarity metric the kernels compute.
      mesh: device-set fingerprint from :func:`mesh_fingerprint`.
      turbo: flashvat engine pin (``RungOptions.turbo``): None (the
        rung's default, the persistent kernel) on every primary key,
        False (the stepwise kernel) on the ladder's level below it.
      sample_size: flashvat's rendered representative count.
      num_form: the numerics shield's tile form ("gram" | "direct") —
        resolved host-side per request (``numerics.resolve``) and passed
        to every kernel, so a direct-form batch never rides a Gram-form
        program.
      num_dtype: resolved coordinate-storage precision ("f32" | "bf16")
        — bf16 requests that pass certification key separately so their
        quantized lanes never coalesce with full-precision ones.
      device: where the program runs ("cuda" launches the CUDA kernels,
        "cpu" their plain PyTorch versions).
    """
    rung: str
    b_bucket: int
    n_bucket: int
    d: int
    metric: str
    mesh: str
    turbo: bool | None = None
    sample_size: int = 256
    num_form: str = "gram"
    num_dtype: str = "f32"
    device: str = "cuda"

    def with_batch(self, b_bucket: int) -> "ProgramKey":
        """The same program family at a concrete lane count."""
        return dataclasses.replace(self, b_bucket=b_bucket)


def mesh_fingerprint(device="cuda") -> str:
    """Stable string naming the device set a program runs on, e.g.
    ``"cuda:1"`` (one visible GPU) or ``"cpu:1"``.

    A different device set is a different program, so this lands in every
    ProgramKey.
    """
    dev = torch.device(device)
    count = torch.cuda.device_count() if dev.type == "cuda" else 1
    return f"{dev.type}:{count}"


@dataclasses.dataclass(frozen=True)
class CacheStats:
    """Point-in-time counters for a :class:`ProgramCache`."""
    hits: int
    misses: int
    evictions: int
    size: int
    capacity: int

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0


class ProgramCache:
    """Thread-safe LRU map from :class:`ProgramKey` to built program.

    ``get`` is the only mutation path: on a miss it calls ``build()``
    under the lock, deliberately — two threads racing to build the same
    program would both pay the build and one result would be discarded.
    """

    def __init__(self, capacity: int = 32):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1, got {capacity}")
        self._capacity = capacity
        self._lock = threading.Lock()
        self._programs: OrderedDict[ProgramKey, Any] = OrderedDict()
        self._hits = 0
        self._misses = 0
        self._evictions = 0

    def get(self, key: ProgramKey, build: Callable[[], Any]) -> Any:
        """Return the program for ``key``, building+caching on miss."""
        with self._lock:
            if key in self._programs:
                self._hits += 1
                self._programs.move_to_end(key)
                return self._programs[key]
            self._misses += 1
            program = build()
            self._programs[key] = program
            while len(self._programs) > self._capacity:
                self._programs.popitem(last=False)
                self._evictions += 1
            return program

    def stats(self) -> CacheStats:
        with self._lock:
            return CacheStats(hits=self._hits, misses=self._misses,
                              evictions=self._evictions,
                              size=len(self._programs),
                              capacity=self._capacity)

    def clear(self) -> None:
        with self._lock:
            self._programs.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._programs)

    def __contains__(self, key: ProgramKey) -> bool:
        with self._lock:
            return key in self._programs
