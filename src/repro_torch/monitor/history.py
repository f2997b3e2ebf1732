"""Append-only, schema-versioned tendency history.

As ``repro/monitor/history.py``, numpy only.  `TendencyHistory` records
one row per diag step: the step number plus (hopkins, block_score, k_est)
per probe.  It serializes to a flat dict of numpy arrays
(`to_arrays`/`from_arrays`), which the reference's checkpoint writes
atomically inside the checkpoint step directory (the port's checkpoint
comes with the training stack), so history and weights commit together.

Bitwise discipline: npz *file bytes* are not stable (zip timestamps), so
equality is defined over the deserialized arrays via `digest()` — a
sha256 over the schema version, probe names, step vector, and each field
array's raw bytes in a canonical order.

Schema 2 adds integrity metadata: a per-row uint64 checksum vector
(``row_check``, blake2b over the step and that row's field values in
canonical order) plus the overall ``digest`` bytes.  `from_arrays`
verifies both and raises on mismatch; `recover` is the lenient path — it
salvages the longest verifiable prefix of rows, so a resume survives a
corrupted sidecar.  Schema-1 payloads (no checksums) still load
unchanged.  The arrays pass the ``history.deserialize`` fault site of
``repro_torch.faults`` on the way in.
"""
from __future__ import annotations

import hashlib

import numpy as np

from repro_torch import faults

HISTORY_SCHEMA = 2
FIELDS = ("hopkins", "block_score", "k_est")


def _row_check64(step: int, values) -> np.uint64:
    """uint64 checksum of one row: step + field values, canonical order."""
    h = hashlib.blake2b(digest_size=8)
    h.update(np.int64(step).tobytes())
    h.update(np.asarray(values, np.float32).tobytes())
    return np.uint64(int.from_bytes(h.digest(), "little"))


class TendencyHistory:
    """Append-only per-probe tendency record.

    Rows are keyed by strictly-increasing step numbers; values are
    stored as float32 (the serialized dtype), so an append followed by a
    round-trip is exact.
    """

    def __init__(self, probes: tuple[str, ...]):
        if not probes:
            raise ValueError("TendencyHistory needs at least one probe")
        self.probes = tuple(str(p) for p in probes)
        self.steps: list[int] = []
        self._data: dict[str, dict[str, list[np.float32]]] = {
            p: {f: [] for f in FIELDS} for p in self.probes}

    # ------------------------------------------------------ record ----

    def append(self, step: int, summaries: dict) -> None:
        """Append one diag step: {probe: {field: value}} (append-only)."""
        step = int(step)
        if self.steps and step <= self.steps[-1]:
            raise ValueError(
                f"append-only: step {step} <= last step {self.steps[-1]}")
        missing = [p for p in self.probes if p not in summaries]
        if missing:
            raise ValueError(f"missing probes in summary: {missing}")
        self.steps.append(step)
        for p in self.probes:
            for f in FIELDS:
                self._data[p][f].append(np.float32(summaries[p][f]))

    def __len__(self) -> int:
        return len(self.steps)

    def series(self, probe: str, field: str) -> np.ndarray:
        """(T,) float32 series of one probe field."""
        return np.asarray(self._data[probe][field], np.float32)

    def row(self, i: int) -> dict:
        """{probe: {field: float}} for history row i."""
        return {p: {f: float(self._data[p][f][i]) for f in FIELDS}
                for p in self.probes}

    def truncate(self, max_step: int) -> None:
        """Drop rows with step > max_step (resume-from-checkpoint)."""
        keep = sum(1 for s in self.steps if s <= max_step)
        self.steps = self.steps[:keep]
        for p in self.probes:
            for f in FIELDS:
                self._data[p][f] = self._data[p][f][:keep]

    # --------------------------------------------------- serialize ----

    def _row_checksum(self, i: int) -> np.uint64:
        values = [self._data[p][f][i] for p in self.probes for f in FIELDS]
        return _row_check64(self.steps[i], values)

    def to_arrays(self) -> dict[str, np.ndarray]:
        """Flat arrays dict for atomic serialization alongside a ckpt.

        Schema 2: includes the per-row ``row_check`` checksum vector and
        the overall ``digest`` bytes, so the deserializer can verify row
        integrity and `recover` can truncate to a verifiable prefix.
        """
        out: dict[str, np.ndarray] = {
            "schema": np.asarray([HISTORY_SCHEMA], np.int64),
            "steps": np.asarray(self.steps, np.int64),
            "probes": np.asarray(self.probes),
        }
        for p in self.probes:
            for f in FIELDS:
                out[f"{p}/{f}"] = self.series(p, f)
        out["row_check"] = np.asarray(
            [self._row_checksum(i) for i in range(len(self))], np.uint64)
        out["digest"] = np.frombuffer(bytes.fromhex(self.digest()), np.uint8)
        return out

    @classmethod
    def from_arrays(cls, arrays: dict) -> "TendencyHistory":
        """Strict deserializer: verifies schema-2 integrity metadata.

        Raises ValueError on a row-checksum or digest mismatch; use
        `recover` for the lenient salvage path.  Schema-1 payloads have
        no checksums and load unverified (backward compatible).
        """
        # fault-injection site: chaos tests corrupt the arrays payload
        # through the real deserialize path (disarmed: returns as-is)
        arrays = faults.fault_point("history.deserialize", data=dict(arrays),
                                    context={"keys": sorted(arrays)})
        schema = int(np.asarray(arrays["schema"]).reshape(-1)[0])
        if schema > HISTORY_SCHEMA:
            raise ValueError(f"history schema {schema} is newer than "
                             f"supported ({HISTORY_SCHEMA})")
        probes = tuple(str(p) for p in np.asarray(arrays["probes"]))
        hist = cls(probes)
        hist.steps = [int(s) for s in np.asarray(arrays["steps"])]
        for p in probes:
            for f in FIELDS:
                col = np.asarray(arrays[f"{p}/{f}"], np.float32)
                hist._data[p][f] = [np.float32(v) for v in col]
        if schema >= 2:
            check = np.asarray(arrays["row_check"], np.uint64).reshape(-1)
            if check.shape[0] != len(hist):
                raise ValueError(
                    f"history row_check length {check.shape[0]} != "
                    f"{len(hist)} rows")
            for i in range(len(hist)):
                if np.uint64(check[i]) != hist._row_checksum(i):
                    raise ValueError("history row checksum mismatch at "
                                     f"step {hist.steps[i]}")
            if "digest" in arrays:
                stored = bytes(np.asarray(arrays["digest"], np.uint8))
                if stored != bytes.fromhex(hist.digest()):
                    raise ValueError("history digest mismatch")
        return hist

    @classmethod
    def recover(cls, arrays: dict) -> tuple["TendencyHistory", int] | None:
        """Salvage the longest verifiable prefix of a (possibly corrupt)
        serialized history.

        Rows are kept while (a) step numbers stay strictly increasing
        and (b) when a ``row_check`` vector is present, the row's
        checksum verifies.  A digest mismatch alone never drops rows —
        the row is the integrity unit.  Returns ``(history, dropped)``
        where ``dropped`` counts discarded rows, or None when even the
        structure (probes / steps / columns) is unreadable.
        """
        try:
            arrays = dict(arrays)
            probes = tuple(str(p) for p in np.asarray(arrays["probes"]))
            if not probes:
                return None
            steps = [int(s) for s in
                     np.asarray(arrays["steps"]).reshape(-1)]
            total = len(steps)
            limit = total
            cols: dict[tuple[str, str], np.ndarray] = {}
            for p in probes:
                for f in FIELDS:
                    col = np.asarray(arrays[f"{p}/{f}"],
                                     np.float32).reshape(-1)
                    cols[(p, f)] = col
                    limit = min(limit, col.shape[0])
            check = None
            if "row_check" in arrays:
                check = np.asarray(arrays["row_check"],
                                   np.uint64).reshape(-1)
                limit = min(limit, check.shape[0])
        except Exception:
            return None
        hist = cls(probes)
        for i in range(limit):
            if hist.steps and steps[i] <= hist.steps[-1]:
                break
            values = [cols[(p, f)][i] for p in probes for f in FIELDS]
            if check is not None and \
                    np.uint64(check[i]) != _row_check64(steps[i], values):
                break
            hist.append(steps[i],
                        {p: {f: float(cols[(p, f)][i]) for f in FIELDS}
                         for p in probes})
        return hist, total - len(hist)

    def digest(self) -> str:
        """Canonical content hash — the bitwise-equality primitive."""
        h = hashlib.sha256()
        h.update(f"schema={HISTORY_SCHEMA}".encode())
        h.update(("probes=" + ",".join(self.probes)).encode())
        h.update(np.asarray(self.steps, np.int64).tobytes())
        for p in self.probes:
            for f in FIELDS:
                h.update(self.series(p, f).tobytes())
        return h.hexdigest()

    def nbytes_per_step(self) -> float:
        """Serialized array bytes per recorded step (growth rate)."""
        per_row = 8 + 4 * len(self.probes) * len(FIELDS)
        return float(per_row)
