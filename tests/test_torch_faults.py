"""The port's fault-injection registry held against the JAX package's.

The reference's registry cases (``tests/test_faults.py``) run against
``repro_torch.faults``; then the port's two live sites: ``kernels.dispatch``
in every public wrapper of ``kernels/ops.py`` (with the reference's context
keys) and ``kernels.numerics_trip`` in ``numerics.resolve`` (the counted
bf16 fallback of ``tests/test_numerics.py::test_resolve_bf16_fault_trip``).
The registries are module-global, so every test starts and ends disarmed.
"""
import os

import numpy as np
import pytest
import torch

import repro.faults as jfaults
import repro_torch.faults as faults
from repro_torch.kernels import ops
from repro_torch.numerics import NumericsPolicy, resolve

from _numerics_data import grid_clusters


@pytest.fixture(autouse=True)
def _clean_registry():
    faults.disarm_all()
    jfaults.disarm_all()
    yield
    faults.disarm_all()
    jfaults.disarm_all()


SITE = "serve.execute"


def test_sites_are_the_reference_sites():
    assert faults.SITES == jfaults.SITES


def test_registries_are_separate():
    jfaults.arm("kernels.dispatch", times=-1)
    assert not faults.is_armed("kernels.dispatch")
    ops.pairwise_dist(torch.zeros(4, 2))          # the port's site is clean
    faults.arm(SITE)
    assert not jfaults.is_armed(SITE)


class TestRegistry:
    def test_unknown_site_rejected(self):
        with pytest.raises(ValueError, match="unknown injection site"):
            faults.arm("serve.exeucte")  # typo'd on purpose

    def test_unknown_kind_rejected(self):
        with pytest.raises(ValueError, match="kind"):
            faults.arm(SITE, kind="explode")

    def test_arm_disarm_roundtrip(self):
        faults.arm(SITE)
        assert faults.is_armed(SITE)
        assert SITE in faults.armed()
        faults.disarm(SITE)
        assert not faults.is_armed(SITE)
        assert faults.armed() == {}

    def test_disarm_all(self):
        faults.arm(SITE)
        faults.arm("serve.build")
        faults.disarm_all()
        assert faults.armed() == {}

    def test_injected_context_manager_disarms(self):
        with faults.injected(SITE):
            assert faults.is_armed(SITE)
            with pytest.raises(faults.FaultInjected):
                faults.fault_point(SITE)
        assert not faults.is_armed(SITE)

    def test_disarmed_fast_path_returns_data(self):
        payload = np.arange(5)
        out = faults.fault_point(SITE, data=payload)
        assert out is payload          # identity: untouched, uncopied

    def test_armed_other_site_returns_data(self):
        faults.arm("serve.build")
        payload = b"abc"
        assert faults.fault_point(SITE, data=payload) is payload


class TestScheduling:
    def test_times_limits_firings(self):
        faults.arm(SITE, times=2)
        for _ in range(2):
            with pytest.raises(faults.FaultInjected):
                faults.fault_point(SITE)
        faults.fault_point(SITE)       # third hit: clean
        assert faults.stats()[SITE] == {"hits": 3, "fired": 2}

    def test_after_skips_initial_hits(self):
        faults.arm(SITE, after=2, times=1)
        faults.fault_point(SITE)
        faults.fault_point(SITE)
        with pytest.raises(faults.FaultInjected):
            faults.fault_point(SITE)
        faults.fault_point(SITE)
        assert faults.stats()[SITE] == {"hits": 4, "fired": 1}

    def test_times_forever(self):
        faults.arm(SITE, times=-1)
        for _ in range(5):
            with pytest.raises(faults.FaultInjected):
                faults.fault_point(SITE)

    def test_match_gates_hit_counting(self):
        faults.arm(SITE, times=1,
                   match=lambda ctx: "poison" in ctx.get("tags", []))
        faults.fault_point(SITE, context={"tags": ["clean"]})
        with pytest.raises(faults.FaultInjected):
            faults.fault_point(SITE, context={"tags": ["clean", "poison"]})
        # the non-matching visit did not consume the firing budget
        assert faults.stats()[SITE] == {"hits": 1, "fired": 1}


class TestKinds:
    def test_raise_default_exception_carries_site(self):
        faults.arm(SITE)
        with pytest.raises(faults.FaultInjected) as ei:
            faults.fault_point(SITE)
        assert ei.value.site == SITE

    def test_raise_custom_exception_and_message(self):
        faults.arm(SITE, exc=OSError, message="disk on fire")
        with pytest.raises(OSError, match="disk on fire"):
            faults.fault_point(SITE)

    def test_delay_uses_injected_sleep(self):
        slept = []
        faults.arm(SITE, kind="delay", delay_s=1.5)
        faults.fault_point(SITE, sleep=slept.append)
        assert slept == [1.5]

    def test_corrupt_bytes_deterministic(self):
        payload = bytes(range(64))
        faults.arm(SITE, kind="corrupt", times=-1, seed=7)
        a = faults.fault_point(SITE, data=payload)
        b = faults.fault_point(SITE, data=payload)
        assert a == b != payload
        assert len(a) == len(payload)
        diff = [i for i in range(64) if a[i] != payload[i]]
        assert len(diff) == 1          # exactly one flipped byte
        assert 0 < diff[0] < 63        # away from both ends

    def test_corrupt_array_copies(self):
        arr = np.zeros(16, np.float32)
        faults.arm(SITE, kind="corrupt")
        out = faults.fault_point(SITE, data=arr)
        assert not np.array_equal(out, arr)
        assert np.array_equal(arr, np.zeros(16, np.float32))  # original safe

    def test_corrupt_dict_flips_one_value(self):
        d = {"a": np.zeros(8, np.float32), "b": np.ones(8, np.float32)}
        faults.arm(SITE, kind="corrupt", seed=0)
        out = faults.fault_point(SITE, data=d)
        changed = [k for k in d if not np.array_equal(out[k], d[k])]
        assert len(changed) == 1

    def test_truncate_bytes(self):
        faults.arm(SITE, kind="truncate")
        out = faults.fault_point(SITE, data=bytes(range(10)))
        assert out == bytes(range(5))

    def test_truncate_array(self):
        faults.arm(SITE, kind="truncate")
        out = faults.fault_point(SITE, data=np.arange(10))
        assert out.shape == (5,)

    def test_corrupt_file_in_place(self, tmp_path):
        p = os.path.join(tmp_path, "blob.bin")
        original = bytes(range(256))
        with open(p, "wb") as f:
            f.write(original)
        faults.arm(SITE, kind="corrupt", seed=3)
        faults.fault_point(SITE, path=p)
        with open(p, "rb") as f:
            raw = f.read()
        assert len(raw) == 256 and raw != original

    def test_truncate_file_in_place(self, tmp_path):
        p = os.path.join(tmp_path, "blob.bin")
        with open(p, "wb") as f:
            f.write(bytes(256))
        faults.arm(SITE, kind="truncate")
        faults.fault_point(SITE, path=p)
        assert os.path.getsize(p) == 128

    def test_unsupported_payload_type(self):
        faults.arm(SITE, kind="corrupt")
        with pytest.raises(TypeError, match="cannot corrupt"):
            faults.fault_point(SITE, data=[1, 2, 3])


@pytest.mark.parametrize("payload", [
    bytes(range(97)), np.arange(40, dtype=np.float32),
    {"a": np.zeros(8, np.float32), "b": np.arange(6)}])
@pytest.mark.parametrize("kind", ["corrupt", "truncate"])
def test_mutations_match_reference(payload, kind):
    """The same arm call corrupts a payload byte for byte as the
    reference's registry does."""
    faults.arm(SITE, kind=kind, seed=5)
    jfaults.arm(SITE, kind=kind, seed=5)
    got = faults.fault_point(SITE, data=payload)
    want = jfaults.fault_point(SITE, data=payload)
    if isinstance(payload, dict):
        assert got.keys() == want.keys()
        for k in got:
            np.testing.assert_array_equal(got[k], want[k])
    elif isinstance(payload, np.ndarray):
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


# ----------------------------------------------------- the live sites ----

def test_dispatch_site_raises_from_pairwise_dist():
    """An armed ``kernels.dispatch`` raises from the wrapper before any
    work, with the reference's context keys; once disarmed the call runs."""
    seen = []
    faults.arm("kernels.dispatch", times=1,
               match=lambda ctx: seen.append(dict(ctx)) or True)
    X = torch.randn(16, 3, generator=torch.Generator().manual_seed(0))
    with pytest.raises(faults.FaultInjected) as ei:
        ops.pairwise_dist(X)
    assert ei.value.site == "kernels.dispatch"
    assert seen == [{"op": "pairwise_dist", "use_pallas": False,
                     "device": "cpu"}]
    faults.disarm_all()
    assert ops.pairwise_dist(X).shape == (16, 16)


@pytest.mark.parametrize("op,call", [
    ("masked_argmin", lambda: ops.masked_argmin(
        torch.arange(5.0), torch.zeros(5, dtype=torch.bool))),
    ("vat_prim_order", lambda: ops.vat_prim_order(
        ops.pairwise_dist(torch.eye(4)), torch.zeros(1, dtype=torch.int64))),
    ("ivat_from_vat", lambda: ops.ivat_from_vat(
        ops.pairwise_dist(torch.eye(4)))),
    ("knn_graph", lambda: ops.knn_graph(torch.eye(6), k=2)),
])
def test_dispatch_site_match_picks_one_op(op, call):
    """A ``match`` on ``context["op"]`` poisons one wrapper and no other:
    the wrapper under test raises while the pairwise calls it makes on the
    way do not."""
    faults.arm("kernels.dispatch", times=-1,
               match=lambda ctx: ctx["op"] == op)
    with pytest.raises(faults.FaultInjected):
        call()
    assert faults.stats()["kernels.dispatch"]["fired"] == 1


def test_resolve_bf16_fault_trip():
    """The port's counterpart of the reference's chaos seam:
    ``kernels.numerics_trip`` fails the bf16 certification on demand, a
    counted fallback to f32, and only the port's own registry trips it."""
    X = grid_clusters()
    with jfaults.injected("kernels.numerics_trip"):
        _, untouched = resolve(X, metric="euclidean",
                               policy=NumericsPolicy(dtype="bf16"))
    assert untouched.dtype == "bf16" and untouched.fallbacks == 0
    with faults.injected("kernels.numerics_trip"):
        _, rep = resolve(X, metric="euclidean",
                         policy=NumericsPolicy(dtype="bf16"))
    assert rep.dtype == "f32" and rep.fallbacks == 1
    _, clean = resolve(X, metric="euclidean",
                       policy=NumericsPolicy(dtype="bf16"))
    assert clean.dtype == "bf16" and clean.fallbacks == 0
