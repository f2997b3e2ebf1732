"""The Prim ordering kernel's cluster layout, on the CPU.

``vat_prim_order_cuda`` orders one matrix with a cluster of C CTAs, each
holding a slice of the lanes; the CTAs exchange their least packed keys
and all take the least.  The kernel runs only on a GPU
(``test_torch_cuda.py``); here: the host's choice of C
(``prim_cluster_size``, ``prim_block_threads``, ``prim_plan`` on a
stand-in device), the constants it shares
with ``csrc/prim_update.cu``, and a plain model of the sliced exchange held
against ``ref.vat_prim_order_ref`` and against the JAX package's
``vat_order`` with its Pallas argmin (interpret mode), on the same numpy
matrices.
"""
import importlib.util
import pathlib
import re

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro import core as jcore
from repro_torch.kernels import _build, prim_update, ref
from repro_torch.kernels.prim_update import (CLUSTER_BY_N, CLUSTER_SIZES,
                                             SLICE_MAX, UNROLL,
                                             prim_block_threads, prim_bulk,
                                             prim_cluster_size, prim_plan,
                                             prim_slice)

SOURCE = (_build.CSRC / "prim_update.cu").read_text()


def _pack(vals: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``argmin_key.cuh``'s packed (value, index) keys as int64 that order
    as the kernel's unsigned keys do: -0.0 folded onto +0.0, the f32 bits
    made monotone, shifted by 2^31 into the signed range."""
    v = torch.where(vals == 0, torch.zeros_like(vals), vals)
    u = v.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    ordered = torch.where(u >= 0x80000000, u ^ 0xFFFFFFFF, u | 0x80000000)
    return (ordered - 0x80000000) * (1 << 32) + idx


def _sliced_order(R: torch.Tensor, i0: int, c: int) -> torch.Tensor:
    """The kernel's step as plain torch: CTA r owns the lanes of slice r
    (ceil(n / c) rounded up to 32), takes the least key of its slice, and
    every CTA takes the least of the c slice keys."""
    n = R.shape[0]
    width = -(-(-(-n // c)) // 32) * 32
    idx = torch.arange(n)
    mind = R[i0].clone()
    sel = idx == i0
    order = [i0]
    for _ in range(1, n):
        keys = _pack(torch.where(sel, torch.inf, mind), idx)
        parts = [keys[r * width:(r + 1) * width].min()
                 for r in range(c) if r * width < n]
        q = int(torch.stack(parts).min()) & 0xFFFFFFFF
        order.append(q)
        sel[q] = True
        mind = torch.minimum(mind, R[q])
    return torch.tensor(order)


def _int_matrix(n, seed, d=3, span=2):
    """Squared distances of integer points: exact f32 integers, many ties
    (duplicate points give zero entries off the diagonal)."""
    rng = np.random.default_rng(seed)
    X = rng.integers(-span, span + 1, size=(n, d)).astype(np.float32)
    return np.sum((X[:, None] - X[None]) ** 2, axis=-1).astype(np.float32)


def _signed_zero(R):
    """The zeros of every other row made -0.0."""
    Rz = R.copy()
    Rz[(Rz == 0) & (np.arange(len(R)) % 2 == 0)[:, None]] = -0.0
    return Rz


def _matrices(n):
    rng = np.random.default_rng(n)
    X = rng.normal(size=(n, 4)).astype(np.float32)
    flt = np.sqrt(np.sum((X[:, None] - X[None]) ** 2, axis=-1)).astype(
        np.float32)
    R = _int_matrix(n, seed=n)
    return {"float": flt, "int": R, "signed_zero": _signed_zero(R)}


@pytest.fixture
def device(monkeypatch):
    """A stand-in for the card under ``prim_plan``: an H100's 50 MiB of L2
    and, by default, room for one cluster of every launch; ``held`` (C ->
    clusters) replaces that room, ``asked`` records every query."""
    state = {"held": None, "asked": []}

    def resident(c, n, threads, bulk):
        state["asked"].append((c, n, threads, bulk))
        return 1 if state["held"] is None else state["held"][c]
    monkeypatch.setattr(prim_update, "_resident_clusters", resident)
    monkeypatch.setattr(prim_update, "_l2_bytes", lambda: 50 << 20)
    return state


@pytest.mark.parametrize("n", [1, 2, 64, 128, 256])
def test_cluster_size_is_one_at_small_n(n):
    assert prim_cluster_size(n) == 1


@pytest.mark.parametrize("n", [1, 2, 3, 129, 513, 2047, 2048, 4097, 16_383,
                               16_384, 40_960, 40_961, 141_000])
def test_cluster_size_is_a_power_of_two_that_fits(device, n):
    """C is one of the built sizes, no larger than n, holds n lanes, and
    is the plan's C."""
    c = prim_cluster_size(n)
    assert c in CLUSTER_SIZES and c <= min(n, 16)
    assert c * SLICE_MAX >= n
    assert prim_plan(n)[0] == c


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("n", [128, 1024, 2047, 2048, 3620, 3624, 4096,
                               16_383, 16_384])
def test_plan_takes_the_bulk_copy_where_a_matrix_outgrows_the_l2(
        device, n, aligned):
    """The host's row route: the bulk copy exactly where it may run
    (``prim_bulk``, aligned R) and one (n, n) f32 matrix is larger than
    the L2 (50 MiB here: n > 3,620), whatever the stack."""
    c, threads, bulk = prim_plan(n, aligned=aligned)
    assert bulk == (aligned and prim_bulk(n, c) and 4 * n * n > 50 << 20)
    assert threads == prim_block_threads(n, c, bulk)


@pytest.mark.parametrize("max_active", [
    {1: 132, 2: 66, 4: 32, 8: 16, 16: 0},     # no non-portable size
    {1: 132, 2: 66, 4: 32, 8: 0, 16: 0},
    {1: 4, 2: 2, 4: 1, 8: 1, 16: 1},
    {1: 1, 2: 0, 4: 0, 8: 0, 16: 0},
])
@pytest.mark.parametrize("n", [2, 2048, 16_384, 40_000])
def test_cluster_size_never_above_what_the_device_holds(device, n,
                                                        max_active):
    """The plan launches a C the device holds, chosen or forced, and where
    it holds none of that C it raises: it never drops to a smaller C."""
    device["held"] = max_active
    c = prim_cluster_size(n)
    if max_active[c] >= 1:
        assert prim_plan(n)[0] == c
    else:
        with pytest.raises(RuntimeError, match="holds no cluster of"):
            prim_plan(n)
    for k in CLUSTER_SIZES:
        if k > n or k * SLICE_MAX < n:
            continue
        if max_active[k] >= 1:
            assert prim_plan(n, cluster=k)[0] == k
        else:
            with pytest.raises(RuntimeError, match="holds no cluster of"):
                prim_plan(n, cluster=k)


def test_cluster_size_refuses_what_it_cannot_hold(device):
    with pytest.raises(ValueError, match="at most"):
        prim_cluster_size(16 * SLICE_MAX + 1)
    with pytest.raises(ValueError, match="n >= 1"):
        prim_cluster_size(0)
    device["held"] = {1: 132, 2: 0, 4: 0, 8: 0, 16: 0}
    with pytest.raises(RuntimeError, match="holds no cluster"):
        prim_plan(SLICE_MAX + 1)


def test_cluster_size_grows_with_n():
    sizes = [prim_cluster_size(n)
             for n in (1, 128, 1024, 2048, 4096, 16_384, 65_536)]
    assert sizes == sorted(sizes)
    assert [top for top, _ in CLUSTER_BY_N][-1] is None


@pytest.mark.parametrize("bulk", [None, False, True])
@pytest.mark.parametrize("n", [128, 2047, 2048, 16_384])
def test_plan_asks_the_device_about_the_launch_it_makes(device, n, bulk):
    """The occupancy query is made at the plan's own C, threads and row
    route (not at the largest CTA), and a bulk copy asked for where it
    cannot run is refused before any query."""
    c = prim_cluster_size(n)
    if bulk and not prim_bulk(n, c):
        with pytest.raises(ValueError, match="bulk row copy"):
            prim_plan(n, bulk=bulk)
        assert device["asked"] == []
        return
    plan = prim_plan(n, bulk=bulk)
    assert device["asked"] == [(plan[0], n, plan[1], plan[2])]
    assert plan[1] == prim_block_threads(n, plan[0], plan[2])


def test_phase_tool_patches_match_the_kernel_once():
    """Every patch of ``tools/prim_order_phases.py`` (the split's variants
    and the step floor chip_smoke.py logs) matches the kernel's text
    exactly once, so the tool builds each variant of this kernel."""
    path = pathlib.Path(__file__).resolve().parents[1] / "tools" \
        / "prim_order_phases.py"
    spec = importlib.util.spec_from_file_location("prim_order_phases", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    for name, (pattern, _) in tool.PATCHES.items():
        assert len(re.findall(pattern, SOURCE)) == 1, name
    assert set(tool.VARIANTS) >= set(tool.ONE_CTA_VARIANTS)


@pytest.mark.parametrize("bulk", [False, True])
@pytest.mark.parametrize("n", [1, 129, 2048, 16_384, 40_961, 655_360])
@pytest.mark.parametrize("c", CLUSTER_SIZES)
def test_block_threads(n, c, bulk):
    t = prim_block_threads(n, c, bulk)
    assert t % 32 == 0 and 128 <= t <= 1024
    lanes = -(-n // c)
    assert t == 1024 or t * UNROLL >= lanes   # one round of loads a thread
    if not bulk and lanes <= 512:
        assert t >= lanes                     # a thread a lane


@pytest.mark.parametrize("n", [1, 3, 128, 2047, 2048, 16_383, 16_384,
                               40_960, 141_000])
@pytest.mark.parametrize("c", CLUSTER_SIZES)
def test_slices_cover_n_and_bulk_rows_fit(n, c):
    """Slices of 32-lane multiples cover n; a bulk row copy is allowed only
    on 16-byte rows whose buffer fits beside the frontier."""
    s = prim_slice(n, c)
    assert s % 32 == 0 and s * c >= n and s - 32 < -(-n // c)
    assert prim_bulk(n, c) == (n % 4 == 0 and 9 * s <= 5 * SLICE_MAX)


def test_constants_match_the_kernel_source():
    """The host's slice capacity, unroll and cluster sizes are the
    kernel's."""
    assert re.search(r"PRIM_SLICE_MAX = (\d+);", SOURCE).group(1) \
        == str(SLICE_MAX)
    assert re.search(r"PRIM_UNROLL = (\d+);", SOURCE).group(1) == str(UNROLL)
    built = re.findall(r"case (\d+):\s+err = prim_dispatch<\1>", SOURCE)
    assert tuple(int(c) for c in built) == CLUSTER_SIZES


@pytest.mark.parametrize("kind", ["float", "int", "signed_zero"])
@pytest.mark.parametrize("n", [1, 2, 3, 33, 70, 129])
def test_sliced_exchange_gives_the_loops_order(n, kind):
    """Per-slice least key, then the least of the slices: the order of
    ``ref.vat_prim_order_ref`` for every C, on tie-heavy integer matrices
    and with signed zeros."""
    R = torch.from_numpy(_matrices(n)[kind])
    i0 = torch.argmax(torch.amax(R, dim=1)).view(1)
    want = ref.vat_prim_order_ref(R, i0)
    for c in CLUSTER_SIZES:
        assert torch.equal(_sliced_order(R, int(i0), c), want), c


@pytest.mark.parametrize("kind", ["int", "signed_zero", "float"])
@pytest.mark.parametrize("n", [5, 37, 67])
def test_sliced_exchange_matches_the_pallas_reference(n, kind):
    """The sliced model's order == the JAX package's ``vat_order`` with its
    Pallas masked argmin (interpret mode), at n that no C > 1 divides."""
    R = _matrices(n)[kind]
    want = np.asarray(jcore.vat_order(jnp.asarray(R), use_pallas_argmin=True))
    Rt = torch.from_numpy(R)
    i0 = int(torch.argmax(torch.amax(Rt, dim=1)))
    for c in CLUSTER_SIZES:
        np.testing.assert_array_equal(_sliced_order(Rt, i0, c).numpy(), want)
