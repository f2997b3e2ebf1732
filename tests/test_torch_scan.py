"""``models.common.scan``, the port's ``lax.scan``, and rwkv6's WKV
recurrence through it (``rwkv6._wkv_step``).

* On CPU tensors ``scan`` is the Python loop: the outputs, the last carry
  and the gradients of every input equal an explicit loop (the recurrence
  as rwkv6 wrote it before ``scan``) bit for bit, with S below and above
  ``_ONCE_MIN``, and the traced-once path (``_ScanOnce``) is never
  entered.  rwkv6's parity with ``repro`` is held by
  ``tests/test_torch_families.py`` and ``tests/test_torch_decode.py``.
* On "meta" tensors under the dry run's census: a step whose counts change
  between positions makes the traced-once path raise, whether the change
  shows in the forward or only in the backward's runs; the cycle
  collector freeing another part's storage inside a step does not count
  as the step's (the fault that made rwkv6's production cells raise on
  the card machine's host, where the dry run's fallbacks leave cyclic
  garbage holding storage); without a census,
  or below ``_ONCE_MIN`` positions, it runs the loop.  The dry run's
  records with it equal the step-by-step records:
  ``tests/test_torch_dryrun.py``.
"""
import gc

import numpy as np
import pytest
import torch

from repro_torch.launch import dryrun as D
from repro_torch.models import common, sharding
from repro_torch.models.rwkv6 import _wkv_scan, _wkv_step

B, H, N = 2, 3, 4


def _inputs(S, seed, device="cpu", carry_grad=False):
    """r, k, v, w (S,B,H,N), u (1,H,N,1), wkv (B,H,N,N), from a numpy
    seed; w in (0, 1) as the decay is."""
    rng = np.random.default_rng(seed)
    shapes = [(S, B, H, N)] * 4 + [(1, H, N, 1), (B, H, N, N)]
    ts = [torch.tensor(rng.normal(size=s).astype(np.float32), device=device)
          for s in shapes]
    ts[3] = torch.sigmoid(ts[3])
    for t in ts[:5]:
        t.requires_grad_()
    ts[5].requires_grad_(carry_grad)
    return ts


def _explicit_loop(r, k, v, w, u, wkv):
    ys = []
    for t in range(r.shape[0]):
        kv = k[t, :, :, :, None] * v[t, :, :, None, :]
        ys.append(torch.einsum("bhn,bhnm->bhm", r[t], wkv + u * kv))
        wkv = w[t, :, :, :, None] * wkv + kv
    return torch.stack(ys), wkv


@pytest.fixture(autouse=True)
def _no_census():
    yield
    sharding.set_census(None)


@pytest.mark.parametrize("S,seed,carry_grad", [
    (5, 0, False), (common._ONCE_MIN, 1, True), (64, 2, False),
    (64, 3, True)])
def test_cpu_scan_is_the_loop_bit_for_bit(S, seed, carry_grad, monkeypatch):
    def never(*a):
        raise AssertionError("the traced-once path ran on CPU tensors")
    monkeypatch.setattr(common._ScanOnce, "apply", never)
    rng = np.random.default_rng(seed + 100)
    gy = torch.tensor(rng.normal(size=(S, B, H, N)).astype(np.float32))
    gc = torch.tensor(rng.normal(size=(B, H, N, N)).astype(np.float32))
    outs = []
    for fn in (_wkv_scan, _explicit_loop):
        ins = _inputs(S, seed, carry_grad=carry_grad)
        ys, wkv = fn(*ins)
        loss = (ys * gy).sum() + (wkv * gc).sum()
        want = [t for t in ins if t.requires_grad]
        outs.append((ys, wkv, torch.autograd.grad(loss, want)))
    (ys, wkv, grads), (ys0, wkv0, grads0) = outs
    assert torch.equal(ys, ys0) and torch.equal(wkv, wkv0)
    assert len(grads) == len(grads0) == 5 + carry_grad
    assert all(torch.equal(a, b) for a, b in zip(grads, grads0))


def _meta(S, carry_grad=False):
    return [t.detach().to("meta").requires_grad_(t.requires_grad)
            for t in _inputs(S, 0, carry_grad=carry_grad)]


def _drifting(at: int):
    """``_wkv_step`` with one more op in its ``at``-th call: calls 1-6 are
    the forward's positions 0-5, calls 7-24 the backward's runs over 3, 4,
    5 and 6 positions."""
    calls = [0]

    def step(c, x, u):
        calls[0] += 1
        c, y = _wkv_step(c, x, u)
        return c, (y * 1.0 if calls[0] == at else y)
    return step


@pytest.mark.parametrize("at,where", [(3, "a step counts"),
                                      (6 + 3 + 4 + 2, "a step's VJP")])
def test_meta_scan_raises_when_positions_count_differently(at, where):
    r, k, v, w, u, wkv = _meta(32)
    census = D.Census(())
    sharding.set_census(census)
    with census, pytest.raises(RuntimeError, match=where):
        wkv, ys = common.scan(_drifting(at), wkv, (r, k, v, w), (u,))
        torch.autograd.grad(ys.sum(), [r, k, v, w, u])


@pytest.mark.parametrize("S,counted", [(32, False),
                                       (common._ONCE_MIN - 1, True)])
def test_meta_scan_runs_the_loop_uncounted_or_short(S, counted,
                                                    monkeypatch):
    """Without a census, or below ``_ONCE_MIN`` positions, ``scan`` on
    "meta" tensors is the loop, with the loop's shapes."""
    def never(*a):
        raise AssertionError("traced once")
    monkeypatch.setattr(common._ScanOnce, "apply", never)
    if counted:
        sharding.set_census(D.Census(()))
    ins = _meta(S, carry_grad=True)
    wkv, ys = common.scan(_wkv_step, ins[5], tuple(ins[:4]), (ins[4],))
    assert ys.shape == (S, B, H, N) and wkv.shape == (B, H, N, N)
    assert ys.device.type == "meta"
    grads = torch.autograd.grad((ys.sum(), wkv.sum()), ins)
    assert [g.shape for g in grads] == [t.shape for t in ins]


def test_meta_scan_counts_without_the_cycle_collector():
    """Cyclic garbage that holds a counted storage, left before the scan,
    and a step that lets the collector run at position 2 (it would free
    that storage there): the positions still count alike."""
    calls = [0]

    def step(c, x, u):
        calls[0] += 1
        if calls[0] == 3:
            gc.set_threshold(1)
            [[] for _ in range(10)]
        return _wkv_step(c, x, u)
    r, k, v, w, u, wkv = _meta(32)
    census = D.Census(())
    sharding.set_census(census)
    old, was = gc.get_threshold(), gc.isenabled()
    try:
        gc.disable()
        with census:
            junk = [torch.empty(1 << 20, device="meta") * 1.0]
            junk.append(junk)
            del junk
            gc.set_threshold(10**9)
            gc.enable()
            wkv, ys = common.scan(step, wkv, (r, k, v, w), (u,))
    finally:
        gc.set_threshold(*old)
        (gc.enable if was else gc.disable)()
    assert ys.shape == (32, B, H, N) and calls[0] == 6
