"""``moe_ffn`` on a gloo world of eight ranks against one rank, for
``tests/test_torch_launch.py``: run as a script, it spawns eight ranks on a
(2, 2, 2) ("pod", "data", "model") mesh.

  python tests/_torch_moe_ep.py STORE_FILE

Each rank builds the same seeded inputs: deepseek-v3's smoke layer with 8
experts (group-limited routing, a shared expert) in float32.  For each
case, the layer runs once on the rank's own (whole) tensors and once
under the mesh, and the loss ``sum(y * r) + aux`` is taken back through
both.  The cases cover every role a mesh dim can take in the dispatch:

* experts over "model", slots over ("pod", "data") (two token dims that
  split the buffer: two reduce-scatters);
* ``set_ep2d``: experts over ("data", "model"), slots whole ("pod" splits
  the tokens and not the buffer: an all-reduce);
* either, at a batch of 2 on 4 token ranks (the tokens whole on every
  rank: each rank keeps its own part).

Rank 0 prints ``MOE_EP_OK <cases> <largest output gap> <largest gradient
gap>`` once every rank's checks hold: the output and aux equal the one
rank's within ``RTOL`` of their scale, as do the gradients of the input,
the router and the expert weights.
"""
import datetime
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import sharding  # noqa: E402
from repro_torch.models.moe import moe_ffn  # noqa: E402

CFG = smoke_config("deepseek-v3-671b").replace(
    n_experts=8, route_groups=2, route_top_groups=1)
#: (ep2d, batch, length)
CASES = [(False, 8, 16), (True, 8, 16), (False, 2, 8), (True, 2, 8)]
#: the mesh's results against one rank's, relative to each one's largest
#: entry: the same f32 products, the shared expert's and the router's
#: summed over other splits (measured: 3.9e-7 and 4.1e-7)
RTOL = 1e-6


def _layer_params(gen):
    """One moe layer's leaves (layer dim of 1), f32."""
    params = M.init_params(CFG, gen, device="cpu")
    return {k: v for k, v in params["layers"].items()
            if k in ("router", "e_gate", "e_up", "e_down", "s_gate", "s_up",
                     "s_down")}


def from_full(t, ns, mesh):
    """The same full tensor on every rank -> a ``DTensor`` with the
    sharding's placements (each rank keeps its own block)."""
    from torch.distributed.tensor import DTensor, Replicate
    full = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
    return full.redistribute(mesh, ns.placements)


def _run(p, h, r, mesh=None):
    """(y, aux, grads of h and of every leaf), whole on every rank."""
    from torch.distributed.tensor import DTensor, Replicate
    leaves = {k: v.detach().clone().requires_grad_() for k, v in p.items()}
    hh = h.detach().clone().requires_grad_()
    if mesh is None:
        lp = {k: v[0] for k, v in leaves.items()}
        y, aux = moe_ffn(lp, hh, CFG)
        loss = (y * r).sum() + aux
    else:
        from repro_torch.launch.dryrun import distribute
        sharding.set_mesh(mesh)
        try:
            placed = distribute(leaves, sharding.param_shardings(
                {"layers": leaves}, mesh)["layers"], mesh, from_full)
            lp = {k: sharding.gather_fsdp(v[0]) for k, v in placed.items()}
            hd = sharding.hint(DTensor.from_local(
                hh, mesh, [Replicate()] * mesh.ndim, run_check=False),
                "dp", None, None)
            y, aux = moe_ffn(lp, hd, CFG)
            loss = (y * r).sum() + aux
        finally:
            sharding.set_mesh(None)
    grads = torch.autograd.grad(loss, [hh, *leaves.values()])
    whole = [t.full_tensor() if isinstance(t, DTensor) else t
             for t in (y, aux, *grads)]
    return whole[0], whole[1], dict(zip(["h", *leaves], whole[2:]))


def _gap(a, b) -> float:
    a, b = a.detach(), b.detach()
    scale = float(b.abs().max()) or 1.0
    return float((a - b).abs().max()) / scale


def _rank_main(rank, world, store):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        mesh = init_device_mesh("cpu", (2, 2, 2),
                                mesh_dim_names=("pod", "data", "model"))
        out_gap = grad_gap = 0.0
        for ep2d, B, S in CASES:
            gen = torch.Generator().manual_seed(B * 100 + S)
            p = _layer_params(gen)
            h = torch.randn(B, S, CFG.d_model, generator=gen)
            r = torch.randn(B, S, CFG.d_model, generator=gen)
            y1, aux1, g1 = _run(p, h, r)
            sharding.set_ep2d(ep2d)
            try:
                with implicit_replication():
                    y, aux, g = _run(p, h, r, mesh)
            finally:
                sharding.set_ep2d(False)
            case = (ep2d, B, S)
            out_gap = max(out_gap, _gap(y, y1), _gap(aux, aux1))
            assert _gap(y, y1) <= RTOL and _gap(aux, aux1) <= RTOL, case
            for k, v in g1.items():
                assert torch.isfinite(g[k]).all(), (case, k)
                grad_gap = max(grad_gap, _gap(g[k], v))
                assert _gap(g[k], v) <= RTOL, (case, k, _gap(g[k], v))
        dist.barrier()
        if rank == 0:
            print(f"MOE_EP_OK {len(CASES)} {out_gap!r} {grad_gap!r}",
                  flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    import torch.multiprocessing as mp
    mp.spawn(_rank_main, args=(8, sys.argv[1]), nprocs=8)
