"""The elastic re-mesh's world of ranks, for ``tests/test_torch_launch.py``
(the port's counterpart of ``tests/test_elastic.py``): run as a script,
it spawns ``world`` gloo ranks that restore a checkpoint written by one
rank into the shardspecs' placements on a (2, 2) mesh and step again.

  python tests/_torch_elastic.py WORLD CKPT_DIR STORE_FILE [ARCH]

``ARCH`` picks the smoke config of ``CFGS`` (phi3-mini by default; rwkv6,
zamba2, phi3.5-moe and deepseek-v3 with the dry run's ``seq_shard`` and
``remat="full"``, so the WKV loop and the SSD chunk loop run on each
rank's heads, the moe dispatch and combine on each rank's shard of the
experts, and the sublayers gather the sequence; deepseek-v3 with its MLA,
its MTP block, group-limited routing and its experts over model x data).  Rank 0 prints ``ELASTIC_OK <sharded
loss> <one-rank loss> <collectives> <gradient norm's relative gap>
<largest parameter gap>`` once every rank's checks hold: the losses
agree, and the sharded step's gradient norm and updated parameters equal
the one-rank step's.
"""
import datetime
import math
import os
import sys

import torch
import torch.distributed as dist

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro_torch.data.tokens import make_batch  # noqa: E402
from repro_torch.train import steps as S  # noqa: E402

CFGS = {"phi3-mini-3.8b": smoke_config("phi3-mini-3.8b"),
        **{a: smoke_config(a).replace(seq_shard=True, remat="full")
           for a in ("rwkv6-3b", "zamba2-2.7b", "phi3.5-moe-42b-a6.6b")},
        "deepseek-v3-671b": smoke_config("deepseek-v3-671b").replace(
            seq_shard=True, remat="full", route_groups=2,
            route_top_groups=1)}
#: the configs whose experts spread over model x data (``set_ep2d``), as
#: the dry run's optimized deepseek-v3 cells place them
EP2D = {"deepseek-v3-671b"}
CFG = CFGS["phi3-mini-3.8b"]
TC = TrainConfig(lr=1e-3)
SHAPE = ShapeConfig("t", 32, 8, "train")
#: the sharded step's loss and gradient norm against the one-rank step's,
#: relative: the same f32 products summed over other splits (measured:
#: 9e-8 and 8e-8; a gradient left as one rank's part was 4e-3 off)
LOSS_RTOL = 1e-5
#: the updated parameters against the one-rank step's, absolute: one
#: AdamW step of lr 1e-3 from gradients that agree within LOSS_RTOL
#: (measured: 3e-8)
PARAM_ATOL = 1e-6


def batch(cfg=CFG) -> dict:
    return {k: torch.as_tensor(v)
            for k, v in make_batch(cfg, SHAPE, device="cpu").items()}


def from_full(t, ns, mesh):
    """The same full tensor on every rank -> a ``DTensor`` with the
    sharding's placements (each rank keeps its own block: no message)."""
    from torch.distributed.tensor import DTensor, Replicate
    full = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
    return full.redistribute(mesh, ns.placements)


def _flat(tree, prefix="params/"):
    """(path, leaf) pairs of a dict tree."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def _rank_main(rank, world, ckpt_dir, store, arch):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.dryrun import distribute
    from repro_torch.launch.shardspecs import batch_shardings, state_shardings
    from repro_torch.models import sharding

    cfg = CFGS[arch]
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        template = S.init_state(cfg, TC, torch.Generator().manual_seed(1),
                                device="cpu")
        restored, manifest = ckpt.restore(ckpt_dir, template)
        assert manifest["step"] == 1, manifest
        one_state, one = S.build_train_step(cfg, TC)(restored, batch(cfg))
        restored, _ = ckpt.restore(ckpt_dir, template)
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        sharding.set_ep2d(arch in EP2D)
        state = distribute(restored, state_shardings(restored, mesh), mesh,
                           from_full)
        b = batch(cfg)
        b = distribute(b, batch_shardings(cfg, mesh, b), mesh, from_full)
        sharded = [t for t in state.params.values()
                   if isinstance(t, DTensor) and any(
                       p.is_shard() for p in t.placements)]
        assert sharded, "no param was sharded"
        comm = CommDebugMode()
        sharding.set_mesh(mesh)
        try:
            with comm, implicit_replication():
                state, metrics = S.build_train_step(cfg, TC)(state, b)
        finally:
            sharding.set_mesh(None)
        whole = {k: v.full_tensor() if isinstance(v, DTensor) else v
                 for k, v in (*metrics.items(), *_flat(state.params))}
        loss = float(whole["loss"])
        losses = [None] * world
        dist.all_gather_object(losses, loss)
        ref = float(one["loss"])
        assert math.isfinite(loss) and len(set(losses)) == 1, losses
        assert abs(loss - ref) <= LOSS_RTOL * abs(ref), (loss, ref)
        gn, gn1 = float(whole["grad_norm"]), float(one["grad_norm"])
        assert abs(gn - gn1) <= LOSS_RTOL * abs(gn1), (gn, gn1)
        off = {k: float((whole[k] - v).abs().max())
               for k, v in _flat(one_state.params)}
        assert max(off.values()) <= PARAM_ATOL, off
        assert comm.get_total_counts() > 0
        dist.barrier()
        if rank == 0:
            print(f"ELASTIC_OK {loss!r} {ref!r} {comm.get_total_counts()} "
                  f"{abs(gn - gn1) / abs(gn1)!r} {max(off.values())!r}",
                  flush=True)
    finally:
        sharding.set_ep2d(False)
        dist.destroy_process_group()


if __name__ == "__main__":
    import torch.multiprocessing as mp
    mp.spawn(_rank_main, args=(int(sys.argv[1]), sys.argv[2], sys.argv[3],
                               sys.argv[4] if len(sys.argv) > 4
                               else "phi3-mini-3.8b"),
             nprocs=int(sys.argv[1]))
