"""The elastic re-mesh's world of ranks, for ``tests/test_torch_launch.py``
(the port's counterpart of ``tests/test_elastic.py``): run as a script,
it spawns ``world`` gloo ranks that restore a checkpoint written by one
rank into the shardspecs' placements on a (2, 2) mesh and step again.

  python tests/_torch_elastic.py WORLD CKPT_DIR STORE_FILE

Rank 0 prints ``ELASTIC_OK <sharded loss> <one-rank loss> <collectives>``
once every rank's checks hold and their losses agree.
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

CFG = smoke_config("phi3-mini-3.8b")
TC = TrainConfig(lr=1e-3)
SHAPE = ShapeConfig("t", 32, 8, "train")
#: the sharded step's loss against the one-rank step's, relative: the
#: same f32 products summed over other splits (measured: 9e-8)
LOSS_RTOL = 1e-5


def batch() -> dict:
    return {k: torch.as_tensor(v)
            for k, v in make_batch(CFG, SHAPE, device="cpu").items()}


def from_full(t, ns, mesh):
    """The same full tensor on every rank -> a ``DTensor`` with the
    sharding's placements (each rank keeps its own block: no message)."""
    from torch.distributed.tensor import DTensor, Replicate
    full = DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)
    return full.redistribute(mesh, ns.placements)


def _rank_main(rank, world, ckpt_dir, store):
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.dryrun import distribute
    from repro_torch.launch.shardspecs import batch_shardings, state_shardings
    from repro_torch.models import sharding

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=120))
    try:
        template = S.init_state(CFG, TC, torch.Generator().manual_seed(1),
                                device="cpu")
        restored, manifest = ckpt.restore(ckpt_dir, template)
        assert manifest["step"] == 1, manifest
        _, one = S.build_train_step(CFG, TC)(restored, batch())
        restored, _ = ckpt.restore(ckpt_dir, template)
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        state = distribute(restored, state_shardings(restored, mesh), mesh,
                           from_full)
        b = batch()
        b = distribute(b, batch_shardings(CFG, mesh, b), mesh, from_full)
        sharded = [t for t in state.params.values()
                   if isinstance(t, DTensor) and any(
                       p.is_shard() for p in t.placements)]
        assert sharded, "no param was sharded"
        comm = CommDebugMode()
        sharding.set_mesh(mesh)
        try:
            with comm, implicit_replication():
                _, metrics = S.build_train_step(CFG, TC)(state, b)
        finally:
            sharding.set_mesh(None)
        loss = metrics["loss"]
        loss = float(loss.full_tensor() if isinstance(loss, DTensor)
                     else loss)
        losses = [None] * world
        dist.all_gather_object(losses, loss)
        ref = float(one["loss"])
        assert math.isfinite(loss) and len(set(losses)) == 1, losses
        assert abs(loss - ref) <= LOSS_RTOL * abs(ref), (loss, ref)
        assert comm.get_total_counts() > 0
        dist.barrier()
        if rank == 0:
            print(f"ELASTIC_OK {loss!r} {ref!r} {comm.get_total_counts()}",
                  flush=True)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    import torch.multiprocessing as mp
    mp.spawn(_rank_main, args=(int(sys.argv[1]), sys.argv[2], sys.argv[3]),
             nprocs=int(sys.argv[1]))
