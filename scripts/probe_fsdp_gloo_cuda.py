"""Which FSDP2 collectives run over gloo with CUDA tensors?

Two ranks share one card over a gloo process group (a FileStore
rendezvous), shard a small MLP with ``fully_shard`` on a 1-D mesh, run one
forward, one backward and one optimizer step, gather a sharded gradient
with plain ``dist.all_gather`` (as ``act3d_tpu_torch.parallel.mesh._full``
does), and last with ``DTensor.full_tensor()``.  Prints each rank's
progress and the ranks' exit codes.  On torch 2.11 on an H100 everything
up to the plain gather completes, and ``full_tensor()``'s functional
collectives kill both ranks (SIGSEGV): which is why the port gathers and
shards DTensors with plain collectives.  Run on a machine with a card:

    python3 scripts/probe_fsdp_gloo_cuda.py
"""

from __future__ import annotations

import datetime
import faulthandler
import multiprocessing as mp
import os
import sys
import tempfile


def rank_main(rank: int, world: int, store_path: str) -> None:
    import torch
    import torch.distributed as dist
    import torch.nn as nn
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.fsdp import fully_shard

    faulthandler.dump_traceback_later(60, exit=True)
    dist.init_process_group("gloo", store=dist.FileStore(store_path, world), rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=30))
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.manual_seed(1)
    model = nn.Sequential(nn.Linear(16, 32), nn.Tanh(), nn.Linear(32, 4)).to(dev)
    fully_shard(model, mesh=init_device_mesh("cuda", (world,)))
    opt = torch.optim.AdamW(model.parameters())

    def done(what):
        torch.cuda.synchronize()
        print(f"rank {rank}: {what} done", flush=True)

    out = model(torch.randn(4, 16, device=dev))
    done("forward")
    out.sum().backward()
    done("backward")
    opt.step()
    done("optimizer step")
    grad = model[0].weight.grad.to_local().contiguous()
    parts = [torch.empty_like(grad) for _ in range(world)]
    dist.all_gather(parts, grad)
    done("dist.all_gather of the gradient shards")
    model[0].weight.grad.full_tensor()
    done("DTensor.full_tensor")
    dist.destroy_process_group()


def main() -> int:
    import torch

    world = 2
    store = tempfile.mktemp(prefix="fsdp_gloo_store_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=rank_main, args=(r, world, store)) for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(120)
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    print(f"torch {torch.__version__}: FSDP2 over gloo with CUDA tensors, {world} ranks on "
          f"one card: exit codes {codes} ({'ok' if codes == [0] * world else 'failed'})")
    if os.path.exists(store):
        os.remove(store)
    return 0


if __name__ == "__main__":
    sys.exit(main())
