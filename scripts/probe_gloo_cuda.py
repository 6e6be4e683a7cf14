"""Which collectives gloo takes on CUDA tensors, with two ranks on one card.

DTensor's redistributions issue `all_gather_into_tensor`,
`reduce_scatter_tensor` and `all_to_all_single`; NCCL refuses two ranks on
one device. This spawns two gloo ranks on cuda:0 and tries each collective
on a small CUDA tensor, then one DTensor redistribution of each kind
(Shard to Replicate, Partial to Shard, Shard(0) to Shard(1)), and prints
one JSON line: for each, "ok" or the error's first line.

    python3 scripts/probe_gloo_cuda.py [name ...]
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def _try(fn) -> str:
    try:
        fn()
        torch.cuda.synchronize()
        return "ok"
    except Exception as e:  # noqa: BLE001 -- the answer is the error
        return f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"


def _ops(dev, rank: int, n: int) -> dict:
    """Each probe: a function that issues one collective on cuda:0."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)

    import torch.distributed._functional_collectives as fc

    x = torch.arange(8, dtype=torch.float32, device=dev) + rank
    full = torch.arange(64, dtype=torch.float32, device=dev).reshape(8, 8)

    def mesh():
        return DeviceMesh("cuda", list(range(n)), mesh_dim_names=("data",))
    return {
        "all_reduce": lambda: dist.all_reduce(x.clone()),
        "broadcast": lambda: dist.broadcast(x.clone(), src=0),
        "all_gather": lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(n)], x),
        "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
            torch.empty(8 * n, device=dev), x),
        "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
            torch.empty(8 // n, device=dev), x),
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty_like(x), x),
        "functional_all_gather": lambda: fc.all_gather_tensor(
            x, 0, dist.group.WORLD).wait(),
        "functional_reduce_scatter": lambda: fc.reduce_scatter_tensor(
            x, "sum", 0, dist.group.WORLD).wait(),
        "dtensor_distribute_local": lambda: distribute_tensor(
            full, mesh(), [Shard(0)], src_data_rank=None).to_local(),
        "dtensor_from_local_shard_to_replicate": lambda: DTensor.from_local(
            full, mesh(), [Shard(0)]).redistribute(
                mesh(), [Replicate()]).to_local(),
        "dtensor_shard_to_replicate": lambda: distribute_tensor(
            full, mesh(), [Shard(0)]).redistribute(
                mesh(), [Replicate()]).to_local(),
        "dtensor_partial_to_shard": lambda: DTensor.from_local(
            full, mesh(), [Partial()]).redistribute(
                mesh(), [Shard(0)]).to_local(),
        "dtensor_shard0_to_shard1": lambda: distribute_tensor(
            full, mesh(), [Shard(0)]).redistribute(
                mesh(), [Shard(1)]).to_local(),
    }


def _rank(rank: int, n: int, store: str, out: str, name: str) -> None:
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", store=dist.FileStore(store, n),
                            rank=rank, world_size=n,
                            timeout=datetime.timedelta(seconds=60))
    res = _try(_ops(torch.device("cuda", 0), rank, n)[name])
    if rank == 0:
        with open(out, "w") as f:
            json.dump(res, f)
    dist.destroy_process_group()


NAMES = ("all_reduce", "broadcast", "all_gather", "all_gather_into_tensor",
         "reduce_scatter_tensor", "all_to_all_single",
         "functional_all_gather", "functional_reduce_scatter",
         "dtensor_distribute_local", "dtensor_from_local_shard_to_replicate",
         "dtensor_shard_to_replicate", "dtensor_partial_to_shard",
         "dtensor_shard0_to_shard1")


def probe_one(name: str, n: int = 2) -> str:
    """One collective on `n` fresh gloo ranks on cuda:0: "ok", the
    error's first line, or how a rank died (a crash ends only its run)."""
    tmp = tempfile.mkdtemp(prefix="gloo_probe_")
    store, out = os.path.join(tmp, "store"), os.path.join(tmp, "out.json")
    try:
        mp.start_processes(_rank, args=(n, store, out, name), nprocs=n,
                           join=True, start_method="spawn")
    except Exception as e:  # noqa: BLE001 -- a rank's death is the answer
        return f"rank died: {type(e).__name__}: {str(e).splitlines()[0]}"
    with open(out) as f:
        return json.load(f)


def probe(n: int = 2, names=NAMES) -> dict:
    """Each collective's result on `n` gloo ranks on cuda:0."""
    res = {}
    for name in names:
        res[name] = probe_one(name, n)
        print(f"{name}: {res[name]}", flush=True)
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    res = probe(names=sys.argv[1:] or NAMES)
    print(json.dumps({"torch": torch.__version__,
                      "device": torch.cuda.get_device_name(0),
                      "gloo_cuda": res}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
