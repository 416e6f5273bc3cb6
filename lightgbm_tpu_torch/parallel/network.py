"""The network layer: the reference's bootstrap surface and the
collectives the data-parallel learner and the distributed loader run.

Port of lightgbm_tpu/parallel/network.py. The JAX package needs no
userspace collectives (they are XLA ops inside its programs); the port
runs them on torch.distributed (reference: src/network/network.cpp
Allreduce / ReduceScatter / Allgather): NCCL carries CUDA tensors, gloo
CPU tensors (distributed/bootstrap.py picks them). Every collective adds
one to ``collectives`` and its payload bytes to ``collective_bytes`` where
it is issued; the learner's split loop takes a captured step's counts back
and adds them per replay, as it does for the kernels' launches.

``init_external`` records an identity injected by a host that owns the
process group (LGBM_NetworkInitWithFunctions), as the JAX package does.
"""
from __future__ import annotations

from typing import List

import numpy as np
import torch

from ..distributed import bootstrap
from ..utils import log

_external = {"set": False, "num_machines": 1, "rank": 0}

# collectives issued (a captured step's per replay) and their bytes
collectives = 0
collective_bytes = 0


def init_from_params(machines, local_listen_port: int = 12400,
                     num_machines: int = 1, machine_rank: int = -1,
                     coordinator: str = "", supervise: bool = False) -> None:
    """machines='ip1:port1,ip2:port2,...' -> init_process_group. Rank =
    `machine_rank` when >= 0, else the index of our address in the
    machine list (linkers_socket.cpp:80); the rendezvous is entry 0 unless
    `coordinator` names it. The env trio LGBM_TPU_COORDINATOR /
    NUM_PROCESSES / PROCESS_ID wins over all of it. ``supervise`` (from
    dist_heartbeat_ms > 0) raises: the supervised bring-up is a later
    slice's."""
    bootstrap.initialize_from_config(
        machines, local_listen_port=local_listen_port,
        num_machines=num_machines, machine_rank=machine_rank,
        coordinator=coordinator, supervise=supervise)


def num_machines() -> int:
    if _external["set"]:
        return _external["num_machines"]
    return bootstrap.process_count()


def rank() -> int:
    if _external["set"]:
        return _external["rank"]
    return bootstrap.rank()


def init_external(num_machines: int, rank: int) -> None:
    """reference: LGBM_NetworkInitWithFunctions (c_api.h:1018): a host
    like Spark or Dask injects collectives; only the (num_machines, rank)
    identity is recorded, for the host-side coordination paths."""
    _external["set"] = True
    _external["num_machines"] = int(num_machines)
    _external["rank"] = int(rank)
    log.info("Network initialized externally: rank %d/%d", rank,
             num_machines)


def free() -> None:
    _external["set"] = False
    _external["num_machines"] = 1
    _external["rank"] = 0
    bootstrap.shutdown()


def _count(t: torch.Tensor) -> None:
    global collectives, collective_bytes
    collectives += 1
    collective_bytes += t.numel() * t.element_size()


def _gloo_for(t: torch.Tensor) -> bool:
    """Whether gloo carries `t`'s collectives (no reduce-scatter there)."""
    return t.device.type != "cuda" or bootstrap.cuda_backend() == "gloo"


def all_reduce(t: torch.Tensor) -> torch.Tensor:
    """Sum `t` over the ranks, in place; returns it."""
    import torch.distributed as dist
    _count(t)
    dist.all_reduce(t, op=dist.ReduceOp.SUM)
    return t


def reduce_scatter(t: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """The sum over the ranks of `t`, cut along `axis` into W equal blocks
    (the size there must divide by W): this rank's block (reference
    Network::ReduceScatter). NCCL runs reduce_scatter_tensor; on gloo,
    which lacks it, an all-reduce of a copy and this rank's slice, the
    same function."""
    import torch.distributed as dist
    w = bootstrap.process_count()
    r = bootstrap.rank()
    size = t.shape[axis]
    if size % w:
        raise ValueError("reduce_scatter: axis %d of size %d does not divide "
                         "by %d ranks" % (axis, size, w))
    cs = size // w
    if _gloo_for(t):
        full = all_reduce(t.clone())
        return full.narrow(axis, r * cs, cs)
    src = t.movedim(axis, 0).contiguous()
    out = torch.empty((cs,) + tuple(src.shape[1:]), dtype=t.dtype,
                      device=t.device)
    _count(src)
    dist.reduce_scatter_tensor(out, src, op=dist.ReduceOp.SUM)
    return out.movedim(0, axis)


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """(W,) + t.shape: every rank's `t`, in rank order."""
    import torch.distributed as dist
    w = bootstrap.process_count()
    _count(t)
    t = t.contiguous()
    if _gloo_for(t):
        parts = [torch.empty_like(t) for _ in range(w)]
        dist.all_gather(parts, t)
        return torch.stack(parts)
    out = torch.empty((w,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    dist.all_gather_into_tensor(out, t)
    return out


def allgather_host_bytes(payload: bytes) -> List[bytes]:
    """All-gather host bytes of any length (each rank's, in rank order):
    the sizes first, then the payloads zero-padded to the longest, as
    uint8 tensors on the host-bytes device (the role of Network::Allgather
    on serialized mappers, dataset_loader.cpp:697-716). One process:
    [payload]."""
    if bootstrap.process_count() <= 1:
        return [payload]
    dev = torch.device(bootstrap.host_device())
    arr = torch.from_numpy(np.frombuffer(payload, dtype=np.uint8).copy())
    size = torch.tensor([arr.numel()], dtype=torch.int64, device=dev)
    sizes = all_gather(size).view(-1).cpu().numpy()
    padded = torch.zeros(int(sizes.max()), dtype=torch.uint8, device=dev)
    padded[:arr.numel()] = arr.to(dev)
    gathered = all_gather(padded).cpu().numpy()
    return [gathered[i, :int(sizes[i])].tobytes()
            for i in range(len(sizes))]
