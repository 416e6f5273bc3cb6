"""Process-group bootstrap: the config surface -> torch.distributed.

Port of lightgbm_tpu/distributed/bootstrap.py. The reference's cluster
bring-up (reference: src/network/linkers_socket.cpp:80 -- rank = index of
the local address in the ``machines`` list, a full-mesh TCP handshake)
maps onto ``torch.distributed.init_process_group``: entry 0 of the
machine list (or ``coordinator``) hosts the rendezvous store, every
process dials it (``tcp://host:port``), and one process drives one
device. The collectives themselves are parallel/network.py's.

Backends: CPU tensors go to gloo; CUDA tensors to NCCL
(``cpu:gloo,cuda:nccl``) when every rank on this host has a card of its
own. Every rank posts its host name to the rendezvous store first; where
this host runs more ranks than it has cards (several ranks on one card,
which NCCL refuses), gloo serves CUDA tensors too. A process with a card
takes the card of its index among this host's ranks, modulo the card
count, as its current device.

Env-var overrides (launchers set these instead of editing configs):

* ``LGBM_TPU_COORDINATOR``   -- ``host:port`` of the rendezvous (rank 0)
* ``LGBM_TPU_NUM_PROCESSES`` -- world size
* ``LGBM_TPU_PROCESS_ID``    -- this process's rank

The supervised bring-up of the JAX package (``dist_heartbeat_ms > 0``,
distributed/supervisor.py) is not ported: asking for it raises.
"""
from __future__ import annotations

import os
from typing import Optional

from ..utils import log
from ..utils.log import LightGBMError

_state = {"initialized": False, "num_processes": 1, "rank": 0,
          "cuda_backend": None}
# weak references to callables run before the group is destroyed: a
# learner whose CUDA graphs hold NCCL collectives frees them there (NCCL
# keeps a captured collective's resources until its graph is destroyed,
# and destroying the communicator waits for them)
_before_shutdown = []


def before_shutdown(method) -> None:
    """Run the bound `method` (held weakly) before the group is
    destroyed."""
    import weakref
    _before_shutdown.append(weakref.WeakMethod(method))


def _local_ranks(store, num_processes: int, process_id: int) -> tuple:
    """(the ranks on this host, this process's index among them), from
    the host names every rank posts to the rendezvous store."""
    import socket
    store.set("lgbm_host/%d" % process_id, socket.gethostname())
    hosts = [store.get("lgbm_host/%d" % r).decode()
             for r in range(num_processes)]
    here = [r for r, h in enumerate(hosts) if h == hosts[process_id]]
    return len(here), here.index(process_id)


def _backend_spec(local_ranks: int) -> tuple:
    """(init_process_group backend string, backend of CUDA tensors) for
    `local_ranks` ranks on this host: NCCL while each has a card of its
    own, else gloo for CUDA tensors too."""
    import torch
    if not torch.cuda.is_available():
        return "gloo", None
    if local_ranks <= torch.cuda.device_count():
        return "cpu:gloo,cuda:nccl", "nccl"
    return "gloo", "gloo"


def resolve_rank(entries, explicit_rank: int = -1,
                 local_port: int = 0) -> Optional[int]:
    """Rank of this host in the machine list. ``machine_rank >= 0``
    short-circuits hostname detection (containers often don't resolve
    their external address). With `local_port`, an entry naming this host
    AND that port wins first (the reference's ``local_listen_port``
    disambiguation of several processes on one host,
    linkers_socket.cpp:80)."""
    if explicit_rank >= 0:
        return explicit_rank
    import socket
    my_names = {socket.gethostname(), "localhost", "127.0.0.1"}
    try:
        my_names.add(socket.gethostbyname(socket.gethostname()))
    except OSError:
        pass
    if local_port:
        for i, e in enumerate(entries):
            host, _, port = e.partition(":")
            if host in my_names and port == str(local_port):
                return i
    for i, e in enumerate(entries):
        if e.split(":")[0] in my_names:
            return i
    return None


def _refuse_supervised() -> None:
    raise LightGBMError(
        "the supervised bring-up (dist_heartbeat_ms > 0, "
        "LGBM_TPU_SUPERVISE=1) is not supported by lightgbm_tpu_torch yet "
        "(ROADMAP.md section 1, item 5: distributed/supervisor.py)")


def initialize(coordinator_address: str, num_processes: int,
               process_id: int, supervise: bool = False) -> None:
    """Join the process group (idempotent): ``tcp://coordinator_address``
    rendezvous, world size `num_processes`, rank `process_id`. Joining
    runs through faults.run_collective (the collective deadline and the
    retry of transient failures, as every host collective)."""
    if _state["initialized"]:
        return
    if supervise or os.environ.get("LGBM_TPU_SUPERVISE", "") == "1":
        _refuse_supervised()
    import torch
    import torch.distributed as dist
    from ..resilience import faults
    from ..telemetry import counters, spans
    from torch.distributed.constants import default_pg_timeout
    n, pid = int(num_processes), int(process_id)
    host, _, port = coordinator_address.rpartition(":")

    def join():
        store = dist.TCPStore(host, int(port), n, is_master=pid == 0,
                              timeout=default_pg_timeout)
        local_n, local_idx = _local_ranks(store, n, pid)
        backend, cuda_backend = _backend_spec(local_n)
        if cuda_backend is not None:
            torch.cuda.set_device(local_idx % torch.cuda.device_count())
        dist.init_process_group(backend=backend, store=store, world_size=n,
                                rank=pid)
        return backend, cuda_backend
    backend, cuda_backend = faults.run_collective(join, site="bootstrap")
    _state.update(initialized=True, num_processes=n, rank=pid,
                  cuda_backend=cuda_backend)
    counters.set_gauge("dist_process_count", int(num_processes))
    counters.set_gauge("dist_rank", int(process_id))
    spans.set_pid(int(process_id))
    log.info("torch.distributed initialized (%s): rank %d of %d "
             "(coordinator %s)", backend, process_id, num_processes,
             coordinator_address)


def initialize_from_env() -> bool:
    """Bring-up purely from LGBM_TPU_* env vars. Returns True if the
    trio was present and the group was joined."""
    coord = os.environ.get("LGBM_TPU_COORDINATOR", "").strip()
    nproc = os.environ.get("LGBM_TPU_NUM_PROCESSES", "").strip()
    pid = os.environ.get("LGBM_TPU_PROCESS_ID", "").strip()
    if not (coord and nproc and pid):
        return False
    initialize(coord, int(nproc), int(pid))
    return True


def initialize_from_config(machines="", local_listen_port: int = 12400,
                           num_machines: int = 1, machine_rank: int = -1,
                           coordinator: str = "",
                           supervise: bool = False) -> None:
    """The reference's config surface -> process group. Precedence:
    env-var trio > explicit ``coordinator`` + ``machine_rank`` >
    ``machines`` list with hostname rank detection. One machine joins
    nothing."""
    if _state["initialized"]:
        return
    if supervise:
        _refuse_supervised()
    if initialize_from_env():
        return
    if coordinator and num_machines > 1:
        if machine_rank < 0:
            log.fatal("coordinator=%s requires machine_rank>=0 "
                      "(hostname detection needs the machines list)",
                      coordinator)
        initialize(coordinator, num_machines, machine_rank)
        return
    if isinstance(machines, (list, tuple)):
        machines = ",".join(machines)
    entries = [m.strip() for m in str(machines).split(",") if m.strip()]
    if len(entries) <= 1:
        return                       # single machine: nothing to join
    rank_ = resolve_rank(entries, machine_rank, local_listen_port)
    if rank_ is None:
        log.fatal("Could not find local machine in machine list: %s "
                  "(set machine_rank=<idx> to override)", machines)
    initialize(entries[0], len(entries), rank_)


def _external_group():
    """(world size, rank) of a process group brought up outside this
    module (a harness calling init_process_group directly), or None."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return None


def is_distributed() -> bool:
    """True once a process group of more than one process is up."""
    return process_count() > 1


def is_initialized() -> bool:
    """True while a process group (of any size) is up."""
    return _state["initialized"] or _external_group() is not None


def process_count() -> int:
    if _state["initialized"]:
        return _state["num_processes"]
    ext = _external_group()
    return ext[0] if ext else 1


def rank() -> int:
    if _state["initialized"]:
        return _state["rank"]
    ext = _external_group()
    return ext[1] if ext else 0


def cuda_backend() -> Optional[str]:
    """The backend that carries CUDA tensors' collectives: 'nccl',
    'gloo' or None (no card, or no group)."""
    if _state["initialized"]:
        return _state["cuda_backend"]
    ext = _external_group()
    if ext is None:
        return None
    import torch.distributed as dist
    spec = str(dist.get_backend())
    return "nccl" if "nccl" in spec else "gloo"


def host_device() -> str:
    """The device of host-bytes traffic: 'cpu' unless a group brought up
    outside this module runs NCCL alone."""
    if _state["initialized"] or _external_group() is None:
        return "cpu"
    import torch.distributed as dist
    return "cuda" if str(dist.get_backend()) == "nccl" else "cpu"


def barrier(name: str = "lgbm_tpu_barrier") -> None:
    """Cross-process rendezvous; a no-op in one process."""
    if not is_distributed():
        return
    import torch.distributed as dist
    from ..resilience import faults
    faults.run_collective(dist.barrier, site="barrier:%s" % name)


def shutdown() -> None:
    """Leave the process group (no-op when this module did not join
    one)."""
    while _before_shutdown:
        method = _before_shutdown.pop()()
        if method is not None:
            method()
    if _state["initialized"]:
        import torch.distributed as dist
        try:
            # teardown must not retry or respect the collective deadline:
            # by here peers may already be gone
            dist.destroy_process_group()
        except Exception:  # pragma: no cover - already torn down
            pass
    _state.update(initialized=False, num_processes=1, rank=0,
                  cuda_backend=None)
