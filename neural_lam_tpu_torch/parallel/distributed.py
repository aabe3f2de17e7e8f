"""Multi-process initialisation over torch.distributed.

Counterpart of neural_lam_tpu/parallel/distributed.py. The JAX package
runs one process per host, which drives every local device through one
('data', 'space') mesh. The port runs one process per device: a world of
`num_processes` ranks meeting at `coordinator_address` (host:port, a TCP
store that rank 0 serves), rank r on `cuda:{r % device_count}` (or the
CPU). `mesh.make_mesh` lays the world out as n_data x n_space ranks:
each `space` group is n_space consecutive ranks that run one model on one
batch (the grid scheme, `grid_sharded.py`), and each `data` group takes
the ranks of one space index across the space groups, which read
disjoint batches (`WeatherDataLoader(shard=(n_data, data_index))`) and
average their gradients.

The backend is the caller's choice and never switched silently: "nccl"
for CUDA devices, "gloo" for the CPU. NCCL refuses two ranks on one
card, so ranks that share a card (a one-card machine) ask for "gloo",
which takes CUDA tensors and stages them through host memory; NCCL with
two ranks on one card raises before its first collective. Host-side
merges (evaluation sums, logged losses, checkpoint decisions) go over a
gloo group of their own whatever the backend.
"""

from __future__ import annotations

import dataclasses
import datetime

import numpy as np
import torch
import torch.distributed as dist

# seconds a rank waits for the others (to join, or in a collective)
# before it fails with an error
DEFAULT_TIMEOUT_S = 300


@dataclasses.dataclass
class World:
    """This process's place in the world of ranks."""

    rank: int
    size: int
    backend: str
    device: torch.device
    host_group: object  # gloo over every rank, for host-side merges


_WORLD: World | None = None


def world() -> World | None:
    """The world `init_multihost` joined, or None in a single process."""
    return _WORLD


def default_backend(device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(rank: int, device="cuda") -> torch.device:
    """The device rank `rank` takes: cuda:{rank % device_count}, or the
    CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    from ..device import resolve_device

    resolve_device("cuda")
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_multihost(coordinator_address=None, num_processes=None,
                   process_id=None, backend=None, device="cuda",
                   timeout_s=DEFAULT_TIMEOUT_S):
    """Join the world of `num_processes` ranks as rank `process_id`, at
    `coordinator_address` ("host:port"; rank 0 serves the store there).
    A single process without an address is no world: (0, 1). `backend`
    defaults to the device's ("nccl" on CUDA, "gloo" on the CPU). A rank
    that cannot join within `timeout_s`, or later waits longer than that
    in a collective, fails with an error. Returns (rank, world size)."""
    global _WORLD
    if not (num_processes is not None and num_processes > 1
            or coordinator_address is not None):
        return 0, 1
    if _WORLD is not None:
        raise RuntimeError("init_multihost: this process already joined a "
                           "world")
    num_processes = int(num_processes or 1)
    if process_id is None:
        if num_processes > 1:
            raise ValueError("init_multihost: a world of several processes "
                             "needs each process's rank (--node_rank)")
        process_id = 0
    if coordinator_address is None:
        raise ValueError("init_multihost: a world of several processes "
                         "needs --coordinator_address host:port")
    backend = backend or default_backend(device)
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: 'nccl' or 'gloo'")
    dev = rank_device(process_id, device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs CUDA devices; the CPU "
                         "takes gloo")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    host, _, port = coordinator_address.rpartition(":")
    timeout = datetime.timedelta(seconds=timeout_s)
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{host}:{int(port)}",
        world_size=num_processes, rank=int(process_id), timeout=timeout)
    host_group = (dist.group.WORLD if backend == "gloo"
                  else dist.new_group(backend="gloo", timeout=timeout))
    _WORLD = World(rank=dist.get_rank(), size=dist.get_world_size(),
                   backend=backend, device=dev, host_group=host_group)
    if backend == "nccl":
        _check_distinct_cards(dev)
    return _WORLD.rank, _WORLD.size


def _check_distinct_cards(dev):
    """NCCL takes one rank a card: raise, on every rank, when two ranks
    of the world sit on the same card (the same UUID)."""
    uuid = str(torch.cuda.get_device_properties(dev).uuid)
    cards = [None] * _WORLD.size
    dist.all_gather_object(cards, uuid, group=_WORLD.host_group)
    if len(set(cards)) < len(cards):
        raise RuntimeError(
            "the nccl backend takes one rank a card, and ranks "
            f"{[r for r, c in enumerate(cards) if cards.count(c) > 1]} "
            "share one: pass the gloo backend (--dist_backend gloo) to "
            "run several ranks on one card")


def shutdown():
    """Leave the world (a no-op in a single process)."""
    global _WORLD
    if _WORLD is not None:
        from . import mesh

        mesh._MESHES.clear()  # their groups die with the world
        dist.destroy_process_group()
        _WORLD = None


def is_multiprocess() -> bool:
    return _WORLD is not None and _WORLD.size > 1


def _host_reduce(arr: np.ndarray, group) -> np.ndarray:
    arr = np.asarray(arr, np.float64)
    t = torch.from_numpy(arr.reshape(-1).copy())
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
    return t.numpy().reshape(arr.shape)


def psum_across_hosts(tree, mesh):
    """Element-wise sum of a dict of numpy arrays over the data group
    (each data group reduced a disjoint shard of the evaluation set, and
    every rank of a space group holds the same sums). Single process:
    identity. float64 on the host, over gloo."""
    if not is_multiprocess() or mesh.n_data == 1:
        return tree
    return {k: _host_reduce(np.asarray(v), mesh.host_data_group)
            for k, v in tree.items()}


def mean_across_data(value: float, mesh) -> float:
    """A float averaged over the data groups (a logged training loss:
    each data group's is the mean over its own rows)."""
    if not is_multiprocess() or mesh.n_data == 1:
        return float(value)
    return float(_host_reduce(np.asarray([value]),
                              mesh.host_data_group)[0]) / mesh.n_data


def broadcast_object(obj, src: int = 0):
    """`obj` of rank `src` on every rank (identity in a single process)."""
    if not is_multiprocess():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=_WORLD.host_group)
    return box[0]


def barrier():
    if is_multiprocess():
        dist.barrier(group=_WORLD.host_group)
