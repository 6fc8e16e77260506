"""Mesh construction and the solver's view of it (the port's counterpart
of ``repro.launch.mesh``).

``make_mesh`` builds a ``DeviceMesh`` over an initialised process group:
NCCL on the card, one rank a card; gloo on the CPU.  ``init_distributed``
brings the group up (from torchrun's environment, or from explicit
arguments) and ``spawn`` starts ``world`` local ranks of a function for
the CPU runs and the tests.  Axis order is slowest-interconnect-first —
the paper's §5.1 placement rule: the k-cut solver assigns its first
(highest-weight) cut to the slowest tier."""
from __future__ import annotations

import math
import os
import socket
from typing import Callable, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ..core.solver import MeshAxis

# The solver's link rates for an H100 SXM host, from NVIDIA's H100
# datasheet, https://www.nvidia.com/en-us/data-center/h100/.  Published
# figures, not measured: they wait for a machine with more than one card.
NVLINK_BW = 900e9            # NVLink 4, bytes/s per card (all 18 links)
# NDR InfiniBand, 400 Gb/s = 50 GB/s per card (one ConnectX-7 port a card
# in a DGX H100: https://docs.nvidia.com/dgx/dgxh100-user-guide/
# introduction-to-dgxh100.html).  Published, not measured.
IB_BW = 50e9
CARDS_PER_HOST = 8           # an HGX / DGX H100 host


def free_port() -> int:
    """A free TCP port on localhost for a process group's store."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def init_distributed(device_type: str, rank: Optional[int] = None,
                     world: Optional[int] = None,
                     port: Optional[int] = None) -> Tuple[int, int]:
    """Initialise the default process group, once, and return (rank,
    world).  Without arguments it reads torchrun's ``RANK`` /
    ``WORLD_SIZE`` / ``MASTER_ADDR`` / ``MASTER_PORT``; a single process
    with none of them set becomes rank 0 of a world of 1 on a free port.
    On the card each rank takes card ``LOCAL_RANK`` (or its rank)."""
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    env = os.environ
    rank = int(env.get("RANK", 0)) if rank is None else rank
    world = int(env.get("WORLD_SIZE", 1)) if world is None else world
    if port is None:
        port = int(env["MASTER_PORT"]) if "MASTER_PORT" in env \
            else free_port()
    addr = env.get("MASTER_ADDR", "127.0.0.1")
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device_type='cuda' was requested but "
                "torch.cuda.is_available() is False")
        torch.cuda.set_device(int(env.get("LOCAL_RANK", rank)))
    dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                            init_method=f"tcp://{addr}:{port}",
                            rank=rank, world_size=world)
    return rank, world


def make_mesh(shape: Sequence[int] = (1, 1),
              names: Sequence[str] = ("data", "model"),
              device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``shape`` with dims ``names`` over the default
    process group (``init_distributed`` first), ranks laid out row-major
    as ``init_device_mesh`` lays them."""
    from torch.distributed.device_mesh import init_device_mesh
    n = 1
    for s in shape:
        n *= s
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(init_distributed, torchrun or spawn)")
    if dist.get_world_size() != n:
        raise ValueError(f"mesh {tuple(shape)} needs {n} ranks, the group "
                         f"has {dist.get_world_size()}")
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def solver_axes(shape: Sequence[int] = (16, 16),
                names: Sequence[str] = ("data", "model")) -> List[MeshAxis]:
    """MeshAxis list for the tiling solver, slowest first, with per-axis
    bandwidths: every axis of a one-host mesh rides NVLink (an axis across
    hosts waits for a multi-host mesh)."""
    axes = [MeshAxis(str(n), int(s), NVLINK_BW)
            for n, s in zip(names, shape)]
    return sorted(axes, key=lambda a: a.bandwidth)


def production_shape(multi_pod: bool = False
                     ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """repro's production meshes: (16, 16) ("data", "model"), 256 cards,
    or (2, 16, 16) ("pod", "data", "model"), 512."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def axis_bandwidth(shape: Sequence[int], dim: int) -> float:
    """The ring rate of mesh dim ``dim`` of a row-major rank layout on
    hosts of ``CARDS_PER_HOST`` cards: NVLink when the group of rank 0
    along that dim lies in one host, InfiniBand when it spans hosts (its
    ring then crosses a host link at the NIC's rate)."""
    stride = math.prod(shape[dim + 1:])
    group = [i * stride for i in range(shape[dim])]
    hosts = {r // CARDS_PER_HOST for r in group}
    return NVLINK_BW if len(hosts) == 1 else IB_BW


def production_axes(multi_pod: bool = False) -> List[MeshAxis]:
    """The solver's axes of a production mesh (repro's ``solver_axes``
    for its production meshes), slowest first, each at
    ``axis_bandwidth``'s rate.  On 8-card hosts every axis crosses hosts:
    "model" (16 consecutive ranks) spans 2 hosts, "data" (stride 16) 16
    hosts and "pod" (stride 256) the two pods, so every axis rides
    InfiniBand at 50 GB/s a card."""
    shape, names = production_shape(multi_pod)
    axes = [MeshAxis(n, s, axis_bandwidth(shape, i))
            for i, (n, s) in enumerate(zip(names, shape))]
    return sorted(axes, key=lambda a: a.bandwidth)


def make_production_mesh(multi_pod: bool = False):
    """A ``DeviceMesh`` of a production shape over torch's *fake* process
    group, as this process's default group: rank 0 of a world of 256
    (512) that exists nowhere, so DTensors of meta shards can be traced
    under a plan and no rank runs (``analysis/cost_trace``).  The caller
    tears the group down (``dist.destroy_process_group``); a process
    that holds another default group cannot make one."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    shape, names = production_shape(multi_pod)
    if dist.is_initialized():
        raise RuntimeError("make_production_mesh needs a process without a "
                           "default process group (it makes a fake one)")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    return init_device_mesh("cpu", shape, mesh_dim_names=names)


def mesh_to_solver_axes(mesh) -> List[MeshAxis]:
    """MeshAxis list mirroring an existing ``DeviceMesh``, slowest first
    (§5.1) whatever the mesh's own axis order — safe, since plans are
    keyed by axis *name*."""
    return solver_axes(tuple(mesh.mesh.shape), mesh.mesh_dim_names)


def _spawned(rank: int, fn: Callable, world: int, device_type: str,
             port: int, args: tuple) -> None:
    if device_type == "cpu":
        # CPU ranks share the host's cores: one intra-op thread each, so
        # that world ranks never ask for more threads than the host has
        torch.set_num_threads(1)
    init_distributed(device_type, rank, world, port)
    try:
        fn(rank, world, *args)
        # every rank done before any tears its group down (a gloo rank
        # whose peer had gone aborted at exit now and then)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, device_type: str = "cpu",
          args: tuple = ()) -> None:
    """Run ``fn(rank, world, *args)`` on ``world`` local processes, each
    with the default group initialised (gloo on the CPU, NCCL on the
    cards) and torn down after; a CPU rank runs torch on one intra-op
    thread.  ``fn`` must be importable (module
    level), as ``torch.multiprocessing.spawn`` pickles it."""
    import torch.multiprocessing as mp
    mp.spawn(_spawned, args=(fn, world, device_type, free_port(), args),
             nprocs=world, join=True)
