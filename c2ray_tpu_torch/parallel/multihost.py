"""Multi-process runtime over torch.distributed: the reference's MPI
bootstrap (mpi.F90:83-178) and rank discipline, the port of
c2ray_tpu/parallel/multihost.py.

One process (rank) per device, SPMD: every rank runs the same driver on
its own share of the sources or of the grid.  Initialization reads the
JAX package's environment, so the same launch lines work:

  C2RAY_COORDINATOR    host:port of rank 0's rendezvous (tcp://host:port)
  C2RAY_NUM_PROCESSES  the world size
  C2RAY_PROCESS_ID     this process's rank (0-based)
  C2RAY_BACKEND        optional: nccl or gloo (default: pick_backend of
                       every rank's device, exchanged at the rendezvous)

With none of them set, init_distributed is a no-op and the run is one
process.  Only rank 0 writes files (is_io_rank), as in the reference
(output.F90:179, sourceprops.F90:154); inputs read on rank 0 reach the
others through broadcast_obj (the reference's rank-0 read + MPI_BCAST).

RankGrid is the (n_src, n_dom) grid of ranks of a layout, built with
init_device_mesh; its collectives (sum and max: all_reduce; gather:
all_gather_into_tensor; ring_exchange: batch_isend_irecv) stand in for
the JAX layouts' psum, all_gather and ppermute.  Under gloo, tensors on a
CUDA device travel through pinned host buffers, and the staged bytes are
counted (gloo's point-to-point and gather calls take CPU tensors).  Nothing falls back quietly: a backend that cannot start
raises.
"""

from __future__ import annotations

import math
import os
import socket
from typing import Any, Optional

import torch
import torch.distributed as dist


def _env_int(name: str) -> Optional[int]:
    val = os.environ.get(name)
    return int(val) if val else None


def device_identity(device: torch.device) -> str:
    """The physical device a rank runs on, named the same in every process
    that uses it, on any host: "cpu", or "cuda:" and the card's UUID (the
    host's name and the device index where the properties have no UUID;
    this names one card twice when CUDA_VISIBLE_DEVICES renumbers them,
    which picks gloo, never a duplicate card under nccl)."""
    if device.type != "cuda":
        return device.type
    uuid = getattr(torch.cuda.get_device_properties(device), "uuid", None)
    if uuid is not None:
        return f"cuda:{uuid}"
    return f"cuda:{socket.gethostname()}:{device.index}"


def pick_backend(devices) -> str:
    """devices: every rank's device_identity, in rank order, from every
    host.  -> nccl when each rank has a CUDA device of its own; gloo on
    the CPU and when ranks share a card (NCCL refuses two ranks on one
    GPU: "Duplicate GPU detected")."""
    devices = list(devices)
    if all(d.startswith("cuda:") for d in devices) \
            and len(set(devices)) == len(devices):
        return "nccl"
    return "gloo"


def rank_device(device=None) -> torch.device:
    """The device of this rank: `device` when given (the tests pass cpu),
    else cuda:{rank % cards} (raises without a card: there is no quiet
    fallback to the CPU)."""
    if device is not None and str(device) != "cuda":
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "this rank found no CUDA device; pass --device cpu (device="
            "'cpu') to run the layouts on the CPU")
    rank = _env_int("C2RAY_PROCESS_ID") or 0
    return torch.device(f"cuda:{rank % torch.cuda.device_count()}")


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     device=None, backend: Optional[str] = None) -> bool:
    """Join the process group (MPI_INIT analogue, mpi.F90:86-105).

    Arguments fall back to the C2RAY_* environment; with nothing set the
    call is a no-op (one process).  -> True when a process group of more
    than one rank is up.  A second call is a no-op.  device: the rank's
    device (rank_device), which picks the backend unless `backend` or
    C2RAY_BACKEND names one; a backend that cannot start raises.  The
    rendezvous is a TCP store at the coordinator (rank 0 serves it),
    through which the ranks first tell each other their devices, so the
    choice sees every host's ranks."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator_address = (coordinator_address
                           or os.environ.get("C2RAY_COORDINATOR"))
    if num_processes is None:
        num_processes = _env_int("C2RAY_NUM_PROCESSES")
    if process_id is None:
        process_id = _env_int("C2RAY_PROCESS_ID")
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a multi-process run needs C2RAY_COORDINATOR, "
                         "C2RAY_NUM_PROCESSES and C2RAY_PROCESS_ID")
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    host, _, port = coordinator_address.removeprefix("tcp://").rpartition(
        ":")
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0)
    backend = backend or os.environ.get("C2RAY_BACKEND")
    if not backend:
        seen = dist.PrefixStore("c2ray_device/", store)
        seen.set(str(process_id), device_identity(dev))
        backend = pick_backend(seen.get(str(r)).decode()
                               for r in range(num_processes))
    dist.init_process_group(backend=backend, store=store,
                            world_size=num_processes, rank=process_id)
    return num_processes > 1


def process_index() -> int:
    """COMM_RANK analogue (mpi.F90:108)."""
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    """COMM_SIZE analogue (mpi.F90:111)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def backend_name() -> str:
    """The process group's backend, or "none" for one process."""
    return dist.get_backend() if dist.is_initialized() else "none"


def is_io_rank() -> bool:
    """True on the rank that owns file I/O (the reference's rank 0)."""
    return process_index() == 0


def broadcast_obj(obj: Any = None) -> Any:
    """Rank 0's picklable object on every rank (MPI_BCAST analogue,
    sourceprops.F90:246-263); other ranks pass anything.  One rank:
    identity."""
    if process_count() == 1:
        return obj
    box = [obj if is_io_rank() else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def read_on_io_rank(fn, *args, **kwargs) -> Any:
    """Run a host-side read on rank 0 only and broadcast its result (the
    reference's rank-gated read + MPI_BCAST)."""
    if process_count() == 1:
        return fn(*args, **kwargs)
    return broadcast_obj(fn(*args, **kwargs) if is_io_rank() else None)


def sync(name: str = "c2ray") -> None:
    """Barrier over all ranks (MPI_BARRIER analogue); no-op for one
    process."""
    if process_count() > 1:
        dist.barrier()


class RankGrid:
    """The (n_src, n_dom) grid of ranks of one layout: rank r sits at
    src index r // n_dom, dom index r % n_dom.  Its collectives run over
    one axis ("src", "dom") or over all ranks ("all") and count what
    they move (stats).  With one rank every collective is the identity.

    sum, max: all_reduce over the axis; every rank gets the same bits
    (each element is reduced once and sent to all).  Across two ranks a
    sum is a + b, the same bits as a sequential sum of the two partials;
    across more the order of the adds is the backend's.  gather: the
    axis's tensors concatenated along dim 0 in rank order.
    ring_exchange: one batch_isend_irecv over the dom ring (the JAX
    ppermute pair)."""

    def __init__(self, n_src: int, n_dom: int, device):
        self.device = torch.device(device)
        self.n_src, self.n_dom = int(n_src), int(n_dom)
        world = process_count()
        if self.n_src * self.n_dom != world:
            raise ValueError(f"a {self.n_src} x {self.n_dom} rank grid needs "
                             f"{self.n_src * self.n_dom} ranks, the run has "
                             f"{world}")
        self.rank = process_index()
        self.src, self.dom = divmod(self.rank, self.n_dom)
        self.backend = backend_name()
        self.groups = {}
        if world > 1:
            from torch.distributed.device_mesh import init_device_mesh
            mesh = init_device_mesh(self.device.type,
                                    (self.n_src, self.n_dom),
                                    mesh_dim_names=("src", "dom"))
            self.groups = {"src": mesh.get_group("src"),
                           "dom": mesh.get_group("dom"),
                           "all": dist.group.WORLD}
        # gloo moves CPU tensors: stage tensors on the card through the host
        self.staged = self.backend == "gloo" and self.device.type == "cuda"
        self._pinned = {}       # role -> pinned host bytes
        self.stats = dict(collectives=0, p2p=0, bytes=0, staged_bytes=0)

    def size(self, axis: str) -> int:
        return {"src": self.n_src, "dom": self.n_dom,
                "all": self.n_src * self.n_dom}[axis]

    def index(self, axis: str) -> int:
        return {"src": self.src, "dom": self.dom, "all": self.rank}[axis]

    def reset_stats(self) -> None:
        for key in self.stats:
            self.stats[key] = 0

    # ------------------------------------------------------------------
    def _buffer(self, role: str, shape, dtype) -> torch.Tensor:
        """A pinned host buffer of `shape`: a view of the role's one
        buffer, which grows to the largest transfer of the role and is
        kept (pinning is slow; the copies in and out of it are
        synchronous).  The host memory held is thus the largest transfer
        of each of the few roles."""
        nbytes = math.prod(shape) * dtype.itemsize
        buf = self._pinned.get(role)
        if buf is None or buf.numel() < nbytes:
            self._pinned.pop(role, None)        # freed before the larger
            buf = self._pinned[role] = torch.empty(nbytes, dtype=torch.uint8,
                                                   pin_memory=True)
        return buf[:nbytes].view(dtype).view(tuple(shape))

    def _host(self, t: torch.Tensor, role: str = "send") -> torch.Tensor:
        """t itself, or a pinned host copy of it under staging."""
        if not self.staged:
            return t
        self.stats["staged_bytes"] += t.numel() * t.element_size()
        return self._buffer(role, t.shape, t.dtype).copy_(t)

    def _empty(self, like: torch.Tensor, shape, role: str) -> torch.Tensor:
        """A receive buffer where the collective runs: host or device."""
        if not self.staged:
            return torch.empty(shape, dtype=like.dtype, device=like.device)
        return self._buffer(role, shape, like.dtype)

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        if not self.staged:
            return t
        self.stats["staged_bytes"] += t.numel() * t.element_size()
        return t.to(self.device, non_blocking=False)

    def gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """(k, ...) -> (size * k, ...) in rank order along the axis."""
        k = self.size(axis)
        if k == 1:
            return t
        src = self._host(t.contiguous())
        out = self._empty(src, (k * src.shape[0],) + tuple(src.shape[1:]),
                          "gather")
        dist.all_gather_into_tensor(out, src, group=self.groups[axis])
        self.stats["collectives"] += 1
        self.stats["bytes"] += out.numel() * out.element_size()
        return self._back(out)

    def _reduce(self, t: torch.Tensor, axis: str, op) -> torch.Tensor:
        """all_reduce(op) of a copy of t over the axis (t is untouched)."""
        if self.size(axis) == 1:
            return t
        buf = (self._host(t.contiguous(), "reduce") if self.staged
               else t.clone(memory_format=torch.contiguous_format))
        dist.all_reduce(buf, op=op, group=self.groups[axis])
        self.stats["collectives"] += 1
        self.stats["bytes"] += buf.numel() * buf.element_size()
        return self._back(buf)

    def sum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The axis's sum of t, the same bits on every rank."""
        return self._reduce(t, axis, dist.ReduceOp.SUM)

    def max(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """The axis's elementwise maximum of t."""
        return self._reduce(t, axis, dist.ReduceOp.MAX)

    def ring_exchange(self, send_up: torch.Tensor, send_dn: torch.Tensor):
        """send_up goes to the next rank of the dom ring, send_dn to the
        previous one.  -> (from the previous rank's send_up, from the
        next rank's send_dn).  One rank on the ring: itself."""
        if self.n_dom == 1:
            return send_up, send_dn
        base = self.src * self.n_dom
        nxt = base + (self.dom + 1) % self.n_dom
        prv = base + (self.dom - 1) % self.n_dom
        up = self._host(send_up.contiguous(), "up")
        dn = self._host(send_dn.contiguous(), "dn")
        from_prv = self._empty(up, up.shape, "from_prv")
        from_nxt = self._empty(dn, dn.shape, "from_nxt")
        ops = [dist.P2POp(dist.isend, up, nxt, tag=1),
               dist.P2POp(dist.irecv, from_prv, prv, tag=1),
               dist.P2POp(dist.isend, dn, prv, tag=2),
               dist.P2POp(dist.irecv, from_nxt, nxt, tag=2)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        self.stats["p2p"] += 1
        self.stats["bytes"] += (up.numel() * up.element_size()
                                + dn.numel() * dn.element_size())
        return self._back(from_prv), self._back(from_nxt)


def free_port() -> int:
    """A free TCP port on localhost (for C2RAY_COORDINATOR)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]

