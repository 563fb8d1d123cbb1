"""The process-group mesh of a multi-card run and its collectives.

JAX counterpart: ``toycluster_tpu/parallel/mesh.py``.  JAX drives a 1-D
``Mesh`` from one process under ``shard_map``; ``torch.distributed`` runs
one process a shard.  A shard is a rank: the body of a sharded function
is the per-rank code, every rank calls the same functions on its own
local rows, and a result that is replicated (``P()``) in JAX is equal on
every rank.  The JAX collectives map one to one onto the helpers of
``Mesh``, and nothing else in the package calls ``torch.distributed``:

* ``all_gather(tiled=True)`` -> ``Mesh.all_gather``
  (``all_gather_single``, or ``all_gather_into_tensor`` where torch has no
  such name);
* ``psum`` / ``pmax`` -> ``Mesh.psum`` / ``Mesh.pmax`` (``all_reduce``);
* ``ppermute`` over the ring i -> i + 1 -> ``Mesh.ring_shift``
  (``batch_isend_irecv`` to rank + 1 and from rank - 1);
* ``axis_index`` -> ``Mesh.rank``.

Backends, chosen by the caller and never by catching an error: NCCL needs
one GPU a rank; gloo serves CPU ranks and several ranks that share one
card.  Gloo has CUDA ``all_reduce`` and ``broadcast`` but no CUDA
all-gather or point-to-point, so under gloo the helpers stage those two
through pinned host buffers; the compute never leaves the rank's device.

``spawn`` starts the ranks of one machine with ``torch.multiprocessing``
and a ``FileStore`` (no port to race for); ``torchrun`` serves as well,
with ``make_mesh`` after ``init_process_group``.
"""

from __future__ import annotations

import contextlib
import datetime
import os
import pickle
import queue as queue_mod
import shutil
import tempfile
import time
import traceback

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")
# the tiled all-gather under the name the installed torch has
_ALL_GATHER = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


class Mesh:
    """A 1-D mesh over the ranks of a process group: the group, this
    rank, the world size, the rank's device and the backend.  With
    ``timing`` set, every collective is timed (host clock, and CUDA
    events on a card); ``collective_stats`` reads and resets the
    totals."""

    def __init__(self, group, rank: int, size: int, device, backend: str):
        self.group = group
        self.rank = rank
        self.size = size
        self.device = torch.device(device)
        self.backend = backend
        self.timing = False
        self._calls = 0
        self._host_s = 0.0
        self._events = []

    @property
    def staged(self) -> bool:
        """Whether all-gathers and point-to-point copies go through host
        buffers (gloo with CUDA tensors)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @contextlib.contextmanager
    def _span(self):
        if not self.timing:
            yield
            return
        ev = None
        if self.device.type == "cuda":
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            ev[0].record()
        t = time.perf_counter()
        yield
        self._host_s += time.perf_counter() - t
        self._calls += 1
        if ev is not None:
            ev[1].record()
            self._events.append(ev)

    def collective_stats(self):
        """(collectives, host seconds, device ms) since the last call;
        device ms is None off the card."""
        ms = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            ms = sum(a.elapsed_time(b) for a, b in self._events)
        out = (self._calls, self._host_s, ms)
        self._calls, self._host_s, self._events = 0, 0.0, []
        return out

    def _host(self, x):
        """A pinned host copy of the device tensor x."""
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        buf.copy_(x)
        return buf

    def all_gather(self, x):
        """Every rank's x concatenated along dim 0, in rank order."""
        if x.dtype == torch.bool:
            return self.all_gather(x.to(torch.uint8)).bool()
        with self._span():
            src = x.contiguous()
            if self.staged:
                src = self._host(src)
            out = src.new_empty((self.size * src.shape[0],)
                                + tuple(src.shape[1:]))
            _ALL_GATHER(out, src, group=self.group)
            if self.staged:
                out = out.to(self.device, non_blocking=True)
        return out

    def _all_reduce(self, x, op):
        out = x.clone()
        with self._span():
            dist.all_reduce(out, op=op, group=self.group)
        return out

    def psum(self, x):
        """The sum of x over the ranks (a new tensor)."""
        return self._all_reduce(x, dist.ReduceOp.SUM)

    def pmax(self, x):
        """The elementwise maximum of x over the ranks (a new tensor)."""
        return self._all_reduce(x, dist.ReduceOp.MAX)

    def broadcast(self, x, src: int = 0):
        """Rank ``src``'s x on every rank (x of the same shape and dtype
        on each rank; a new tensor)."""
        out = x.clone().contiguous()
        with self._span():
            dist.broadcast(out, src=src, group=self.group)
        return out

    def ring_shift(self, x):
        """Send x to rank + 1 and return the x of rank - 1 (the ring
        ``ppermute``); the identity on one rank."""
        if self.size == 1:
            return x
        with self._span():
            send = x.contiguous()
            if self.staged:
                send = self._host(send)
            recv = torch.empty_like(send)
            ops = [dist.P2POp(dist.isend, send, (self.rank + 1) % self.size,
                              self.group),
                   dist.P2POp(dist.irecv, recv, (self.rank - 1) % self.size,
                              self.group)]
            for work in dist.batch_isend_irecv(ops):
                work.wait()
            if self.staged:
                recv = recv.to(self.device, non_blocking=True)
        return recv

    def rows(self, x):
        """This rank's rows of x: the rank-th of ``size`` equal slices of
        dim 0 (the counterpart of placing x sharded over the mesh)."""
        n = x.shape[0]
        if n % self.size:
            raise ValueError(f"{n} rows do not split over {self.size} "
                             f"ranks")
        k = n // self.size
        return x[self.rank * k:(self.rank + 1) * k]


def make_mesh(n_devices: int | None = None, *, device=None) -> Mesh:
    """The mesh over the initialised default process group.  Raises
    without one, and if ``n_devices`` is not its world size.  ``device``
    is this rank's device (default: the current CUDA device, under either
    backend; without a card the default raises: pass device="cpu")."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialised default process "
                           "group: start the ranks with parallel.mesh.spawn "
                           "or torchrun and call init_process_group")
    size = dist.get_world_size()
    if n_devices is not None and n_devices != size:
        raise ValueError(f"n_devices={n_devices} but the process group has "
                         f"{size} ranks")
    backend = str(dist.get_backend())
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: CUDA is not available; pass "
                               "device='cpu' for CPU ranks")
        device = torch.device("cuda", torch.cuda.current_device())
    return Mesh(dist.group.WORLD, dist.get_rank(), size, device, backend)


def _rank_device(rank, backend, device):
    """NCCL: cuda:rank.  gloo: the given device, every rank on it."""
    if device.type != "cuda":
        return device
    if backend == "nccl":
        return torch.device("cuda", rank)
    return torch.device("cuda", device.index or 0)


def _portable(exc, tb):
    """exc with its traceback as a note, or, where exc does not survive
    pickling, a RuntimeError that carries both."""
    try:
        pickle.loads(pickle.dumps(exc))
    except (pickle.PicklingError, TypeError, AttributeError):
        return RuntimeError(f"{type(exc).__name__}: {exc}\n{tb}")
    exc.add_note(tb)
    return exc


def _rank_main(rank, world_size, backend, device, store_path, timeout_s, fn,
               args, results):
    try:
        dev = _rank_device(rank, backend, torch.device(device))
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world_size),
            rank=rank, world_size=world_size,
            timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(make_mesh(world_size, device=dev), *args)
        results.put((rank, True, out))
        dist.destroy_process_group()
    except BaseException as exc:  # the rank's boundary: report, then exit
        results.put((rank, False, _portable(exc, traceback.format_exc())))


def spawn(fn, world_size: int, *, backend: str, device="cuda",
          timeout_s: float = 600.0, args=()):
    """Run ``fn(mesh, *args)`` on ``world_size`` ranks of one machine and
    return each rank's result, in rank order.

    ``fn`` and ``args`` are pickled (``fn`` by import path) and so are the
    results: return host tensors or NumPy arrays.  ``backend`` is "nccl"
    (one GPU a rank: rank r on cuda:r) or "gloo" (CPU ranks, or every
    rank on the one card ``device`` names).  ``device`` defaults to cuda
    and raises without a card.  The ranks rendezvous through a
    ``FileStore`` in a fresh temporary directory.  The first rank that
    raises, or dies, takes the others down and its exception is raised
    here; ranks that have not all finished within ``timeout_s`` are killed
    and TimeoutError is raised.  Every process group gets ``timeout_s``.
    CUDA kernels are built in the caller beforehand
    (``ops.cuda_build.build``) so that no two ranks run nvcc."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, not "
                         f"{backend!r}")
    device = torch.device(device)
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"device must be cuda or cpu, not {device}")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device=cuda but CUDA is not available; pass "
                           "device='cpu' to run the ranks on the CPU")
    if backend == "nccl" and (device.type != "cuda"
                              or world_size > torch.cuda.device_count()):
        raise ValueError("NCCL needs one GPU a rank: use gloo for CPU ranks "
                         "or for ranks that share a card")
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="toycluster-mesh-")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True, args=(
        rank, world_size, backend, str(device), os.path.join(tmp, "store"),
        timeout_s, fn, args, results)) for rank in range(world_size)]
    out, started = {}, []
    try:
        for p in procs:
            p.start()
            started.append(p)
        deadline = time.monotonic() + timeout_s
        while len(out) < world_size:
            left = deadline - time.monotonic()
            if left <= 0:
                missing = sorted(set(range(world_size)) - set(out))
                raise TimeoutError(f"ranks {missing} did not finish within "
                                   f"{timeout_s} s")
            try:
                rank, ok, payload = results.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                for rank, p in enumerate(procs):
                    if rank not in out and p.exitcode is not None:
                        raise RuntimeError(f"rank {rank} exited with code "
                                           f"{p.exitcode} without a result")
                continue
            if not ok:
                raise payload
            out[rank] = payload
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in started:
            if p.is_alive():
                p.terminate()
        for p in started:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[rank] for rank in range(world_size)]
