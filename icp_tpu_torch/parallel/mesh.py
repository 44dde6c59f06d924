"""The device mesh (counterpart of icp_tpu.parallel.mesh).

icp_tpu drives a 1-D ``jax.sharding.Mesh`` from one controller:
``shard_map`` runs a function once per device and ``lax.psum`` combines
partial results; ``jax.distributed`` joins processes. The port keeps that
shape. A ``Mesh`` holds this process's shard devices (a device may repeat,
which gives virtual shards on one card or on the CPU), the axis name, the
global size (local shards x processes) and the ``torch.distributed`` group
of a multi-process run. Sharded functions take the mesh first, loop over
the local shards, queue each shard's work on its device, then combine with
the helpers below, which stand in for what ``shard_map`` gave icp_tpu:

* ``split`` cuts a leading axis into this process's per-shard tensors
  (``in_specs=P(axis)``);
* ``replicate`` puts one tensor on every local shard device (``P()``);
* ``psum`` sums per-shard partials in shard order on the first local
  device, all-reduces across processes, and copies the sum back to each
  shard device; the order is fixed, so a run repeats;
* ``all_gather`` concatenates per-shard results along the leading axis,
  across processes too (``out_specs=P(axis)``);
* ``axis_index`` is a local shard's global index;
* ``broadcast`` gives every process process 0's values of state they all
  compute, so their decisions cannot part wherever their device math could
  still round apart (the port's scatter-sums are ordered, so one card
  repeats itself; other cards or library builds need not).

``set_virtual_devices(n, device)`` is the counterpart of XLA's
``--xla_force_host_platform_device_count``: after it, ``visible_devices``
of that kind returns n shards of ``device``. ``init_distributed`` joins
processes with the same environment names as icp_tpu, so one launcher
starts either package. NCCL takes one rank a card; with ``backend="gloo"``
and CUDA tensors the collectives copy through host memory explicitly. A
collective that fails raises; nothing switches backend on its own.
"""
from __future__ import annotations

import contextlib
import os

import torch
import torch.distributed as dist

_virtual: dict[str, tuple[int, torch.device]] = {}


def set_virtual_devices(n: int, device="cpu") -> None:
    """Make ``visible_devices`` of ``device``'s kind return ``n`` shards of
    ``device`` (n <= 0 clears the setting for that kind)."""
    device = torch.device(device)
    if n and n > 0:
        _virtual[device.type] = (int(n), device)
    else:
        _virtual.pop(device.type, None)


def virtual_count(kind: str = "cuda") -> int:
    """The number of virtual shards ``set_virtual_devices`` put in force
    for ``kind``'s devices; 0 where none are."""
    return _virtual.get(torch.device(kind).type, (0, None))[0]


def visible_devices(kind: str = "cuda") -> list[torch.device]:
    """This process's devices of ``kind``: the virtual shards if set, else
    every visible card (``cuda``) or the one CPU device (``cpu``)."""
    kind = torch.device(kind).type
    if kind in _virtual:
        n, dev = _virtual[kind]
        return [dev] * n
    if kind == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    if kind == "cpu":
        return [torch.device("cpu")]
    raise ValueError(f"no devices of kind {kind!r}")


def _on(dev: torch.device):
    """The device context a collective on ``dev`` runs under: NCCL works on
    the current card, not the tensor's."""
    return (torch.cuda.device(dev) if dev.type == "cuda"
            else contextlib.nullcontext())


def _group_size() -> tuple[int, int]:
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """A 1-D mesh: this process's shard devices, the axis name, the global
    size and the process group (None in a single process)."""

    def __init__(self, devices, axis: str = "d", group=None):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.axis = axis
        self.group = group
        if group is not None:
            self.process_count = dist.get_world_size(group)
            self.process_index = dist.get_rank(group)
        else:
            self.process_count, self.process_index = 1, 0
        self.local_size = len(self.devices)
        self.size = self.local_size * self.process_count

    def __repr__(self):
        return (f"Mesh({self.axis!r}: {self.size} shards, local "
                f"{[str(d) for d in self.devices]}, "
                f"process {self.process_index}/{self.process_count})")

    def axis_index(self, k: int) -> int:
        """Global index of local shard ``k`` (``lax.axis_index``)."""
        return self.process_index * self.local_size + k

    def split(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Cut ``x``'s leading axis (the global one, a multiple of the mesh
        size) into equal blocks; return this process's blocks, each on its
        shard device."""
        n = x.shape[0]
        if n % self.size:
            raise ValueError(f"leading axis {n} is not a multiple of the "
                             f"mesh size {self.size}")
        b = n // self.size
        return [x[self.axis_index(k) * b:(self.axis_index(k) + 1) * b]
                .to(dev) for k, dev in enumerate(self.devices)]

    def replicate(self, x: torch.Tensor) -> list[torch.Tensor]:
        """``x`` on every local shard device."""
        return [x.to(dev) for dev in self.devices]

    def _staged(self, t: torch.Tensor):
        """(tensor to hand the collective, whether it is a host copy): gloo
        takes CUDA tensors only through host memory."""
        if (t.device.type == "cuda"
                and dist.get_backend(self.group) == dist.Backend.GLOO):
            return t.cpu(), True
        return t, False

    def _all_reduce(self, x: torch.Tensor) -> torch.Tensor:
        t, staged = self._staged(x.contiguous())
        with _on(x.device):
            dist.all_reduce(t, group=self.group)
        return t.to(x.device) if staged else t

    def psum(self, parts) -> list[torch.Tensor]:
        """Sum per-shard partials (one a local shard, in shard order) on
        the first local device, all-reduce across processes, and return the
        sum on every local shard device (``lax.psum``)."""
        if len(parts) != self.local_size:
            raise ValueError(f"{len(parts)} partials for {self.local_size} "
                             f"local shards")
        d0 = self.devices[0]
        acc = parts[0].to(d0)
        for p in parts[1:]:
            acc = acc + p.to(d0)
        if self.group is not None:
            acc = self._all_reduce(acc)
        return self.replicate(acc)

    def broadcast(self, xs) -> list[torch.Tensor]:
        """Process 0's values of ``xs`` (tensors on one device) on every
        process, in one collective; ``xs`` itself in one process. For state
        every process computes redundantly: processes that kept their own
        results could take different decisions wherever their device math
        rounds apart (other cards, other library builds). The values
        travel as float32, exact for the bools and the integers below 2**24
        passed here."""
        xs = list(xs)
        if self.group is None:
            return xs
        flat = torch.cat([x.reshape(-1).to(torch.float32) for x in xs])
        t, staged = self._staged(flat)
        with _on(flat.device):
            dist.broadcast(t, src=0, group=self.group)
        t = t.to(flat.device) if staged else t
        out, k = [], 0
        for x in xs:
            out.append(t[k:k + x.numel()].reshape(x.shape).to(x.dtype))
            k += x.numel()
        return out

    def all_gather(self, parts) -> torch.Tensor:
        """Concatenate per-shard tensors along the leading axis in global
        shard order, across processes, on the first local device."""
        d0 = self.devices[0]
        local = torch.cat([p.to(d0) for p in parts])
        if self.group is None:
            return local
        t, staged = self._staged(local.contiguous())
        out = [torch.empty_like(t) for _ in range(self.process_count)]
        with _on(local.device):
            dist.all_gather(out, t, group=self.group)
        full = torch.cat(out)
        return full.to(d0) if staged else full


def make_mesh(n_devices: int | None = None, axis: str = "d",
              device="cuda") -> Mesh:
    """1-D mesh over the first ``n_devices`` (default: all) of
    ``visible_devices`` of ``device``'s kind. In a joined multi-process run
    ``n_devices`` counts every process's shards; each process takes its
    share, the rank's own slice where it sees a card for every rank, else
    the first (ranks sharing one card, or the CPU)."""
    devs = visible_devices(device)
    if not devs:
        raise RuntimeError(f"make_mesh(device={str(device)!r}) but CUDA is "
                           f"not available; pass device='cpu' explicitly")
    world, rank = _group_size()
    if n_devices is None:
        per = max(len(devs) // world, 1) if len(devs) >= world else len(devs)
    else:
        if n_devices % world:
            raise ValueError(f"{n_devices} shards do not divide over "
                             f"{world} processes")
        per = n_devices // world
    start = rank * per if (rank + 1) * per <= len(devs) and world > 1 else 0
    if start + per > len(devs) or per < 1:
        raise RuntimeError(f"make_mesh({n_devices}) needs {per} "
                           f"{torch.device(device).type} devices in this "
                           f"process, {len(devs)} visible")
    return Mesh(devs[start:start + per], axis,
                dist.group.WORLD if world > 1 else None)


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> bool:
    """Join this process to a multi-process run: ``init_process_group`` at
    ``tcp://coordinator`` with the given world size and rank. Falls back to
    icp_tpu's environment names (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID). Returns False in a single process
    (no coordinator). The backend is nccl where a card is visible and gloo
    on the CPU, unless named."""
    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if coordinator is None:
        return False
    if num_processes is None:
        num_processes = int(os.environ.get("JAX_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("JAX_PROCESS_ID", "0"))
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    return True
