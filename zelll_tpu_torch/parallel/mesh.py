"""A one-dimensional mesh of shards in one process, and its collectives.

The counterpart of what the JAX package takes from JAX for its slab
decomposition: ``jax.sharding.Mesh`` over ``jax.devices()``, ``shard_map``
and the ``lax`` collectives over the mesh axis ``"z"``. JAX runs one
controller over every device; so does this module. A mesh is D shards,
each on a torch device (several may share one card), and `shard_map` runs a
per-shard body for every shard of the mesh in one process:

* each shard runs in a thread of its own, but only one shard runs at a
  time, in shard order, handing on at each collective; so a run is as
  deterministic as a sequential loop over the shards, and its kernel
  launches and their counts follow one another;
* a collective waits until every shard has called it, combines their
  values in shard order (``psum`` adds shard 0's first, then 1's, ...), and
  hands each shard its result on the shard's own device;
* ``ppermute`` copies a value to the device of the shard it is sent to, as
  the halo exchange of the JAX package sends a slice over the chip
  interconnect.

Every shard must call the same collectives in the same order, as in
``shard_map``. The collectives live here alone, so that a form on
``torch.distributed`` (one process per card) could take their place.
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import Callable, Sequence

import torch

from .._device import resolve_device

__all__ = [
    "AXIS",
    "Mesh",
    "make_mesh",
    "shard_map",
    "axis_size",
    "axis_index",
    "ppermute",
    "psum",
    "pmin",
    "pmax",
    "all_gather",
]

AXIS = "z"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """D shards along the one mesh axis ``"z"``, shard k on ``devices[k]``."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh of ``n_devices`` shards.

    ``devices`` is a device, or a sequence of them, that the shards are laid
    on round-robin (shard k on ``devices[k % len(devices)]``), so that more
    shards than devices put several on one device. The default is every
    visible CUDA device; without one it raises, as `resolve_device` does:
    pass ``devices="cpu"`` to run the shards on the CPU. ``n_devices``
    defaults to the number of devices.
    """
    if devices is None:
        count = torch.cuda.device_count()
        devices = [resolve_device("cuda")] if count == 0 else [
            torch.device("cuda", k) for k in range(count)]
    elif isinstance(devices, (str, torch.device)):
        devices = [devices]
    devices = [resolve_device(d) for d in devices]
    if not devices:
        raise ValueError("make_mesh needs at least one device")
    n = len(devices) if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh holds at least one shard; got {n}")
    return Mesh(devices=tuple(devices[k % len(devices)] for k in range(n)))


class _Run:
    """One `shard_map` call: the shards' turns and their collectives."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.cond = threading.Condition()
        self.turn = 0
        self.values: list = [None] * mesh.size
        self.results: list = [None] * mesh.size
        self.error: BaseException | None = None

    def wait_turn(self, index: int) -> None:
        with self.cond:
            while self.turn != index and self.error is None:
                self.cond.wait()
            if self.error is not None:
                raise _Aborted()

    def hand_on(self, index: int) -> None:
        """Shard ``index`` stops; the next shard in order runs."""
        with self.cond:
            self.turn = index + 1
            self.cond.notify_all()

    def collective(self, index: int, value, combine: Callable):
        """Shard ``index``'s part of a collective: its value goes in, the
        shard waits until the last shard has combined every value, and
        takes its own result."""
        self.values[index] = value
        last = index == self.mesh.size - 1
        if last:
            self.results = combine(self.values)
            self.values = [None] * self.mesh.size
        with self.cond:
            self.turn = 0 if last else index + 1
            self.cond.notify_all()
        self.wait_turn(index)
        return self.results[index]

    def fail(self, error: BaseException) -> None:
        with self.cond:
            if self.error is None:
                self.error = error
            self.cond.notify_all()


class _Aborted(Exception):
    """Another shard raised: this one stops."""


_LOCAL = threading.local()


def _shard():
    ctx = getattr(_LOCAL, "shard", None)
    if ctx is None:
        raise RuntimeError("mesh collectives run inside a body that shard_map runs")
    return ctx


def axis_size() -> int:
    """The number of shards of the mesh that runs the calling body."""
    return _shard()[0].mesh.size


def axis_index() -> int:
    """The calling body's shard index."""
    return _shard()[1]


def _devices() -> tuple:
    return _shard()[0].mesh.devices


def _call(value, combine: Callable):
    run, index = _shard()
    return run.collective(index, value, combine)


def ppermute(x: torch.Tensor, perm: Sequence[tuple]) -> torch.Tensor:
    """``lax.ppermute``: for each (source, destination) pair of ``perm``,
    the destination shard receives the source's ``x``, copied to its
    device; a shard that no pair sends to receives zeros."""
    perm = [(int(s), int(d)) for s, d in perm]

    def combine(xs):
        out = [None] * len(xs)
        for s, d in perm:
            out[d] = xs[s].to(_devices()[d])
        return [o if o is not None else torch.zeros_like(x_) for o, x_ in zip(out, xs)]

    return _call(x, combine)


def _reduce(op: Callable) -> Callable:
    def combine(xs):
        total = xs[0]
        for v in xs[1:]:
            total = op(total, v.to(total.device))
        return [total.to(d) for d in _devices()]
    return combine


def psum(x: torch.Tensor) -> torch.Tensor:
    """``lax.psum``: the sum over the shards, added in shard order."""
    return _call(x, _reduce(torch.add))


def pmin(x: torch.Tensor) -> torch.Tensor:
    """``lax.pmin``: the elementwise minimum over the shards."""
    return _call(x, _reduce(torch.minimum))


def pmax(x: torch.Tensor) -> torch.Tensor:
    """``lax.pmax``: the elementwise maximum over the shards."""
    return _call(x, _reduce(torch.maximum))


def all_gather(x: torch.Tensor) -> torch.Tensor:
    """``lax.all_gather(tiled=True)``: every shard's ``x`` in shard order,
    concatenated along axis 0."""

    def combine(xs):
        whole = torch.cat([v.to(xs[0].device) for v in xs])
        return [whole.to(d) for d in _devices()]

    return _call(x, combine)


def _split(x, mesh: Mesh, spec) -> list:
    """One input per shard: a sharded input (spec ``AXIS``) in D equal
    blocks of axis 0, a replicated one (spec None) whole, each on its
    shard's device."""
    if spec is None:
        return [x if not isinstance(x, torch.Tensor) else x.to(d) for d in mesh.devices]
    if spec != AXIS:
        raise ValueError(f"a spec is {AXIS!r} (sharded along axis 0) or None; got {spec!r}")
    x = torch.as_tensor(x)
    n = x.shape[0]
    if n % mesh.size:
        raise ValueError(f"{n} rows do not split into {mesh.size} equal shards")
    return [b.to(d) for b, d in zip(torch.split(x, n // mesh.size), mesh.devices)]


def _join(parts: list, spec, home: torch.device):
    """A sharded output (spec ``AXIS``) concatenated in shard order on
    ``home``; a replicated one (spec None) is shard 0's."""
    if spec is None:
        return parts[0]
    if spec != AXIS:
        raise ValueError(f"a spec is {AXIS!r} (sharded along axis 0) or None; got {spec!r}")
    return torch.cat([p.to(home) for p in parts])


def shard_map(body: Callable, mesh: Mesh, in_specs: tuple, out_specs) -> Callable:
    """``shard_map`` over the mesh: ``fn(*args)`` splits each argument by
    its spec (`_split`), runs ``body`` once per shard on its shard's inputs
    (the collectives above work inside it), and joins each output by its
    spec (`_join`; a tuple of specs for a tuple of outputs) on the first
    shard's device. The caller's grad mode holds in every shard."""

    def fn(*args):
        if len(args) != len(in_specs):
            raise TypeError(f"expected {len(in_specs)} arguments, got {len(args)}")
        inputs = [_split(a, mesh, s) for a, s in zip(args, in_specs)]
        run = _Run(mesh)
        outs: list = [None] * mesh.size
        grad = torch.is_grad_enabled()

        def work(k: int) -> None:
            _LOCAL.shard = (run, k)
            dev = mesh.devices[k]
            try:
                run.wait_turn(k)
                with torch.set_grad_enabled(grad), \
                        torch.cuda.device(dev) if dev.type == "cuda" else contextlib.nullcontext():
                    outs[k] = body(*(inp[k] for inp in inputs))
                run.hand_on(k)
            except _Aborted:
                pass
            except BaseException as err:  # noqa: BLE001 - re-raised by the caller
                run.fail(err)
            finally:
                _LOCAL.shard = None

        threads = [threading.Thread(target=work, args=(k,), daemon=True)
                   for k in range(mesh.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if run.error is not None:
            raise run.error
        home = mesh.devices[0]
        if isinstance(out_specs, tuple):
            return tuple(_join([o[i] for o in outs], s, home)
                         for i, s in enumerate(out_specs))
        return _join(outs, out_specs, home)

    return fn
