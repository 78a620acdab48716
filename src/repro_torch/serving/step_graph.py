"""CUDA-graph replay of the serving engine's static-shape steps: the port's
counterpart of the reference's jitted steps (``_jit_unified``,
``_jit_unified_decode``, ``_jit_decode``, ``_jit_prefill``, ``_jit_insert``,
``_jit_insert_paged``, ``_jit_reset_row`` and ``_jit_sample`` in
``repro.serving.engine``).

A *profile* is one step whose shapes the engine's geometry alone fixes:
the unified engine's mixed and decode-only packed steps, and the
two-dispatch engine's decode, row reset, insert, first-token sample and
prefill chunk (one profile per chunk width, registered at the first chunk
of that width, as the reference traces ``_jit_prefill`` once per width).
Each is registered under a key with its static inputs (:class:`Staged`)
and a function that reads and writes only those, the engine's caches and
its generator, and returns the step's result, which the profile copies
into its static output (or returns nothing, where its writes are the
result).

On a card engine a profile's first use runs the step eagerly on a side
stream (a warm-up that is this step's real work: libraries load, cuBLAS
allocates its workspace and every launcher sets its kernel's attributes
outside the capture), then captures it into a ``torch.cuda.CUDAGraph``,
which runs nothing.  Every later use replays the graph.  All graphs share
one memory pool, and the engine's generator is registered with each graph,
so that every replay draws fresh numbers from it.  A capture or replay that
fails raises: nothing falls back to the eager step.

On the CPU, and on a card engine built with ``graphs=False``, a use calls
the step function on the very static tensors a capture would have bound.
An engine that replaced one of them instead of writing into it then fails
on the CPU as it would on the card.

A replay does not run the kernel wrappers, so their launch counters
(:mod:`repro_torch.kernels.launches`) get the capture's counts added on
every replay, and a capture leaves them as it found them.
"""

from __future__ import annotations

import contextlib
import gc
import math
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..kernels import launches


@contextlib.contextmanager
def sync_mode(device: torch.device, mode: int | str):
    """``torch.cuda.set_sync_debug_mode(mode)`` for the block, then the mode
    before it; a no-op off the card, where the mode means nothing."""
    if device.type != "cuda":
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode(mode)
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class Staged:
    """Static device inputs of one profile and their pinned host twin.

    ``fields`` maps each name to (shape, dtype), every dtype 4 bytes wide
    (int32 or float32).  The fields lie back to back in one device buffer
    (``dev[name]``: the tensors a capture binds) and in one host buffer,
    pinned on a card engine (``host[name]``: numpy views).  ``upload()`` is
    one non-blocking copy on the current stream, which reads the pinned
    buffer only when the stream reaches it; on the card it records an event
    after the copy.  ``write()`` waits for that event before it hands out
    the host views, so a write never lands in a buffer whose last upload
    is still queued (two prefill-only steps in a row copy nothing back to
    the host between their uploads).
    """

    def __init__(self, fields: dict[str, tuple[tuple[int, ...],
                                               torch.dtype]],
                 device: torch.device):
        total = sum(math.prod(shape) for shape, _ in fields.values())
        self.device = device
        self._host = torch.zeros((total,), dtype=torch.int32,
                                 pin_memory=device.type == "cuda")
        self._dev = torch.zeros((total,), dtype=torch.int32, device=device)
        self._uploaded = (torch.cuda.Event() if device.type == "cuda"
                          else None)
        self.host: dict[str, np.ndarray] = {}
        self.dev: dict[str, torch.Tensor] = {}
        lo = 0
        for name, (shape, dtype) in fields.items():
            hi = lo + math.prod(shape)
            self.host[name] = self._host[lo:hi].view(dtype).view(
                shape).numpy()
            self.dev[name] = self._dev[lo:hi].view(dtype).view(shape)
            lo = hi

    def write(self) -> dict[str, np.ndarray]:
        """The host views, once the last upload has read them (an explicit
        wait on the card, exempt from the debug guard)."""
        if self._uploaded is not None:
            with sync_mode(self.device, 0):
                self._uploaded.synchronize()
        return self.host

    def upload(self) -> None:
        self._dev.copy_(self._host, non_blocking=True)
        if self._uploaded is not None:
            self._uploaded.record()


@dataclass
class _Profile:
    inputs: Staged
    fn: Callable[[], torch.Tensor | None]
    out: torch.Tensor | None  # the step's result, written by its last op
    graph: torch.cuda.CUDAGraph | None = None
    delta: launches.Counts | None = None  # the capture's kernel launches

    def step(self) -> None:
        """The step's work: ``fn()``, its result copied into ``out``."""
        result = self.fn()
        if self.out is not None:
            self.out.copy_(result)


class StepGraph:
    """The engine's profiles by key: static inputs and outputs, capture on
    first use, replay after.  ``captures[key]`` counts the binds of each
    profile (its capture on a graph engine) and is never more than 1:
    binding a key twice, or one that was never registered, raises
    ``AssertionError`` (the counterpart of the reference's flat jit
    caches)."""

    def __init__(self, device: torch.device, generator: torch.Generator, *,
                 graphs: bool):
        self.device = device
        self.generator = generator
        self.graphs = graphs and device.type == "cuda"
        self.profiles: dict[str, _Profile] = {}
        self.captures: dict[str, int] = {}
        self.capture_s = 0.0  # host seconds spent inside the captures
        # host seconds of the whole binds: each first use's eager run and,
        # on a graph engine, its GC, cache release and capture
        self.bind_s = 0.0
        self.pool_bytes = 0  # reserved device memory the captures added
        self._pool = None

    def add(self, key: str, inputs: Staged, out: int | torch.Tensor | None,
            fn: Callable[[], torch.Tensor | None]) -> None:
        """Register profile ``key``: ``fn()`` runs one step on ``inputs``
        and returns its result, which each use copies into ``out``: a
        static tensor of the result's shape and dtype, an int n for (n,)
        int32 samples, or None where ``fn`` returns nothing (its writes
        into the caches are the step's result)."""
        if isinstance(out, int):
            out = torch.zeros((out,), dtype=torch.int32, device=self.device)
        self.profiles[key] = _Profile(inputs, fn, out)

    def run(self, key: str) -> torch.Tensor | None:
        """One step of profile ``key`` (its inputs uploaded by the caller);
        returns its static output."""
        p = self.profiles[key]
        if key not in self.captures:
            self.capture(key)
        elif p.graph is not None:
            p.graph.replay()
            launches.add(p.delta)
        else:
            p.step()
        return p.out

    def capture(self, key: str) -> None:
        """Bind profile ``key``: run this step's work, and on a graph engine
        capture it."""
        if key not in self.profiles or self.captures.get(key):
            raise AssertionError(
                f"step graph: recapture of profile {key!r} (bound "
                f"{self.captures.get(key, 0)} times; this engine's profiles "
                f"are {sorted(self.profiles)}): a profile's shapes depend "
                "only on the engine geometry, so it is captured once")
        self.captures[key] = 1
        t_bind = time.perf_counter()
        self._bind(self.profiles[key])
        self.bind_s += time.perf_counter() - t_bind

    def _bind(self, p: _Profile) -> None:
        """The first use's work: the step, then its capture."""
        if not self.graphs:
            p.step()
            return
        # a capture synchronises the device: lift a debug guard around it
        with sync_mode(self.device, 0):
            cur = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                p.step()
            cur.wait_stream(side)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            torch.cuda.synchronize(self.device)
            # an engine dropped in a reference cycle must not be collected
            # inside the capture: destroying its graphs there invalidates
            # the capture
            gc.collect()
            torch.cuda.empty_cache()
            reserved = torch.cuda.memory_reserved(self.device)
            before = launches.snapshot()
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(self.generator)
            t0 = time.perf_counter()
            gc_on = gc.isenabled()
            gc.disable()
            try:
                with torch.cuda.graph(graph, pool=self._pool):
                    p.step()
            finally:
                if gc_on:
                    gc.enable()
            self.capture_s += time.perf_counter() - t0
            p.delta = launches.diff(launches.snapshot(), before)
            launches.restore(before)
            self.pool_bytes += (torch.cuda.memory_reserved(self.device)
                                - reserved)
            p.graph = graph
