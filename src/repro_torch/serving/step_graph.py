"""CUDA-graph replay of the serving engine's static-shape steps: the port's
counterpart of the reference's jitted steady-state steps (``_jit_unified``,
``_jit_unified_decode`` and ``_jit_decode`` in ``repro.serving.engine``).

A *profile* is one step whose shapes the engine's geometry alone fixes:
the unified engine's mixed and decode-only packed steps, and the
two-dispatch engine's decode.  Each is registered under a key with its
static inputs (:class:`Staged`) and a function that reads and writes only
those, the engine's one ``ModelCache`` and its generator, and returns the
step's sampled tokens.

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
    pinned on a card engine (``host[name]``: numpy views to write).
    ``upload()`` is one non-blocking copy on the current stream.  The
    engine writes the host views only after the step's device-to-host copy
    of its samples, which orders those writes after the previous upload.
    """

    def __init__(self, fields: dict[str, tuple[tuple[int, ...],
                                               torch.dtype]],
                 device: torch.device):
        total = sum(math.prod(shape) for shape, _ in fields.values())
        self._host = torch.zeros((total,), dtype=torch.int32,
                                 pin_memory=device.type == "cuda")
        self._dev = torch.zeros((total,), dtype=torch.int32, device=device)
        self.host: dict[str, np.ndarray] = {}
        self.dev: dict[str, torch.Tensor] = {}
        lo = 0
        for name, (shape, dtype) in fields.items():
            hi = lo + math.prod(shape)
            self.host[name] = self._host[lo:hi].view(dtype).view(
                shape).numpy()
            self.dev[name] = self._dev[lo:hi].view(dtype).view(shape)
            lo = hi

    def upload(self) -> None:
        self._dev.copy_(self._host, non_blocking=True)


@dataclass
class _Profile:
    inputs: Staged
    fn: Callable[[], torch.Tensor]
    out: torch.Tensor  # the step's samples, written by the step's last op
    graph: torch.cuda.CUDAGraph | None = None
    delta: launches.Counts | None = None  # the capture's kernel launches


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
        self.pool_bytes = 0  # reserved device memory the captures added
        self._pool = None

    def add(self, key: str, inputs: Staged, n_out: int,
            fn: Callable[[], torch.Tensor]) -> None:
        """Register profile ``key``: ``fn()`` runs one step on ``inputs``
        and returns its (n_out,) int32 samples."""
        self.profiles[key] = _Profile(
            inputs, fn, torch.zeros((n_out,), dtype=torch.int32,
                                    device=self.device))

    def run(self, key: str) -> torch.Tensor:
        """One step of profile ``key`` (its inputs uploaded by the caller);
        returns the static (n_out,) samples."""
        p = self.profiles[key]
        if key not in self.captures:
            self.capture(key)
        elif p.graph is not None:
            p.graph.replay()
            launches.add(p.delta)
        else:
            p.out.copy_(p.fn())
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
        p = self.profiles[key]
        if not self.graphs:
            p.out.copy_(p.fn())
            return
        # a capture synchronises the device: lift a debug guard around it
        with sync_mode(self.device, 0):
            cur = torch.cuda.current_stream(self.device)
            side = torch.cuda.Stream(self.device)
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                p.out.copy_(p.fn())
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
                    p.out.copy_(p.fn())
            finally:
                if gc_on:
                    gc.enable()
            self.capture_s += time.perf_counter() - t0
            p.delta = launches.diff(launches.snapshot(), before)
            launches.restore(before)
            self.pool_bytes += (torch.cuda.memory_reserved(self.device)
                                - reserved)
            p.graph = graph
