"""A fixed-shape step run as one CUDA graph replay: the port's ``jax.jit``.

The JAX package compiles a frame into one executable (``jax.jit`` over
``render_slab``).  The counterpart here is a captured CUDA graph
(``torch.cuda.CUDAGraph``): the step is captured once per input
signature -- the shapes and dtypes of its input tensors and the structure
that holds them (a ``DeviceScene`` with or without ``seg_pre``, a packed
buffer, a 0-d ``t``) -- and every later call replays it, one host call for
the hundreds of kernels and tensor ops of a frame.

The step owns static input tensors, one set per signature.  A call copies
the caller's tensors into them (``copy_``), or copies nothing when it is
handed the static tensors themselves (:meth:`CapturedStep.static_inputs`,
:meth:`CapturedStep.stage`), so a caller can stage straight into them.  The
step's output is one tensor, returned as a fresh clone: a returned frame
does not change when the step is called again.

Before capture the step runs once eagerly on a side stream, as the
``torch.cuda.graphs`` documentation prescribes: that builds the kernel
library, runs the kernels' one-time attribute calls and fills the
allocator.  That run and the capture are set-up, not frames: their kernel
launches are kept out of ``kernels.LAUNCHES``, and each replay adds the
launches the capture recorded.  The capture runs with Python's cyclic
garbage collector paused (:func:`collector_paused`).  A capture that
fails raises; nothing falls back to running the step eagerly on the card.

Tracing (tracing.py): a call is the span ``piet.step``, with
``piet.upload`` around the copies into the static inputs and
``piet.replay`` around the replay and the clone; the pre-run and the
capture are ``piet.capture``, counted in ``tracing.graph_captures`` and
``tracing.capture_s``.  A capture records the step's stage map
(``tracing.mark``), which its entry keeps (``stages``) and
``tracing.GRAPHS`` holds.

On the CPU (the tests) there is no graph: a call copies into the static
tensors and runs the step eagerly.
"""

from __future__ import annotations

import contextlib
import gc
import time
from typing import Callable, Dict, List, Optional

import torch

from .. import kernels, tracing


def _flatten(tree, leaves: List[torch.Tensor]):
    """Append the tensors of ``tree`` (a tensor, None, or a (named) tuple
    of those) to ``leaves``; return the structure without them."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return "T"
    if tree is None:
        return None
    return (type(tree), tuple(_flatten(x, leaves) for x in tree))


def _unflatten(spec, leaves):
    if spec == "T":
        return next(leaves)
    if spec is None:
        return None
    cls, kids = spec
    vals = [_unflatten(k, leaves) for k in kids]
    return cls(vals) if cls is tuple else cls(*vals)


@contextlib.contextmanager
def collector_paused():
    """Python's cyclic garbage collector off inside the block, as it was
    after.  A capture runs with it off: a collection there can free an
    unreferenced step held in a reference cycle, and releasing its graph
    is not permitted while a stream captures, which invalidates the
    capture.  The garbage is collected after the block."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


class _Entry:
    """One input signature: its static inputs and, on a CUDA device, the
    captured graph, its output tensor and the launches it holds."""

    def __init__(self, spec, static: List[torch.Tensor]):
        self.static = static
        self.tree = _unflatten(spec, iter(static))
        self.built = False
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.launches: Dict[str, int] = {}
        self.stages: List[tuple] = []


class CapturedStep:
    """``fn`` (inputs -> one tensor, fixed shapes, no host sync) run as a
    CUDA graph replay on a CUDA ``device``, eagerly on the CPU."""

    def __init__(self, fn: Callable, device):
        self.fn = fn
        self.device = torch.device(device)
        self._entries: Dict[tuple, _Entry] = {}

    def _entry(self, like):
        leaves: List[torch.Tensor] = []
        spec = _flatten(like, leaves)
        sig = (spec, tuple((tuple(t.shape), t.dtype) for t in leaves))
        e = self._entries.get(sig)
        if e is None:
            e = self._entries[sig] = _Entry(spec, [
                torch.empty(t.shape, dtype=t.dtype, device=self.device)
                for t in leaves])
        return e, leaves

    def static_inputs(self, like):
        """The static input tensors for the signature of ``like`` (any
        tensors of the same shapes, dtypes and structure, on any device),
        made on first request; what they hold is the caller's to write."""
        return self._entry(like)[0].tree

    def stage(self, x):
        """Copy ``x`` into the static inputs of its signature (a leaf that
        is the static tensor itself is not copied); return them."""
        return self._stage(x).tree

    def _stage(self, x) -> _Entry:
        e, leaves = self._entry(x)
        with tracing.span("piet.upload"):
            for dst, src in zip(e.static, leaves):
                if src is not dst:
                    dst.copy_(src)
        return e

    def n_graphs(self) -> int:
        """Input signatures the step was built for: on a CUDA device, one
        captured graph each."""
        return sum(e.built for e in self._entries.values())

    def __call__(self, x) -> torch.Tensor:
        """Stage ``x``, run the step; return its output as a fresh tensor."""
        with tracing.span("piet.step"):
            e = self._stage(x)
            if self.device.type != "cuda":
                out = self.fn(e.tree)
                e.built = True
                return out
            # The step's device is the current one while it is captured
            # and replayed: the graph and the kernels' stream
            # (kernels.stream) are the current device's.
            with torch.cuda.device(self.device):
                if e.graph is None:
                    self._capture(e)
                    e.built = True
                with tracing.span("piet.replay"):
                    e.graph.replay()
                    out = e.out.clone()
            kernels.add_launches(e.launches)
            return out

    def _capture(self, e: _Entry) -> None:
        dev = self.device
        # The kernels' library is loaded first (built on a checkout's first
        # run), so that capture_s is the pre-run's and the capture's own.
        kernels.library()
        t0 = time.perf_counter()
        with tracing.span("piet.capture"):
            with kernels.launches_apart():
                side = torch.cuda.Stream(dev)
                side.wait_stream(torch.cuda.current_stream(dev))
                with torch.cuda.stream(side):
                    self.fn(e.tree)
                torch.cuda.current_stream(dev).wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # A capture stream of the step's card: torch.cuda.graph's
            # default one is made once, on the card current at the first
            # capture.
            stream = torch.cuda.Stream(dev)
            with kernels.launches_apart() as launches, collector_paused():
                with torch.cuda.graph(graph, stream=stream):
                    with tracing.recording_stages(
                            stream.cuda_stream) as stages:
                        out = self.fn(e.tree)
        tracing.add_capture(time.perf_counter() - t0)
        e.graph, e.out, e.launches, e.stages = graph, out, launches, stages


def device_ops(fn: Callable[[], object], device="cuda") -> List[str]:
    """The device ops of one ``fn()`` (device work only, no host sync),
    counted from a CUDA graph of it: after one eager call on a side
    stream, ``fn`` is captured, and the kernel, memset and memcpy nodes
    of the captured graph are listed in the order ``cuGraphGetNodes``
    gives them.  Exact, where a profiler trace can drop
    records; the launches are kept out of ``kernels.LAUNCHES``."""
    dev = torch.device(device)
    with kernels.launches_apart(), torch.cuda.device(dev):
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with collector_paused(), torch.cuda.graph(
                graph, stream=torch.cuda.Stream(dev)):
            fn()
    return tracing.graph_device_nodes(graph.raw_cuda_graph())
