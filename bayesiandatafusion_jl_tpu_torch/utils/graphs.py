"""Phases of a sweep replayed from CUDA graphs.

A sweep issues a few hundred small device operations.  Where their device
time is short (the K x K Normal-Wishart draw, the beta draw's dual solve on
a 15,000-row relation, the AUC's sort and scans), the host's time to issue
them one by one exceeds the card's time to run them, and the host sets the
sweep's pace.  ``Graphs`` captures such a phase once as a CUDA graph on
fixed input and output buffers and replays it: the inputs copied in, one
launch, the outputs copied out (the state holds them across sweeps, while
the graph writes the same buffers every time).  The replay runs the
captured kernels on the same data, so it gives the eager phase's bits.

A phase may be captured only if it reads nothing back to the host (a
read raises CUDA's capture error) and issues the same operations for the
same key every time.  Its Python runs
once, at the capture, so the counters it advances (``spans.counter``) are
advanced by the captured change at every replay, and the spans inside it
are entered at the capture alone; the span around the call still holds
the replay.  A key's first call runs eagerly (it sets up the libraries'
handles and workspaces), its second captures and replays.  Off the card,
or with ``enabled`` false, every call runs eagerly.

The captures run on one side stream of their own, and cuBLAS keeps a
workspace for each stream it runs on (32 MiB on an H100) for as long as
the process lives: the engine turns its graphs on only where the phases
they replace set the pace (``MacauEngine.graphs``).
"""
from __future__ import annotations

from typing import Callable, Dict, Hashable, Sequence, Tuple

import torch

from . import spans

_EAGER_ONCE = "eager once"


class _Captured:
    __slots__ = ("graph", "inputs", "outputs", "change")

    def __init__(self, graph, inputs, outputs, change):
        self.graph, self.inputs = graph, inputs
        self.outputs, self.change = outputs, change

    def replay(self, args: Sequence[torch.Tensor]) -> Tuple[torch.Tensor,
                                                              ...]:
        for buf, a in zip(self.inputs, args):
            if buf.shape != a.shape or buf.dtype != a.dtype:
                raise ValueError(f"a graph captured for {tuple(buf.shape)} "
                                 f"{buf.dtype} got {tuple(a.shape)} "
                                 f"{a.dtype}")
            buf.copy_(a)
        self.graph.replay()
        spans.advance(self.change)
        return tuple(o.clone() for o in self.outputs)


class Graphs:
    """The graphs of one engine, by key: ``graphs(key, fn, *args)`` is
    ``fn(*args)`` (device tensors in, a tuple of device tensors out),
    replayed from a graph from the key's second call on."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._by_key: Dict[Hashable, object] = {}
        self._stream = None

    def __call__(self, key: Hashable, fn: Callable,
                 *args: torch.Tensor) -> Tuple[torch.Tensor, ...]:
        if not (self.enabled and args[0].is_cuda):
            return fn(*args)
        got = self._by_key.get(key)
        if got is None:
            self._by_key[key] = _EAGER_ONCE
            return fn(*args)
        if got is _EAGER_ONCE:
            if self._stream is None:
                self._stream = torch.cuda.Stream(device=args[0].device)
            got = self._by_key[key] = _capture(fn, args, self._stream)
        return got.replay(args)

    def captured(self) -> int:
        """How many keys replay from a graph."""
        return sum(isinstance(g, _Captured) for g in self._by_key.values())


def _capture(fn, args, side):
    """``fn`` on copies of ``args`` captured on the stream ``side``; its
    counters' change is taken back (nothing ran) and kept for the
    replays."""
    inputs = [a.clone() for a in args]
    before = spans.counts()
    graph = torch.cuda.CUDAGraph()
    main = torch.cuda.current_stream(args[0].device)
    side.wait_stream(main)
    try:
        with torch.cuda.stream(side):
            graph.capture_begin()
            try:
                outputs = tuple(fn(*inputs))
            finally:
                graph.capture_end()
    finally:
        main.wait_stream(side)
        now = spans.counts()
        change = {k: v - before.get(k, 0) for k, v in now.items()
                  if v != before.get(k, 0)}
        spans.advance({k: -v for k, v in change.items()})
    return _Captured(graph, inputs, outputs, change)
