"""CUDA graphs of a function of fixed shapes: run eagerly at a key's first
call, captured at its second, replayed from then on.

A replan on the card is some 16,000 small operations and 90 hand-kernel
launches, each dispatched by the host (PERF.md §5): replayed as one graph,
it costs the device's time and a copy in and out.  `GraphCache` keeps the
graphs of the keys its caller gives it (everything the captured work
depends on besides its inputs' contents), at most `size` of them, the least
recently used dropped first.  A key met once never pays for a capture.

`Graph` captures `fn(*inputs)` on static copies of the inputs.  A replay
copies the call's inputs into them, replays, and returns a fresh copy of
every output, so a caller may hold the outputs of one call across the next.
Whatever the captured work reads besides its constants has to be among the
inputs (the replan passes its height grid as one): a graph holds nothing of
its caller's, and knows the tensors it last copied only by weak reference
(`new_inputs`).
The hand kernels' wrappers count launches when Python calls them: a capture
launches nothing, so every registered counter (`ops.cuda_lib.LAUNCH_COUNTERS`)
goes back to where it was, and each replay adds what the capture counted.
"""

from __future__ import annotations

import collections
import weakref

import torch

from qtos_torch.ops import cuda_lib
from qtos_torch.solver.spec import map_tensors

_UNSEEN = object()


def _clone(out):
    if isinstance(out, tuple):
        return tuple(_clone(o) for o in out)
    return map_tensors(out, torch.clone)


class Graph:
    """`fn(*inputs)` captured on the inputs' CUDA device.  `inputs` are
    tensors or None (left out of the copies)."""

    def __init__(self, fn, inputs: tuple):
        self.device = next(t.device for t in inputs if t is not None)
        self.counters = tuple(cuda_lib.LAUNCH_COUNTERS)
        self.static = tuple(None if t is None else t.clone() for t in inputs)
        self.sources = self._sources(inputs)
        self.new_inputs = (False,) * len(inputs)
        before = self._counts()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), torch.cuda.graph(self.graph):
            self.out = fn(*self.static)
        self.launches = tuple(a - b for a, b in zip(self._counts(), before))
        self._add(tuple(-n for n in self.launches))

    @staticmethod
    def _sources(inputs: tuple) -> tuple:
        return tuple(None if t is None else weakref.ref(t) for t in inputs)

    def _counts(self) -> tuple:
        return tuple(getattr(obj, name) for obj, name in self.counters)

    def _add(self, launches: tuple):
        for (obj, name), n in zip(self.counters, launches):
            setattr(obj, name, getattr(obj, name) + n)

    def replay(self, inputs: tuple):
        """The outputs of `fn(*inputs)`, fresh tensors, by one replay.
        `new_inputs` tells for each input whether it is another tensor than
        the one copied into its place last (by the capture or a replay)."""
        self.new_inputs = tuple(r is not None and r() is not t for r, t in zip(self.sources, inputs))
        self.sources = self._sources(inputs)
        with torch.cuda.device(self.device):
            for dst, src in zip(self.static, inputs):
                if dst is not None:
                    dst.copy_(src)
            self.graph.replay()
            self._add(self.launches)
            return _clone(self.out)


class GraphCache:
    """At most `size` keys, each None after its first call (which runs
    eagerly) or its `Graph`."""

    def __init__(self, size: int):
        self.size = size
        self.entries = collections.OrderedDict()

    def graph(self, key, fn, inputs: tuple):
        """(graph, captured): None at the key's first call, the graph
        captured now at its second, the cached one after."""
        entry = self.entries.pop(key, _UNSEEN)
        captured = entry is None
        if captured:
            entry = Graph(fn, inputs)
        elif entry is _UNSEEN:
            entry = None
        self.entries[key] = entry
        if len(self.entries) > self.size:
            self.entries.popitem(last=False)
        return entry, captured
