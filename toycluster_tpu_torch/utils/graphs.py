"""Programs of the WVT loop: a function of tensors captured once as a
CUDA graph on static buffers and replayed (the counterpart of a
``jax.jit`` program of the JAX package).

``capture`` records a function into a graph on the side stream and into
the memory pool of a ``CapturePool``; ``Program`` holds a function's
static input buffers and its graph: a run copies the inputs in, replays
the graph and clones the outputs out, so a later run cannot overwrite
what a caller still reads.
On the CPU a program runs the function on its buffers, without a graph.
"""

from __future__ import annotations

import contextlib

import torch


class CapturePool:
    """The side stream and the graph memory pool that a set of programs
    (those of one WVT relaxation) are captured on and into, made at the
    first capture."""

    def __init__(self):
        self.stream = self.handle = None

    def get(self):
        if self.stream is None:
            self.stream = torch.cuda.Stream()
            self.handle = torch.cuda.graph_pool_handle()
        return self.stream, self.handle


def capture(fn, pool):
    """(graph, ``fn()``): ``fn`` captured into a CUDA graph on the stream
    and into the memory pool of ``pool`` (a ``CapturePool``).  Raises
    where the capture fails (a host sync inside ``fn``, for one)."""
    stream, handle = pool.get()
    graph = torch.cuda.CUDAGraph()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin(pool=handle)
        try:
            out = fn()
        except BaseException:
            with contextlib.suppress(RuntimeError):
                graph.capture_end()
            raise
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    return graph, out


class Program:
    """``fn(*args)`` on static buffers shaped as ``args``, returning a
    tuple of tensors.  ``capture`` (CUDA) records it; ``run(args)``
    copies ``args`` in, replays the graph (or, without one, calls ``fn``
    on the buffers) and returns clones of the outputs."""

    def __init__(self, fn, args):
        self.fn = fn
        self.inputs = [torch.empty_like(a) for a in args]
        self.graph = self.outputs = None

    def capture(self, pool):
        self.graph, self.outputs = capture(lambda: self.fn(*self.inputs),
                                           pool)

    def run(self, args):
        for buf, a in zip(self.inputs, args):
            buf.copy_(a)
        if self.graph is None:
            out = self.fn(*self.inputs)
        else:
            self.graph.replay()
            out = self.outputs
        return tuple(o.clone() for o in out)
