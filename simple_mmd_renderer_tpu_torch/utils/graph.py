"""A frame step as one CUDA-graph replay.

`CapturedStep(step, state)` holds the compiled form of `step: state ->
(state', *outputs)` for states of one shape, where a state is a tree of
tensors (dataclasses, tuples and lists of them: `SimState` with its
`PhysicsState`). It owns the static input buffers: a copy of the state,
which the step reads and into which it writes `state'` at its end, and the
step's outputs. `replay()` runs the step once from the buffers, so N
replays are N frames with nothing read on the host in between; the caller
copies a state in first with `load(state)`.

On the card the step is captured once into a CUDA graph with its own
private memory pool, after a warm-up run on a side stream (as
`torch.cuda.graphs` asks), both under `torch.cuda.set_sync_debug_mode(
"error")`: a step that would synchronise with the host, or copy from it,
raises there. Python's cyclic garbage collector runs just before the
capture and not during it, so that no dead graph is destroyed while the
stream captures. A failed capture raises; nothing falls back to running the
step eagerly on the card. A replay is one `cudaGraphLaunch`.

On the CPU there is no graph: `replay()` runs the step eagerly on the same
buffers and copies its outputs into the same output tensors, so a CPU run
has the card's buffer semantics (what a replay returns, the next replay
overwrites).

The step runs with a stage clock (`profiling.StepClock`): its stages
(`profiling.stage`) and the write-back of the state stamp the card's clock
inside the graph, and its CCD loops count their active chains there, a row
of the clock's ring per replay; the step counts its replays on the host,
and a replay made inside a recorded frame is noted there
(`profiling.note_replay`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc

import torch

from . import profiling


def tree_leaves(tree) -> list[torch.Tensor]:
    """The tensors of a tree of dataclasses, tuples and lists, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if dataclasses.is_dataclass(tree):
        return [t for f in dataclasses.fields(tree)
                for t in tree_leaves(getattr(tree, f.name))]
    if isinstance(tree, (tuple, list)):
        return [t for x in tree for t in tree_leaves(x)]
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def tree_map(fn, tree):
    """The tree with every tensor t replaced by fn(t)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: tree_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    raise TypeError(f"not a tree of tensors: {type(tree).__name__}")


def tree_copy_(dst, src) -> None:
    """Copy every tensor of `src` into the same place of `dst` (a tensor
    that is already the destination is left alone)."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src), strict=True):
        if d is not s:
            d.copy_(s)


def shape_key(tree) -> tuple:
    """The shapes of a tree's tensors: one graph per key."""
    return tuple(tuple(t.shape) for t in tree_leaves(tree))


@contextlib.contextmanager
def sync_errors():
    """torch.cuda.set_sync_debug_mode("error") for the body: an operation
    that synchronises with the host raises."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


class CapturedStep:
    """`step` compiled for states shaped like `state` (see the module
    docstring); `state` and `outputs` are the static buffers."""

    def __init__(self, step, state):
        self.step = step
        self.state = tree_map(torch.clone, state)
        self.outputs = None
        self.graph = None
        leaf = tree_leaves(self.state)[0]
        self.clock = profiling.StepClock(leaf.device)
        if leaf.is_cuda:
            self._capture()

    def _body(self):
        with self.clock.running():
            new_state, *outputs = self.step(self.state)
            with profiling.stage("write_back"):
                tree_copy_(self.state, new_state)
        return tuple(outputs)

    def _capture(self) -> None:
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side), sync_errors(), self.clock.running():
            # lazy handles, the crowd views and the stamp kernel's module
            # are made here, outside the graph; the step is pure, so the
            # buffers keep the state
            self.step(self.state)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # a scene and its graphs form a reference cycle (the step closes
        # over the scene), so a dead scene's graphs are freed by the
        # cyclic collector; a graph destroyed while a stream captures
        # invalidates the capture: collect first, and not during it
        gc.collect()
        was_enabled = gc.isenabled()
        gc.disable()
        try:
            with torch.cuda.graph(graph):
                with sync_errors():
                    outputs = self._body()
        finally:
            if was_enabled:
                gc.enable()
        self.graph, self.outputs = graph, outputs
        self.clock.restart()

    def load(self, state) -> None:
        """Copy `state` into the input buffers."""
        tree_copy_(self.state, state)

    def replay(self):
        """One step from the buffers -> (state', *outputs), the buffers
        themselves: state' is the input buffer of the next replay."""
        profiling.note_replay(self.clock, self.clock.replays)
        if self.graph is not None:
            self.graph.replay()
        else:
            outputs = self._body()
            if self.outputs is None:
                self.outputs = outputs
            else:
                tree_copy_(self.outputs, outputs)
        self.clock.replays += 1
        return (self.state,) + self.outputs
