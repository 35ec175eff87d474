"""Per-frame steps as captured CUDA graphs (the counterpart of the
reference's jitted `vo_step` / `slam_step`, one compiled device program
per frame with the state donated).

A `StepGraph` wraps a step function `fn(state, *inputs) -> (state,
out)` whose state and inputs are trees (tuples, NamedTuples) of CUDA
tensors. Its first call runs `fn` eagerly on a side stream, on a copy
of the state that becomes the graph's static state: that call is the
warm-up (it builds the kernels, the per-device caches and cuBLAS's
workspace on the stream the capture uses) and the frame's real step.
Then one call of `fn` is captured under `torch.cuda.graph`, followed by
copies of every new state leaf back into its static leaf. Each later
call replays the graph once:

  - `load(state)` copies into the static state only the leaves whose
    tensor is not the static one: after a write-back from outside the
    step (local BA, PGO, BoW training, a checkpoint load) the next replay
    reads the new values, and leaves the step updates in place cost
    nothing;
  - the frame's inputs (images, draws) are copied into their static
    buffers and the graph is launched on the current stream.

The returned state is the static state itself, so a state handed to a
step is consumed by it, as the reference's donation consumes it. `out`
lives in the graph's memory pool and is overwritten by the next replay:
a caller that keeps it past that copies it.

A replay makes no call of the kernel wrappers, whose launch counters
count in Python (`ops/cuda_kernels.py`). The graph records how many
launches of each kernel it captured and adds them to the counters at
each replay, so the counts equal an eager run's.

Each replay runs inside the span `replay:<name>` (`utils/metrics.py`),
which holds `host:load.<base>` (the copies of the state and the inputs)
and `host:launch.<base>` (the launch, timed on the card by an event pair
while spans record); a capture runs inside `host:capture.<base>`, where
`<base>` is the name up to its first `[`. The counters `graph_captures`
and `graph_replays` count them.

A graph may be captured over another graph's static state (`over`):
the SLAM backend's programs (local BA, the loop slate, the place query)
read the step graph's static state as their state input and write
their new leaves back into it in place, so that no state is cloned and
the next step replay copies nothing. Such a graph shares the memory
pool of the graph it runs over: the graphs replay one at a time on one
stream, and what a replay returns is valid until the next replay of
any graph of the pool, so a caller copies it first.

A step that runs collectives (the distributed solvers under NCCL)
counts them in Python too (`Mesh.comm`). A call given `counters` (such
a dict of integer counters) has its capture record what the captured
call added to them, which it then takes back, and each replay adds the
same amounts, so the totals equal an eager run's. A graph of
collectives belongs to the communicator it captured: whoever destroys
the process group drops the graph first.

A capture that fails, or a call whose state or inputs differ in
structure, shape, dtype or device from the captured ones, raises;
nothing falls back to eager execution.

The standalone solvers (`ba.bundle_adjust`, `pipeline.global_ba_step`,
`posegraph.optimize` and the sharded `dist_ba` / `dist_pgo`) run through
three pieces of this module, as jax.jit runs a function:

  - `graphed(x, mesh, wanted)`, the one rule for graphs or eager: a
    card's tensors (under NCCL where a mesh is given), where the caller
    wants graphs;
  - `GRAPHS`, the one registry of their graphs, (kind, key, name) ->
    StepGraph, where `kind` is the solver that owns the graph and `key`
    what its function reads: the device, the structure, shapes and
    dtypes of its state and inputs, and its static arguments. Two
    solvers that run the same function on the same shapes replay one
    graph (`ba_lm` of `bundle_adjust` and `global_ba_step`);
  - `iterate`, the one loop: a `Stage`'s function replayed `iters`
    times on a carry, then the end stage, then the result copied out of
    the graphs' pools. Eager, the same functions run on the same carry.
"""

from __future__ import annotations

import collections.abc
import ctypes
import time
from typing import Callable, NamedTuple

import torch

from slam1_tpu_torch.ops import cuda_kernels
from slam1_tpu_torch.utils import metrics
from slam1_tpu_torch.utils.tree import flatten, unflatten


def _check_tensors(tree):
    """Raise unless every leaf of the tree is a tensor."""
    for leaf in flatten(tree):
        if not isinstance(leaf, torch.Tensor):
            raise TypeError(f"a step graph's leaves are tensors, got "
                            f"{type(leaf).__name__}")


def load_leaves(static: list, leaves: list) -> int:
    """Copy leaves[i] into static[i] where it is not that tensor; returns
    how many were copied. Raises where the trees differ in their leaf
    count, or a leaf in shape, dtype or device."""
    copied = 0
    for s, x in zip(static, leaves, strict=True):
        if x is s:
            continue
        if x.shape != s.shape or x.dtype != s.dtype or x.device != s.device:
            raise ValueError(f"leaf {tuple(x.shape)} {x.dtype} on "
                             f"{x.device} does not fit the captured "
                             f"{tuple(s.shape)} {s.dtype} on {s.device}")
        s.copy_(x)
        copied += 1
    return copied


def _write_back(static: list, leaves: list):
    """Copy the step's new state leaves into the static state. A new
    leaf that shares memory with a static leaf (but is not it) is cloned
    first, so that no copy reads a leaf another copy has written."""
    storages = {s.untyped_storage().data_ptr() for s in static}
    pending = []
    for s, x in zip(static, leaves, strict=True):
        if x is s:
            continue
        if x.shape != s.shape or x.dtype != s.dtype:
            raise ValueError(f"the step changed a state leaf from "
                             f"{tuple(s.shape)} {s.dtype} to "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.untyped_storage().data_ptr() in storages:
            x = x.clone()
        pending.append((s, x))
    for s, x in pending:
        s.copy_(x)


def copy_out(tree):
    """The tree with every leaf cloned: what a caller keeps of a replay's
    output or static state past the next replay of the graph's pool."""
    return unflatten(tree, iter([x.clone() for x in flatten(tree)]))


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """Nodes of a graph captured with keep_graph=True (the driver's
    cuGraphGetNodes)."""
    n = ctypes.c_size_t(0)
    err = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    if err:
        raise RuntimeError(f"cuGraphGetNodes: CUDA driver error {err}")
    return n.value


class StepGraph:
    """One step function captured as a CUDA graph at its first call and
    replayed at every later one (see the module docstring). `name`
    labels errors and measurements; `key` says what the caller made the
    graph for, to compare before reusing it."""

    def __init__(self, fn, name: str, key=None,
                 over: "StepGraph | None" = None):
        self.fn = fn
        self.name = name
        self.key = key
        self.over = over             # the graph whose static state it uses
        self.graph = None
        self._state_like = None      # the static state tree
        self._state = None           # its leaves
        self._inputs = None          # static input leaves
        self._out = None             # the captured call's `out`
        self.launches = {}           # kernel launches one replay makes
        self.capture_seconds = None  # warm-up step + capture, host clock
        self.pool_bytes = None       # memory the capture reserved
        self.nodes = None            # nodes of the captured graph
        self.replays = 0
        self.loaded = 0              # state leaves copied by load()
        self.counted = {}            # what one replay adds to `counters`
        base = name.split("[", 1)[0]
        self._spans = (f"replay:{name}", f"host:load.{base}",
                       f"host:launch.{base}", f"host:capture.{base}")

    def __call__(self, state, *inputs, counters=None):
        """(state, out) of one step: the captured graph replayed, or at
        the first call the warm-up step followed by the capture.
        `counters`: a dict of integer counters the step adds to (see the
        module docstring), or None."""
        if self.graph is None:
            with metrics.span(self._spans[3]):
                return self._capture(state, inputs, counters)
        with metrics.span(self._spans[0]):
            with metrics.span(self._spans[1]):
                self.load(state)
                load_leaves(self._inputs, flatten(inputs))
            with metrics.span(self._spans[2], device=True):
                self._launch()
        self.replays += 1
        metrics.count("graph_replays")
        for name, n in self.launches.items():
            cuda_kernels._COUNTED[name].launches += n
        if counters is not None:
            for name, n in self.counted.items():
                counters[name] += n
        return self._state_like, self._out

    def _launch(self):
        """Launch the captured graph on the current stream (the CPU
        tests' emulated graphs run the step eagerly here instead)."""
        self.graph.replay()

    def load(self, state):
        """Make the static state hold `state`: copy each leaf that is not
        the static tensor itself. Returns the static state."""
        self.loaded += load_leaves(self._state, flatten(state))
        return self._state_like

    def _bind(self, state, inputs):
        """The static state (a clone of `state`, or the state of the graph
        this one runs over, loaded with `state`) and static inputs (clones
        of `inputs`) that the capture reads and the replays refill."""
        if self.over is None:
            self._state = [x.clone() for x in flatten(state)]
            self._state_like = unflatten(state, iter(self._state))
        else:
            if self.over.graph is None:
                raise ValueError(f"{self.name}: the graph it runs over, "
                                 f"{self.over.name}, is not captured yet")
            self.over.load(state)
            self._state = self.over._state
            self._state_like = self.over._state_like
        self._inputs = [x.clone() for x in flatten(inputs)]
        return unflatten(inputs, iter(self._inputs))

    def _capture(self, state, inputs, counters=None):
        _check_tensors((state, inputs))
        leaves = flatten(state) + flatten(inputs)
        dev = leaves[0].device
        if dev.type != "cuda" or any(x.device != dev for x in leaves):
            raise ValueError(f"{self.name}: a step graph takes CUDA tensors "
                             f"on one device")
        t0 = time.perf_counter()
        main = torch.cuda.current_stream(dev)
        # The static buffers are made on the stream that replays into
        # them; the warm-up and the capture run on a side stream.
        inputs_like = self._bind(state, inputs)
        static, state_like = self._state, self._state_like
        side = torch.cuda.Stream(dev)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            new, out = self.fn(state_like, *inputs_like)
            _write_back(static, flatten(new))
        side.synchronize()
        counts = cuda_kernels.launch_counts()
        before = dict(counters or {})
        # torch.cuda.graph empties the allocator's cache as it starts:
        # emptied here first, what the capture reserves is its pool.
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(dev)
        # Kept after the capture so that its nodes can be counted.
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        pool = None if self.over is None else self.over.graph.pool()
        try:
            with torch.cuda.graph(graph, pool=pool, stream=side,
                                  capture_error_mode="thread_local"):
                g_new, g_out = self.fn(state_like, *inputs_like)
                _write_back(static, flatten(g_new))
        except Exception as e:
            raise RuntimeError(f"{self.name}: CUDA graph capture failed: "
                               f"{e}") from e
        finally:
            captured = cuda_kernels.launch_counts()
            for name, fn in cuda_kernels._COUNTED.items():
                fn.launches = counts[name]
            if counters is not None:
                self.counted = {k: counters[k] - n for k, n in before.items()
                                if counters[k] != n}
                counters.update(before)
        self.nodes = graph_nodes(graph)
        graph.instantiate()
        main.wait_stream(side)
        self.pool_bytes = torch.cuda.memory_reserved(dev) - reserved
        self.launches = {k: captured[k] - counts[k] for k in counts
                         if captured[k] != counts[k]}
        self.graph = graph
        self._out = g_out
        metrics.count("graph_captures")
        torch.cuda.synchronize(dev)
        self.capture_seconds = time.perf_counter() - t0
        return state_like, out

    def stats(self) -> dict:
        """What a measurement reports of the graph."""
        return dict(capture_seconds=self.capture_seconds,
                    nodes=self.nodes, pool_bytes=self.pool_bytes,
                    launches_per_replay=self.launches,
                    replays=self.replays, leaves_loaded=self.loaded)


def graphed(x, mesh=None, wanted: bool = True) -> bool:
    """Whether work on tensors like `x` runs as replays of captured CUDA
    graphs (else eagerly): `x` on a card and, where a mesh is given, its
    backend NCCL (gloo stages its CUDA all_reduce itself and the ring
    shift through the host, neither of which a graph can hold), and only
    where the caller `wanted` graphs. Read from the device and the
    backend alone, before any capture."""
    return wanted and x.is_cuda and (mesh is None or mesh.backend == "nccl")


class Stage(NamedTuple):
    """One graph of a solver: `fn(state, *inputs) -> (state, out)`, its
    registry `kind` (the owning solver), `static` (what `fn` reads
    besides its tensors: its static arguments, hashable) and `name`
    (`<base>[<sizes>]`)."""
    kind: str
    static: tuple
    name: str
    fn: Callable


def _signature(tree) -> tuple:
    """The device, shapes and dtypes of a tree's tensor leaves."""
    leaves = flatten(tree)
    return (leaves[0].device,
            tuple((tuple(x.shape), x.dtype) for x in leaves))


class _KindView(collections.abc.Mapping):
    """One kind's graphs in the registry, live: {(key, name): StepGraph}
    in the order they were made; `clear()` drops them."""

    def __init__(self, registry: "GraphRegistry", kind: str):
        self._registry, self._kind = registry, kind

    def __getitem__(self, k):
        return self._registry._graphs[(self._kind, *k)]

    def __iter__(self):
        return (k[1:] for k in list(self._registry._graphs)
                if k[0] == self._kind)

    def __len__(self):
        return sum(1 for _ in self)

    def clear(self):
        self._registry.clear(self._kind)


class GraphRegistry:
    """The standalone solvers' graphs, (kind, key, name) -> StepGraph,
    each captured at the first call of its key and replayed after; their
    memory pools stay reserved until the graphs are dropped (`clear`). A
    graph of NCCL collectives belongs to its communicator: whoever
    destroys the process group clears its kind first
    (`parallel.clear_graphs`)."""

    def __init__(self):
        self._graphs: dict = {}

    def get(self, stage: Stage, state, inputs=()) -> StepGraph:
        """The stage's graph for this state and these inputs, made (not
        yet captured) where the registry has none."""
        key = (_signature((state, inputs)), stage.static)
        k = (stage.kind, key, stage.name)
        graph = self._graphs.get(k)
        if graph is None:
            graph = self._graphs[k] = StepGraph(stage.fn, stage.name,
                                                key=key)
        return graph

    def of(self, kind: str) -> _KindView:
        """The kind's graphs, a live view."""
        return _KindView(self, kind)

    def clear(self, kind: str | None = None):
        """Drop the kind's graphs (every graph without a kind)."""
        for k in [k for k in self._graphs if kind in (None, k[0])]:
            del self._graphs[k]


GRAPHS = GraphRegistry()


def run(stage: Stage, state, *inputs, graphed: bool = False,
        counters=None):
    """(state, out) of one stage: graphed, a replay of its registry graph
    (the capture at the first call of its key) with `counters` (see the
    module docstring); eager, its function called."""
    if not graphed:
        return stage.fn(state, *inputs)
    return GRAPHS.get(stage, state, inputs)(state, *inputs,
                                            counters=counters)


def iterate(step: Stage, end: Stage, carry, iters: int, inputs=(),
            end_inputs=(), keep=None, graphed: bool = False,
            counters=None):
    """A solver's loop: `step` `iters` times from `carry` with `inputs`,
    nothing read back to the host in between, then `end` with
    `end_inputs` -> keep(carry, end's out), or (carry, out) without
    `keep`. Graphed, each stage replays its registry graph (none is
    captured for a step that does not run, iters == 0) and what is kept
    is copied out of the graphs' pools; eager, the same functions run on
    the same carry."""
    for _ in range(iters):
        carry, _ = run(step, carry, *inputs, graphed=graphed,
                       counters=counters)
    carry, out = run(end, carry, *end_inputs, graphed=graphed,
                     counters=counters)
    kept = (carry, out) if keep is None else keep(carry, out)
    return copy_out(kept) if graphed else kept
