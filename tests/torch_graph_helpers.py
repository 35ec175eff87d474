"""What the CPU tests of the captured graphs share (not collected):

  - `HostReads`, a dispatch mode that records every operation that reads
    a tensor's value on the host or makes a tensor from host data: none
    may run inside a captured CUDA graph;
  - `same_bits`, two trees of tensors equal to the bit;
  - the `emulated_graphs` fixture: `StepGraph`'s capture and replay run
    eagerly on the CPU, with the same static state (its own clone, or
    the state of the graph it runs over), loads and write-backs as on
    the card, and the one rule that picks graphs (`graphs.graphed`)
    answers what the caller wants whatever the device and the backend,
    so every graphed path (SlamSystem, vo_block, the flow VO's
    `run_sequence` and the solvers of `graphs.iterate`) runs on CPU
    tensors (the kernels' plain twins still run, picked by the device,
    and the collectives go to the backend);
  - `emulate_graphs(monkeypatch)`, the fixture's patches as a plain
    function, for processes that take no fixture (the spawned ranks of
    `torch_dist_ranks.py`, given a `pytest.MonkeyPatch()`);
  - the `fresh_graphs` fixture: the solvers' graph registry
    (`graphs.GRAPHS`) empty for the test alone, returned; `by_base` and
    `one_each` list a registry's graphs by base name.

An emulated replay runs the step function again, so it counts the
collectives it makes itself and ignores a call's `counters`.

A test file takes them by importing them:

    from torch_graph_helpers import HostReads, same_bits
    from torch_graph_helpers import emulated_graphs  # noqa: F401
"""

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from slam1_tpu_torch.utils import graphs, tree

HOST_OPS = ("_local_scalar_dense", "nonzero", "masked_select", "unique",
            "bincount", "histc", "lift_fresh", "repeat_interleave")


class HostReads(TorchDispatchMode):
    """Records every operation that reads a value on the host or makes
    a tensor from host data: none may run inside a captured graph."""

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        if any(op in str(func) for op in HOST_OPS):
            self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def same_bits(a, b) -> bool:
    """Two trees of tensors with equal leaves, float32 compared as bits
    (equal NaNs are equal)."""
    def bits(x):
        return x.view(torch.int32) if x.dtype == torch.float32 else x
    return all(torch.equal(bits(x), bits(y))
               for x, y in zip(tree.flatten(a), tree.flatten(b),
                               strict=True))


@pytest.fixture
def emulated_graphs(monkeypatch):
    """StepGraph with its capture and replay run eagerly on the CPU: the
    same static state, loads and write-backs as on the card, and every
    graphed path taken for CPU tensors."""
    emulate_graphs(monkeypatch)


@pytest.fixture
def fresh_graphs(monkeypatch):
    """The solvers' graph registry, empty for the test alone."""
    monkeypatch.setattr(graphs.GRAPHS, "_graphs", {})
    return graphs.GRAPHS


def emulate_graphs(monkeypatch):
    """The `emulated_graphs` fixture's patches, made with `monkeypatch`
    (a pytest.MonkeyPatch; its `undo()` takes them back)."""

    def capture(self, state, inputs, counters=None):
        graphs._check_tensors((state, inputs))
        self._inputs_like = self._bind(state, inputs)
        new, out = self.fn(self._state_like, *self._inputs_like)
        graphs._write_back(self._state, tree.flatten(new))
        self.graph = "emulated"
        return self._state_like, out

    def launch(self):
        new, self._out = self.fn(self._state_like, *self._inputs_like)
        graphs._write_back(self._state, tree.flatten(new))

    monkeypatch.setattr(graphs.StepGraph, "_capture", capture)
    monkeypatch.setattr(graphs.StepGraph, "_launch", launch)
    monkeypatch.setattr(graphs, "graphed",
                        lambda x, mesh=None, wanted=True: wanted)


def by_base(registry, *kinds) -> dict:
    """{base name: [StepGraph, ...]} of the registry's graphs of `kinds`
    (`graphs.GRAPHS` or a `fresh_graphs`), in the order they were made."""
    out = {}
    for kind in kinds:
        for g in registry.of(kind).values():
            out.setdefault(g.name.split("[", 1)[0], []).append(g)
    return out


def one_each(registry, *kinds) -> dict:
    """{base name: StepGraph} of the registry's graphs of `kinds`, which
    hold one graph of each base name."""
    found = by_base(registry, *kinds)
    assert all(len(g) == 1 for g in found.values()), found
    return {name: g for name, (g,) in found.items()}
