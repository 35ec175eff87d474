"""What the CPU tests of the captured graphs share (not collected):

  - `HostReads`, a dispatch mode that records every operation that reads
    a tensor's value on the host or makes a tensor from host data: none
    may run inside a captured CUDA graph;
  - `same_bits`, two trees of tensors equal to the bit;
  - the `emulated_graphs` fixture: `StepGraph`'s capture and replay run
    eagerly on the CPU, with the same static state (its own clone, or
    the state of the graph it runs over), loads and write-backs as on
    the card, and the graphed paths of `SlamSystem`, `vo_block`, the
    flow VO's `run_sequence`, `posegraph.optimize`, `ba.bundle_adjust`
    and the sharded solvers (`mesh.capturable`) taken for CPU tensors
    (the kernels' plain twins still run and the collectives go to the
    backend: only the choice of the graphed path is patched);
  - `emulate_graphs(monkeypatch)`, the fixture's patches as a plain
    function, for processes that take no fixture (the spawned ranks of
    `torch_dist_ranks.py`, given a `pytest.MonkeyPatch()`).

An emulated replay runs the step function again, so it counts the
collectives it makes itself and ignores a call's `counters`.

A test file takes them by importing them:

    from torch_graph_helpers import HostReads, same_bits
    from torch_graph_helpers import emulated_graphs  # noqa: F401
"""

import types

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from slam1_tpu_torch.models import ba as tba
from slam1_tpu_torch.models import pipeline as tpipe
from slam1_tpu_torch.models import posegraph as tposegraph
from slam1_tpu_torch.models import vo, vo_flow
from slam1_tpu_torch.ops import dispatch
from slam1_tpu_torch.parallel import mesh as mesh_mod
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
    same static state, loads and write-backs as on the card, and the
    graphed paths of SlamSystem, vo_block, vo_flow.run_sequence,
    posegraph.optimize, ba.bundle_adjust and the sharded solvers taken
    for CPU tensors."""
    emulate_graphs(monkeypatch)


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
    card = types.SimpleNamespace(use_cuda=lambda t: True)
    monkeypatch.setattr(tpipe, "dispatch", card)
    monkeypatch.setattr(vo, "dispatch", card)
    monkeypatch.setattr(vo_flow, "dispatch", card)
    # BA's CG-path kernels (the reduced-system halves and the observation
    # pass) stay dispatched by their tensors' device (the plain twins
    # here).
    monkeypatch.setattr(tba, "dispatch", types.SimpleNamespace(
        use_cuda=card.use_cuda, schur_order=dispatch.schur_order,
        ba_schur_landmarks=dispatch.ba_schur_landmarks,
        ba_schur_cameras=dispatch.ba_schur_cameras,
        ba_obs_cameras=dispatch.ba_obs_cameras,
        ba_obs_landmarks=dispatch.ba_obs_landmarks,
        ba_obs_cost=dispatch.ba_obs_cost))
    # The pose graph's chain kernels stay dispatched by their tensors'
    # device (the plain twins here).
    monkeypatch.setattr(tposegraph, "dispatch", types.SimpleNamespace(
        use_cuda=card.use_cuda, chain_prepare=dispatch.chain_prepare,
        chain_sweep=dispatch.chain_sweep))
    monkeypatch.setattr(mesh_mod, "capturable", lambda mesh, x: True)
