"""The flow VO as the reference runs it: on CUDA tensors
`vo_flow.run_sequence` replays one captured CUDA graph of `vo_step` per
frame (`slam1_tpu_torch/models/vo_flow.py`, `utils/graphs.py`), with
the RANSAC draws made outside the step.

On the CPU the graph cannot be captured, so:
  - the flow `vo_step`, given its draws, is checked to read nothing back
    to the host and to make no tensor from host data (what a capture
    needs), with the dispatch mode of tests/torch_graph_helpers.py;
  - the draws made outside the step equal the ones `ransac_pnp` makes
    from the state's generator at the flow VO's slot count, and leave
    the generator where it does;
  - `run_sequence` through an eagerly emulated `StepGraph` (the same
    static state, loads and write-backs as on the card) equals a loop of
    eager `vo_step` calls to the bit: poses, every metric and the final
    state; and with the reference's draws it matches the JAX package's
    `run_sequence` at tests/test_torch_flow.py's tolerances.
A test marked `cuda` replays the real graph against eager steps where
there is a card. The file imports jax only inside the JAX test, so that
the card's test also runs on a machine without jax:

    python -m pytest --noconftest tests/test_torch_flow_graph.py -q -m cuda
"""

import numpy as np
import pytest
import torch

from slam1_tpu_torch.config import tiny_config
from slam1_tpu_torch.models import vo_flow
from slam1_tpu_torch.ops import cuda_kernels, pnp
from slam1_tpu_torch.utils import graphs, synthetic
from torch_graph_helpers import HostReads, same_bits
from torch_graph_helpers import emulated_graphs  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

N_FRAMES = 6


def _clip(device="cpu", n_frames=N_FRAMES):
    cfg = tiny_config()
    h, w = cfg.image.height, cfg.image.width
    world = synthetic.make_world(3, n_frames=n_frames, n_points=1500,
                                 speed=0.45, image_hw=(h, w), device=device)
    lefts, rights = synthetic.render_sequence(world, h, w)
    return cfg, world.cam, lefts, rights


@pytest.fixture
def made_graphs(monkeypatch):
    """Every StepGraph the flow VO makes, in order."""
    made = []

    class Recorded(graphs.StepGraph):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            made.append(self)
    monkeypatch.setattr(vo_flow, "StepGraph", Recorded)
    return made


def _eager(cfg, cam, lefts, rights, seed=0, draws=None):
    """A loop of eager vo_step calls: (final state, poses (F,4,4),
    metrics stacked over F-1)."""
    st = vo_flow.init_state(lefts[0], rights[0], cam, cfg, seed)
    poses, ms = [st.T_w_cam], []
    for i in range(1, lefts.shape[0]):
        st, m = vo_flow.vo_step(st, lefts[i], rights[i], cam, cfg,
                                u=None if draws is None else draws[i - 1])
        poses.append(st.T_w_cam)
        ms.append(m)
    return st, torch.stack(poses), vo_flow.FlowVOMetrics(
        *[torch.stack(v) for v in zip(*ms)])


def _same_run(poses, metrics, e_poses, e_metrics):
    """run_sequence's numpy outputs equal to the bit to an eager run's."""
    assert poses.dtype == np.float32
    np.testing.assert_array_equal(poses.view(np.int32),
                                  e_poses.cpu().numpy().view(np.int32))
    assert len(metrics) == e_poses.shape[0] - 1
    for name, col in zip(vo_flow.FlowVOMetrics._fields, e_metrics):
        got = np.stack([getattr(m, name) for m in metrics])
        want = col.cpu().numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got.view(np.uint8),
                                      want.view(np.uint8), err_msg=name)


# ------------------------------------------------------------ host reads

def test_flow_step_reads_nothing_back_to_the_host():
    cfg, cam, lefts, rights = _clip(n_frames=2)
    st = vo_flow.init_state(lefts[0], rights[0], cam, cfg)
    u = pnp.draw_uniform(cfg.tracking.ransac_iters, st.prev_xy.shape[0],
                         st.generator, "cpu")
    with HostReads() as rec:
        vo_flow.vo_step(st, lefts[1], rights[1], cam, cfg, u=u)
    assert rec.ops == []


# ------------------------------------------------------------------ draws

def test_draws_made_outside_equal_the_flow_steps_own():
    """At the flow VO's slot count (the one-level detector's capacity),
    the (K,N) draws made before a step are the ones ransac_pnp draws
    from the state's generator: the same steps, the generator left in
    the same place."""
    cfg, cam, lefts, rights = _clip(n_frames=3)
    a = vo_flow.init_state(lefts[0], rights[0], cam, cfg, seed=4)
    b = vo_flow.init_state(lefts[0], rights[0], cam, cfg, seed=4)
    d = cfg.detector
    n = b.prev_xy.shape[0]
    assert n == d.grid_rows * d.grid_cols * d.kp_per_tile
    for i in (1, 2):
        a, ma = vo_flow.vo_step(a, lefts[i], rights[i], cam, cfg)
        u = pnp.draw_uniform(cfg.tracking.ransac_iters, n, b.generator,
                             "cpu")
        b, mb = vo_flow.vo_step(b, lefts[i], rights[i], cam, cfg, u=u)
        assert same_bits(tuple(a)[:-2], tuple(b)[:-2])
        assert same_bits(ma, mb)
        assert torch.equal(a.generator.get_state(), b.generator.get_state())


# ------------------------------------------------------ the graphed path

def test_run_sequence_through_a_step_graph_equals_vo_steps(emulated_graphs,
                                                           made_graphs):
    cfg, cam, lefts, rights = _clip()
    est, e_poses, e_metrics = _eager(cfg, cam, lefts, rights, seed=1)
    poses, metrics = vo_flow.run_sequence(lefts, rights, cam, cfg, seed=1)
    _same_run(poses, metrics, e_poses, e_metrics)
    # One graph: its first call is the capture, every later frame a
    # replay, and its static state is the final state.
    (graph,) = made_graphs
    assert graph.replays == N_FRAMES - 2
    assert same_bits(graph._state_like, tuple(est)[:-2])

    # The draws a caller gives replace the generator's.
    g = torch.Generator().manual_seed(9)
    n = est.prev_xy.shape[0]
    draws = [pnp.draw_uniform(cfg.tracking.ransac_iters, n, g, "cpu")
             for _ in range(N_FRAMES - 1)]
    _, e_poses, e_metrics = _eager(cfg, cam, lefts, rights, draws=draws)
    poses, metrics = vo_flow.run_sequence(lefts, rights, cam, cfg,
                                          draws=draws)
    _same_run(poses, metrics, e_poses, e_metrics)
    assert len(made_graphs) == 2


def test_run_sequence_takes_the_eager_loop_on_the_cpu(made_graphs):
    cfg, cam, lefts, rights = _clip(n_frames=3)
    poses, metrics = vo_flow.run_sequence(lefts, rights, cam, cfg)
    assert made_graphs == []
    assert poses.shape == (3, 4, 4) and len(metrics) == 2


def test_graphed_run_sequence_matches_jax(emulated_graphs, made_graphs):
    """The graphed path with the reference's key chain replayed as draws
    against the JAX package's run_sequence."""
    jax = pytest.importorskip("jax")      # not on the card's machine
    import test_torch_flow as ref
    from slam1_tpu_torch.utils import interop
    clip = ref.reference_clip()
    cfg, world, lefts, rights = clip
    pt, mt = vo_flow.run_sequence(
        torch.as_tensor(lefts), torch.as_tensor(rights),
        interop.camera(jax.device_get(world.cam), "cpu"), tiny_config(),
        draws=ref.reference_draws(cfg, lefts.shape[0] - 1))
    assert made_graphs[0].replays == lefts.shape[0] - 2
    ref.held_to_reference(clip, pt, mt)


# --------------------------------------------------------------- the card

@pytest.mark.cuda
def test_flow_graph_replays_equal_eager_steps_on_the_card(made_graphs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    cfg, cam, lefts, rights = _clip("cuda", n_frames=8)
    cuda_kernels.reset_launch_counts()
    est, e_poses, e_metrics = _eager(cfg, cam, lefts, rights, seed=2)
    e_counts = cuda_kernels.launch_counts()
    cuda_kernels.reset_launch_counts()
    poses, metrics = vo_flow.run_sequence(lefts, rights, cam, cfg, seed=2)
    assert cuda_kernels.launch_counts() == e_counts
    assert e_counts["fast_score"] == lefts.shape[0]
    _same_run(poses, metrics, e_poses, e_metrics)
    (graph,) = made_graphs
    assert graph.replays == lefts.shape[0] - 2 and graph.nodes > 0
    assert same_bits(graph._state_like, tuple(est)[:-2])

    # A warm replay reads nothing back to the host.
    u = pnp.draw_uniform(cfg.tracking.ransac_iters, est.prev_xy.shape[0],
                         est.generator, lefts.device)
    carry = graph._state_like
    graph(carry, lefts[3], rights[3], u)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        graph(carry, lefts[4], rights[4], u)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
