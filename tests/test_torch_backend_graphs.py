"""The SLAM backend's programs as the reference runs them: local BA, the
loop slate (`verify_loop_slate` + `_pack_slate_result`) and the place
query, each a function of device tensors that `SlamSystem` replays on
the card as a CUDA graph captured over the step graph's static state
(`StepGraph(..., over=step_graph)`, `slam1_tpu_torch/utils/graphs.py`).

On the CPU the graphs cannot be captured, so:
  - each program, with its host integers turned into 0-d tensors
    (`end_kf`; `q_row` and `max_frame`), reads nothing back to the host
    (what a capture needs) and equals the JAX package's on the same
    numpy inputs, within the tolerances of
    tests/test_torch_ba_pipeline.py (after a BA step `traj`, `kf.poses`,
    `rel` within 1e-3, `map.xyz` within 1e-5 times the squared distance,
    at least 10 m; the cost within 1e-3 relative) and
    tests/test_torch_loop_pgo.py (the slate's T within 1e-4, its
    anchors, inlier counts and `ok` identical; place_query identical);
  - a `SlamSystem` whose step and backend run through eagerly emulated
    graphs (the same static state, loads and write-backs as on the card)
    ends equal to the bit to `graphs=False`, over checkpoints, BoW
    training, place queries, slates and a poll in which the live PGO
    (its own graphs: tests/test_torch_pgo_graphs.py) writes back before
    local BA replays;
  - a backend graph over a state that does not fit the step graph's, or
    over a step graph not yet captured, raises.
A test in tests/test_torch_kernels_cuda.py replays the real graphs on
the card.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam1_tpu.models import loop_closure as jlc
from slam1_tpu.models import pipeline as jpipe
from slam1_tpu_torch.config import tiny_config
from slam1_tpu_torch.models import pipeline as tpipe
from slam1_tpu_torch.utils import graphs, interop, synthetic
from test_torch_ba_pipeline import _cfgs, _compare_states, _jstate, \
    _tstate, carried  # noqa: F401
from test_torch_loop_pgo import _place_store, _slate_inputs, t
from torch_graph_helpers import HostReads, same_bits
from torch_graph_helpers import emulated_graphs  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


def _i64(v):
    return torch.tensor(v, dtype=torch.int64)


def _place_cfg():
    cfg = tiny_config()
    return cfg.replace(bow=dataclasses.replace(
        cfg.bow, place_topk=3, place_thresh=32, place_nms_frames=15))


# ------------------------------------------------------------ host reads

def test_backend_programs_read_nothing_back_to_the_host(carried):
    exported, _, tcam = carried
    _, tcfg = _cfgs()
    st = _tstate(exported)
    end = _i64(8)
    with HostReads() as rec:
        tpipe._graphed_local_ba(tcam, tcfg)(st, end)
    assert rec.ops == []

    cfg, cam, store, cands, hits, _, u = _slate_inputs()
    state = types.SimpleNamespace(kf=interop.kf_store(store, "cpu"))
    args = (t(u), t(cands).long(), t(hits).long())
    slate = tpipe._graphed_slate(interop.camera(cam, "cpu"), tiny_config())
    with HostReads() as rec:
        slate(state, *args)
    assert rec.ops == []

    state = types.SimpleNamespace(kf=interop.kf_store(_place_store(0),
                                                      "cpu"))
    q_row, max_frame = _i64(13), _i64(40)
    with HostReads() as rec:
        tpipe._graphed_place_query(_place_cfg(), 16)(state, q_row,
                                                     max_frame)
    assert rec.ops == []


# ------------------------------------------------ the programs against JAX

def test_local_ba_program_with_a_device_end_kf_matches_jax(carried):
    exported, jcam, tcam = carried
    jcfg, tcfg = _cfgs()
    t_in = _tstate(exported)
    js, jcost = jpipe.local_ba_step(_jstate(exported), jcam, jcfg,
                                    end_kf=jnp.asarray(8, jnp.int32))
    ts, tcost = tpipe._graphed_local_ba(tcam, tcfg)(t_in, _i64(8))
    assert tcost.dim() == 0
    assert abs(float(tcost) - float(jcost)) <= 1e-3 * float(jcost)
    window = list(range(8 - tcfg.ba.window, 8))        # keyframe = frame
    _compare_states(ts, js, t_in, window, window)


def test_slate_program_matches_jax():
    cfg, cam, store, cands, hits, keys, u = _slate_inputs()
    jres = jlc.verify_loop_slate(keys, jax.tree.map(jnp.asarray, store),
                                 jnp.asarray(cands), jnp.asarray(hits), cam,
                                 cfg)
    jpacked = np.asarray(jpipe._pack_slate_result(jres))
    state = types.SimpleNamespace(kf=interop.kf_store(store, "cpu"))
    out_state, packed = tpipe._graphed_slate(
        interop.camera(cam, "cpu"), tiny_config())(
            state, t(u), t(cands).long(), t(hits).long())
    assert out_state is state and packed.shape == (8, 19)
    packed = packed.numpy()
    np.testing.assert_array_equal(packed[:, 16:], jpacked[:, 16:])
    np.testing.assert_allclose(packed[:, :16], jpacked[:, :16], rtol=0,
                               atol=1e-4)
    ok = packed[:, 18] > 0.5
    assert ok[:4].sum() >= 2 and not ok[4:].any()


@pytest.mark.parametrize("n_rows,max_frame", [(8, 40), (16, 30), (16, 200)])
def test_place_query_program_with_device_scalars_matches_jax(n_rows,
                                                            max_frame):
    st = _place_store(n_rows + max_frame)
    cj, sj = jlc.place_query(jax.tree.map(jnp.asarray, st), 13, max_frame,
                             n_rows, k=3, thresh=32, nms_frames=15)
    state = types.SimpleNamespace(kf=interop.kf_store(st, "cpu"))
    _, (ct, sc) = tpipe._graphed_place_query(_place_cfg(), n_rows)(
        state, _i64(13), _i64(max_frame))
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(sc.numpy(), np.asarray(sj))
    assert (ct.numpy() >= 0).any()


# ------------------------------------------- SlamSystem through the graphs

def _logged_run(world, lefts, rights, cfg, graphed):
    """The 48-frame clip through SlamSystem: frames 1-8 by process, 9-44
    in blocks of 4, 45-47 by process (no poll), then finalize, whose
    poll consumes the slate that closes the loop: its live PGO writes
    back before that poll's local BA. Returns (system, poses after
    finalize, the rows of frames 1-8, [(frame, call)] of the backend)."""
    sys_ = tpipe.SlamSystem(world.cam, cfg, seed=2, bow_train_frame=8,
                            graphs=graphed)
    log = []
    backend, run_pgo = sys_._backend, sys_._run_pgo

    def logged_backend(name, fn, *inputs):
        log.append((sys_.frame_count, name))
        out = backend(name, fn, *inputs)
        if sys_.step_graph is not None:  # the state is the shared one
            assert sys_.state is sys_.step_graph._state_like
        return out

    def logged_pgo(iters=None):
        log.append((sys_.frame_count, "pgo"))
        return run_pgo(iters)
    sys_._backend, sys_._run_pgo = logged_backend, logged_pgo
    sys_.process(lefts[0], rights[0])
    rows = [sys_.process(lefts[i], rights[i]) for i in range(1, 9)]
    for s in range(9, 45, 4):
        sys_.process_block(lefts[s:s + 4], rights[s:s + 4])
    for i in range(45, 48):
        sys_.process(lefts[i], rights[i])
    return sys_, sys_.finalize(), rows, log


def test_slam_system_backend_graphs_equal_eager(emulated_graphs, tmp_path):
    cfg = tiny_config()
    h, w = cfg.image.height, cfg.image.width
    world = synthetic.make_world(3, n_frames=48, n_points=1200,
                                 trajectory="loop", speed=0.9,
                                 image_hw=(h, w), device="cpu")
    lefts, rights = synthetic.render_sequence(world, h, w)
    runs = {}
    for graphed in (True, False):
        run_cfg = cfg.replace(
            bow=dataclasses.replace(cfg.bow, place_query=True),
            runtime=dataclasses.replace(
                cfg.runtime, checkpoint_every=16,
                checkpoint_dir=str(tmp_path / str(graphed))))
        runs[graphed] = _logged_run(world, lefts, rights, run_cfg, graphed)
    (g, g_post, g_rows, g_log), (e, e_post, e_rows, e_log) = (runs[True],
                                                              runs[False])
    assert g_log == e_log
    # the last poll: the live PGO, then local BA on its write-back
    last = [call for f, call in g_log if f == 47]
    assert last.index("pgo") < last.index("local_ba")
    pgo = {"pgo_build[512]", "pgo_gn[512]", "pgo_apply[512]"}
    assert set(g.backend_graphs) == {"local_ba", "slate",
                                     "place_query[128]"} | pgo
    assert e.backend_graphs == {}
    for name, graph in g.backend_graphs.items():
        assert graph.over is g.step_graph and graph.replays > 0, name
        assert graph._state is g.step_graph._state, name
    # every relaxation (the live ones and finalize's) ran as the PGO
    # programs, the first of them as their captures: one pgo_gn replay
    # per Gauss-Newton iteration after the first
    runs = len(g.pgo_costs)
    live_iters = max(cfg.ba.pg_iters // 5, 3)
    gn = g.backend_graphs["pgo_gn[512]"]
    assert runs >= 2 and runs == len(e.pgo_costs)
    assert gn.replays == (runs - 1) * live_iters + cfg.ba.pg_iters - 1
    assert g.backend_graphs["pgo_build[512]"].replays == runs - 1
    assert g.backend_graphs["pgo_apply[512]"].replays == runs - 1
    # the PGO writes back in place: no backend graph loaded a leaf
    assert all(graph.loaded == 0 for graph in g.backend_graphs.values())
    np.testing.assert_array_equal(g_post, e_post)
    assert same_bits(g.state, e.state)
    assert all(torch.equal(a, b) for a, b in zip(g_rows, e_rows))
    assert g.metrics == e.metrics and len(g.loop_edges) >= 1
    assert [(i, j, w) for i, j, _, w in g.loop_edges] == \
        [(i, j, w) for i, j, _, w in e.loop_edges]
    assert all(np.array_equal(a[2], b[2])
               for a, b in zip(g.loop_edges, e.loop_edges))
    assert [dataclasses.astuple(x) for x in g.loop_events] == \
        [dataclasses.astuple(x) for x in e.loop_events]
    assert len(g.ba_costs) == len(e.ba_costs) > 0
    assert torch.equal(torch.stack(g.ba_costs), torch.stack(e.ba_costs))


# ------------------------------------------------ shared state, refusals

def test_a_backend_graph_runs_over_the_step_graphs_state(emulated_graphs):
    def step(s, x):
        return (s[0] + x, s[1]), s[0].sum()

    def backend(s, k):
        return (s[0], s[1] * k), (s[1] * k)[0, 0]

    state = (torch.zeros(3), torch.ones(2, 2))
    step_graph = graphs.StepGraph(step, "step")
    back = graphs.StepGraph(backend, "backend", over=step_graph)
    with pytest.raises(ValueError, match="not captured yet"):
        back(state, torch.full((), 2.0))
    state, _ = step_graph(state, torch.ones(1))
    static = step_graph._state
    out_state, out = back(state, torch.full((), 2.0))
    # nothing cloned: the write-back lands in the step graph's leaves
    assert out_state is step_graph._state_like and back._state is static
    assert static[1].tolist() == [[2.0, 2.0], [2.0, 2.0]] and out == 2.0
    out_state, out = back(out_state, torch.full((), 3.0))
    assert static[1][0, 0] == 6.0 and out == 6.0
    # a leaf rebound outside the graphs is loaded into the shared state
    rebound = (static[0], torch.full((2, 2), 5.0))
    back(rebound, torch.full((), 1.0))
    assert static[1].tolist() == [[5.0, 5.0], [5.0, 5.0]]
    assert back.loaded == 1
    state, _ = step_graph(step_graph._state_like, torch.ones(1))
    assert static[0].tolist() == [2.0, 2.0, 2.0]
    # a state that is not the step graph's does not fit
    with pytest.raises(ValueError, match="does not fit"):
        back((static[0], torch.ones(3, 3)), torch.full((), 1.0))
    with pytest.raises(ValueError):
        back((static[0],), torch.full((), 1.0))
    with pytest.raises(ValueError, match="does not fit"):
        back(state, torch.full((1,), 1.0))
