"""The one way the standalone solvers run as CUDA graphs
(`slam1_tpu_torch/utils/graphs.py`): the rule `graphed`, the registry
`GRAPHS` and the runner `iterate`, which `ba.bundle_adjust`,
`pipeline.global_ba_step`, `posegraph.optimize` and the sharded
`dist_ba` / `dist_pgo` run through.

On the CPU the graphs cannot be captured, so for each of the five
solvers, through eagerly emulated graphs (`torch_graph_helpers`):
  - the runner's result equals `graphs=False` to the bit, at the
    capturing call and at a replaying call;
  - a second call with the same key captures nothing: the registry holds
    the same graphs, each replayed as often as the loop runs it;
  - `GRAPHS.clear(kind)` drops that kind's graphs and no other kind's,
    and `ba.BA_GRAPHS.clear()` drops BA's;
and the runner with no iteration captures no step graph, and without
graphs wanted nothing enters the registry. tests/test_torch_dist_graphs.py
holds the rule `graphed` to the device and the backend.
tests/test_torch_kernels_cuda.py replays the real graphs on the card.
"""

import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from slam1_tpu_torch import parallel
from slam1_tpu_torch.config import BAConfig, tiny_config
from slam1_tpu_torch.models import ba, pipeline, posegraph
from slam1_tpu_torch.parallel import dist_ba, dist_pgo
from slam1_tpu_torch.parallel import mesh as mesh_mod
from slam1_tpu_torch.utils import graphs, synthetic
from test_torch_dist_graphs import _t, ba_inputs, pgo_inputs
from torch_graph_helpers import one_each, same_bits
from torch_graph_helpers import emulated_graphs, fresh_graphs  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

BA_CFG = BAConfig(lm_iters=3, cg_iters=10)
# The registry kinds a solver's graphs go to, and how often one call
# replays each of its graphs by base name.
SOLVERS = {
    "ba": (("ba",), {"ba_lm": 3, "ba_cost": 1}),
    "global_ba": (("global_ba", "ba"),
                  {"ba_build": 1, "ba_lm": 3, "ba_apply": 1}),
    "posegraph": (("posegraph",), {"pg_gn": 3, "pg_cost": 1}),
    "dist_ba": (("dist_ba",), {"dba_lm": 3, "dba_cost": 1}),
    "dist_pgo": (("dist_pgo",), {"dpg_gn": 3, "dpg_cost": 1}),
}


@pytest.fixture(scope="module")
def slam_state():
    """The port's state after 12 frames of the loop clip at tiny_config()
    on the CPU, its config and camera, and one loop edge 0 -> the last
    keyframe row as a prior (5 cm off)."""
    cfg = tiny_config()
    cfg = dataclasses.replace(cfg, ba=dataclasses.replace(
        cfg.ba, lm_iters=3, cg_iters=10))
    h, w = cfg.image.height, cfg.image.width
    world = synthetic.make_world(3, n_frames=12, n_points=1200,
                                 trajectory="loop", image_hw=(h, w),
                                 speed=0.9, device="cpu")
    lefts, rights = synthetic.render_sequence(world, h, w)
    draws = pipeline.DrawSource(0, "cpu")
    st = pipeline._init_state(lefts[0], rights[0], world.cam, cfg, draws)
    for i in range(1, 12):
        st, _, _ = pipeline.slam_step(st, lefts[i], rights[i], world.cam,
                                      cfg, draws)
    cap = pipeline.MAX_LOOP_EDGES
    le_i, le_j = torch.zeros(cap, dtype=torch.int64), torch.zeros(
        cap, dtype=torch.int64)
    le_z, le_w = torch.eye(4).repeat(cap, 1, 1), torch.zeros(cap)
    last = int(st.kf.n) - 1
    le_j[0], le_w[0] = last, 1000.0
    le_z[0] = torch.linalg.inv(st.kf.poses[0]) @ st.kf.poses[last]
    le_z[0, 0, 3] += 0.05
    return st, cfg, world.cam, (le_i, le_j, le_z, le_w)


@pytest.fixture
def world_of_one():
    """A gloo world of one on the CPU (in-process store) and its mesh."""
    mesh_mod.init_multihost(device="cpu")
    try:
        yield mesh_mod.make_mesh(lm_axis=1, device="cpu")
    finally:
        parallel.clear_graphs()
        dist.destroy_process_group()


def _pgo_args():
    g = pgo_inputs()
    return [_t(g[k]) for k in ("poses", "z", "w", "le_i", "le_j", "le_z",
                               "le_w")], g


def _solver(kind, request):
    """call(graphs) -> the solver's result, on small inputs."""
    if kind == "ba":
        prob, _, _, cam = synthetic.ba_problem(
            0, n_cams=ba.DIRECT_MAX_CAMS + 4, px_noise=0.3, n_outliers=8,
            device="cpu")
        return lambda g: ba.bundle_adjust(prob, cam, BA_CFG,
                                          return_trace=True, graphs=g)
    if kind == "global_ba":
        st, cfg, cam, rows = request.getfixturevalue("slam_state")
        n_obs = int(st.map.obs_count[:32].sum())
        bucket = 1 << max(int(np.ceil(np.log2(max(n_obs, 1)))), 10)
        return lambda g: pipeline.global_ba_step(
            st, cam, cfg, n_kf=32, obs_bucket=bucket, return_trace=True,
            loop_rows=rows, graphs=g)
    if kind == "posegraph":
        (poses, z, w, le_i, le_j, le_z, le_w), g = _pgo_args()
        f = poses.shape[0]
        graph = posegraph.PoseGraph(
            poses=poses, ei=torch.cat([torch.arange(f - 1), le_i.long()]),
            ej=torch.cat([torch.arange(1, f), le_j.long()]),
            z=torch.cat([z[:f - 1], le_z]), w=torch.cat([w[:f - 1], le_w]))
        return lambda gr: posegraph.optimize(
            graph, iters=3, cg_iters=g["cg_iters"], n_live=g["n_live"],
            graphs=gr)
    mesh = request.getfixturevalue("world_of_one")
    if kind == "dist_ba":
        prob, cam = ba_inputs()
        sp, _ = dist_ba.partition_problem(prob, 1)
        return lambda g: dist_ba.distributed_bundle_adjust(
            sp, cam, BA_CFG, mesh, return_trace=True, graphs=g)
    args, g = _pgo_args()
    return lambda gr: dist_pgo.optimize_sharded(
        *args, mesh=mesh, axis="lm", iters=3, cg_iters=g["cg_iters"],
        n_live=g["n_live"], graphs=gr)


@pytest.mark.parametrize("kind", list(SOLVERS))
def test_runner_equals_eager_captures_once_and_clears_by_kind(
        request, emulated_graphs, fresh_graphs, kind):  # noqa: F811
    kinds, replays = SOLVERS[kind]
    call = _solver(kind, request)
    eager = call(False)
    assert not fresh_graphs._graphs      # nothing enters without graphs
    first = call(True)
    assert same_bits(eager, first)
    made = one_each(fresh_graphs, *kinds)
    assert {n: g.graph for n, g in made.items()} == {
        n: "emulated" for n in replays}
    # the first call's first iteration was the capture, the rest replays
    assert {n: g.replays for n, g in made.items()} == {
        n: r - 1 for n, r in replays.items()}
    second = call(True)
    assert same_bits(eager, second)
    again = one_each(fresh_graphs, *kinds)
    assert all(again[n] is g for n, g in made.items())
    assert {n: g.replays for n, g in again.items()} == {
        n: 2 * r - 1 for n, r in replays.items()}
    # another kind's graph stays when this kind is cleared, and BA's
    # view drops the kind "ba" alone
    other = graphs.Stage("other", (), "other[1]", lambda s: (s, ()))
    kept = fresh_graphs.get(other, torch.zeros(1))
    fresh_graphs.clear(kinds[0])
    assert not fresh_graphs.of(kinds[0])
    assert list(fresh_graphs.of("other").values()) == [kept]
    call(True)
    ba.BA_GRAPHS.clear()
    assert not fresh_graphs.of("ba")
    assert list(fresh_graphs.of("other").values()) == [kept]
    if kind != "ba":
        assert len(fresh_graphs.of(kinds[0])) == (
            2 if kind == "global_ba" else len(replays))


def test_runner_without_iterations_captures_no_step(
        emulated_graphs, fresh_graphs):  # noqa: F811
    """iters == 0: the end stage alone runs (and is captured), on the
    initial carry."""
    calls = []

    def step(c):
        calls.append("step")
        return c + 1, ()

    def end(c):
        return c, c * 2
    stages = [graphs.Stage("t", (), f"{n}[1]", fn)
              for n, fn in (("step", step), ("end", end))]
    carry = torch.ones(3)
    for graphed in (False, True):
        out = graphs.iterate(*stages, carry, 0, graphed=graphed)
        assert same_bits(out, (carry, carry * 2))
    assert calls == []
    assert [g.name for g in fresh_graphs.of("t").values()] == ["end[1]"]
    kept = graphs.iterate(*stages, carry, 2, keep=lambda c, out: out,
                          graphed=True)
    assert same_bits(kept, carry * 6)
    assert kept is not fresh_graphs.get(stages[1], carry + 2)._out

