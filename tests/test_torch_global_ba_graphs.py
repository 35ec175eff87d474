"""The global bundle adjustment as the reference runs it: on the card
`global_ba_step` replays three CUDA graphs, `ba_build` (the problem and
the trim), `ba_lm` (one `ba.lm_step`, the reference's scan body,
replayed `lm_iters` times) and `ba_apply` (the final cost and the
write-back), kept in the graph registry by what each function reads:
`ba_build` and `ba_apply` under the kind "global_ba", `ba_lm` under
"ba", the graph `bundle_adjust` replays for a problem of its shapes.

On the CPU the graphs cannot be captured, so:
  - the three programs read nothing back to the host, on the dense and
    the CG paths;
  - `global_ba_step` through eagerly emulated graphs equals
    `graphs=False` to the bit (state, cost, trace) on the carried state
    of tests/torch_ba_carried.py, for tests/test_torch_ba_pipeline.py's
    three global cases, with and without the trace; the input state is left as it was and the
    returned tensors are not the graphs' own;
  - a second call with the same key replays `ba_lm` `lm_iters` times
    and captures nothing; another observation bucket or keyframe bucket
    gets its own graphs; another camera goes into the same graphs as an
    input and its values are the ones read;
  - `bundle_adjust` on the problem `ba_build` makes replays the same
    `ba_lm` graph, and equals `graphs=False` to the bit;
  - the graduated cut made on the device from the iteration tensor
    equals the host's value to the bit.
tests/test_torch_kernels_cuda.py replays the real graphs on the card.
"""

import pytest
import torch

from slam1_tpu_torch.models import ba
from slam1_tpu_torch.models import pipeline as tpipe
from slam1_tpu_torch.ops.camera import StereoCamera
from slam1_tpu_torch.utils import tree
from torch_ba_carried import (GLOBAL_CASES, _cfgs, _loop_rows, _obs_bucket,
                              _tstate, _with_garbage_tail,
                              carried)  # noqa: F401
from torch_graph_helpers import HostReads, by_base, one_each, same_bits
from torch_graph_helpers import emulated_graphs, fresh_graphs  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401

NAMES = ("ba_build", "ba_lm", "ba_apply")


def _one_set(registry) -> dict:
    """{base name: StepGraph} of global BA's graphs: its own kind's and
    the "ba" kind's `ba_lm`, one of each."""
    graphs = one_each(registry, "global_ba", "ba")
    assert sorted(graphs) == sorted(NAMES)
    return graphs


def _rows(exported):
    return tuple(torch.as_tensor(a) for a in _loop_rows(exported))


def _call(state, cam, cfg, exported, n_kf, trace=True, **kw):
    return tpipe.global_ba_step(
        state, cam, cfg, n_kf=n_kf, obs_bucket=kw.pop(
            "obs_bucket", _obs_bucket(exported)),
        return_trace=trace, loop_rows=_rows(exported), **kw)


def _pool_storages(graphs) -> set:
    """The storages of every static state, input and output leaf of the
    graphs."""
    out = set()
    for g in graphs:
        for x in g._state + g._inputs + tree.flatten(g._out):
            if x is not None:        # an emulated capture keeps no `out`
                out.add(x.untyped_storage().data_ptr())
    return out


@pytest.mark.parametrize("case", ["direct", "cg"])
def test_global_ba_programs_read_nothing_back_to_the_host(carried, case):
    exported, _, tcam = carried
    n_kf, _ = GLOBAL_CASES[case]
    _, tcfg = _cfgs()
    st = _tstate(exported)
    bucket = _obs_bucket(exported)
    build_in, apply_in = tpipe._global_ba_leaves(st)
    rows = _rows(exported)
    with HostReads() as rec:
        _, (prob, frames) = tpipe._graphed_ba_build(tcfg, n_kf, bucket)(
            build_in, tcam, *rows)
    assert rec.ops == [], rec.ops
    assert (prob.poses.shape[0] <= ba.DIRECT_MAX_CAMS) == (case == "direct")
    assert prob.pe_i.shape[0] > 0
    carry = ba._lm_carry(prob, tcam, tcfg.ba, True)
    with HostReads() as rec:
        carry, out = ba._graphed_ba_lm(tcfg.ba)(carry)
    assert rec.ops == [] and out == (), rec.ops
    assert int(carry.t) == 1
    with HostReads() as rec:
        tpipe._graphed_ba_apply(tcfg, n_kf)(carry, apply_in, frames)
    assert rec.ops == [], rec.ops


@pytest.mark.parametrize("trace", [True, False], ids=["trace", "no-trace"])
@pytest.mark.parametrize("case", list(GLOBAL_CASES))
def test_global_ba_graphs_equal_eager(carried, emulated_graphs,  # noqa: F811
                                      fresh_graphs, case, trace):
    exported, _, tcam = carried
    n_kf, garbage = GLOBAL_CASES[case]
    if garbage:
        exported = _with_garbage_tail(exported)
    _, tcfg = _cfgs()
    t_in = _tstate(exported)
    before = tuple(x.clone() for x in tree.flatten(t_in))
    eager = _call(t_in, tcam, tcfg, exported, n_kf, trace, graphs=False)
    graphed = _call(t_in, tcam, tcfg, exported, n_kf, trace)
    graphs = _one_set(fresh_graphs)
    assert [graphs[n].replays for n in NAMES] \
        == [0, tcfg.ba.lm_iters - 1, 0]
    assert same_bits(eager, graphed)
    assert float((graphed[0].traj - t_in.traj).abs().max()) > 1e-5
    # nothing written in place; the leaves global BA does not replace are
    # the input's own
    assert same_bits(before, tuple(tree.flatten(t_in)))
    new = graphed[0]
    assert new.rel is t_in.rel and new.bow is t_in.bow
    assert new.kf.xyz is t_in.kf.xyz and new.map.obs is t_in.map.obs
    # what it returns is not the graphs' own
    replaced = (new.traj, new.T_w_cam, new.kf.poses, new.map.xyz)
    kept = tree.flatten((replaced, graphed[1:]))
    pool = _pool_storages(graphs.values())
    assert not any(x.untyped_storage().data_ptr() in pool for x in kept)


def test_global_ba_graphs_cached_by_key(carried, emulated_graphs,  # noqa: F811
                                        fresh_graphs):
    exported, _, tcam = carried
    _, tcfg = _cfgs()
    t_in = _tstate(exported)
    n_kf = GLOBAL_CASES["cg"][0]
    iters = tcfg.ba.lm_iters
    first = _call(t_in, tcam, tcfg, exported, n_kf)
    kept = tuple(x.clone() for x in tree.flatten(first))
    graphs = _one_set(fresh_graphs)
    # the same key: replays only, lm_iters of them for ba_lm
    second = _call(first[0], tcam, tcfg, exported, n_kf)
    assert _one_set(fresh_graphs) == graphs
    assert [graphs[n].replays for n in NAMES] == [1, 2 * iters - 1, 1]
    assert same_bits(second, _call(first[0], tcam, tcfg, exported, n_kf,
                                   graphs=False))
    # the first call's results were not overwritten by the replays
    assert same_bits(kept, tuple(tree.flatten(first)))
    # another camera: an input of the same graphs, whose values are read
    cam2 = StereoCamera(*[v * 1.01 for v in tcam])
    third = _call(t_in, cam2, tcfg, exported, n_kf)
    assert _one_set(fresh_graphs) == graphs
    assert graphs["ba_lm"].replays == 3 * iters - 1
    assert same_bits(third, _call(t_in, cam2, tcfg, exported, n_kf,
                                  graphs=False))
    assert not same_bits(third, first)
    # another observation bucket, another keyframe bucket: graphs of
    # their own, each captured at its first call
    bucket = _obs_bucket(exported)
    _call(t_in, tcam, tcfg, exported, n_kf, obs_bucket=2 * bucket)
    _call(t_in, tcam, tcfg, exported, GLOBAL_CASES["direct"][0])
    sets = by_base(fresh_graphs, "global_ba", "ba")
    assert {n: len(g) for n, g in sets.items()} == {n: 3 for n in NAMES}
    assert len({g.name for g in sets["ba_build"]}) == 3
    for g in sets["ba_lm"][1:]:
        assert g.graph == "emulated" and g.replays == iters - 1
    assert graphs["ba_lm"].replays == 3 * iters - 1


@pytest.mark.parametrize("case", list(GLOBAL_CASES))
def test_bundle_adjust_shares_global_ba_lm_graph(
        carried, emulated_graphs, fresh_graphs, case):  # noqa: F811
    """`bundle_adjust` on the problem global BA builds, with its config
    and trace, replays global BA's `ba_lm` graph: one graph in the "ba"
    kind, the results equal to eager to the bit."""
    exported, _, tcam = carried
    n_kf, _ = GLOBAL_CASES[case]
    _, tcfg = _cfgs()
    t_in = _tstate(exported)
    _call(t_in, tcam, tcfg, exported, n_kf)
    build_in, _ = tpipe._global_ba_leaves(t_in)
    _, (prob, _) = tpipe._graphed_ba_build(tcfg, n_kf, _obs_bucket(
        exported))(build_in, tcam, *_rows(exported))
    lm = one_each(fresh_graphs, "ba")["ba_lm"]
    graphed = ba.bundle_adjust(prob, tcam, tcfg.ba, return_trace=True)
    assert same_bits(graphed, ba.bundle_adjust(prob, tcam, tcfg.ba,
                                               return_trace=True,
                                               graphs=False))
    ba_graphs = one_each(fresh_graphs, "ba")
    assert ba_graphs["ba_lm"] is lm and "ba_cost" in ba_graphs
    assert lm.replays == 2 * tcfg.ba.lm_iters - 1


@pytest.mark.parametrize("outlier_px", [16.0, 3.7, 0.1])
def test_graduated_cut_on_the_device_equals_the_host_value(outlier_px):
    """The cut made from the iteration tensor equals the one the eager
    loop used to make on the host, outlier_px * max(1, 8 * 0.5 ** t)
    rounded once to float32."""
    for t in range(20):
        cut = ba.graduated_cut(outlier_px, torch.tensor(t), torch.float32)
        host = torch.full((), outlier_px * max(1.0, 8.0 * 0.5 ** t),
                          dtype=torch.float32)
        assert cut.dtype == torch.float32
        assert torch.equal(cut.view(torch.int32), host.view(torch.int32)), t
