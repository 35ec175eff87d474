"""`local_ba_step`, `build_global_problem` and `global_ba_step` of the
port against the JAX package's, from one carried state.

The reference's `SlamSystem` runs 12 frames of the loop clip at
`tiny_config()` with BA off; its state is exported to numpy and carried
into the port with `interop.slam_state` (`tests/torch_ba_carried.py`),
and both sides take the same backend step from it. Tolerances: the
global problem's index, weight and mask arrays identical and its
floats within 1e-6; after a BA step `traj`, `kf.poses` and `rel`
within 1e-3 (m, rad and twist units),
`map.xyz` within 1e-3 m at up to 10 m from the origin and growing with
the squared distance beyond, as a stereo depth's error does (a landmark
119 m away, where one pixel of disparity is 175 m, differs by 0.015 m
between the two solvers), costs within 1e-3 relative (on the CG path of global BA
the poses only, see GLOBAL_CASES), and every row the step does not
address identical to the port's input.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam1_tpu.models import pipeline as jpipe
from slam1_tpu_torch.models import pipeline as tpipe
from torch_ba_carried import (GLOBAL_CASES, N_FRAMES, N_KF, _cfgs,
                              _jstate, _loop_rows, _obs_bucket, _tstate,
                              _with_garbage_tail, carried)  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401


def test_build_global_problem_matches_jax(carried):
    exported, _, _ = carried
    rows = _loop_rows(exported)
    kw = dict(prior_odo_weight=1e4, prior_loop_weight=1e6)
    for bucket in (0, _obs_bucket(exported)):
        jp, jframes = jpipe.build_global_problem(
            _jstate(exported), N_KF, bucket,
            loop_rows=tuple(jnp.asarray(a) for a in rows), **kw)
        tp, tframes = tpipe.build_global_problem(
            _tstate(exported), N_KF, bucket,
            loop_rows=tuple(torch.as_tensor(a) for a in rows), **kw)
        np.testing.assert_array_equal(tframes.numpy(), np.asarray(jframes))
        assert tp.uv.shape[0] == (bucket or N_KF * 192)
        for name in ("cam_idx", "lm_idx", "w", "wr", "pe_i", "pe_j", "pe_w"):
            np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                          np.asarray(getattr(jp, name)),
                                          err_msg=name)
        for name in ("poses", "points", "uv", "ur", "pe_z"):
            np.testing.assert_allclose(getattr(tp, name).numpy(),
                                       np.asarray(getattr(jp, name)),
                                       rtol=0, atol=1e-6, err_msg=name)
        assert int(tp.w.sum()) > 500
    # without loop rows: no priors
    tp, _ = tpipe.build_global_problem(_tstate(exported), N_KF)
    assert tp.pe_i.shape[0] == 0


def _assert_close(name, a, b):
    a, b = a.numpy(), np.asarray(b)
    if name == "map.xyz":
        far = np.maximum(np.linalg.norm(b, axis=1, keepdims=True), 10.0)
        assert (np.abs(a - b) <= 1e-5 * far * far).all(), name
    else:
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-3, err_msg=name)


def _compare_states(ts, js, t_in, touched_frames, touched_rows):
    """The changed tables against the reference, and the rows the step
    does not address against the port's input, exactly."""
    for name, a, b in (("traj", ts.traj, js.traj),
                       ("kf.poses", ts.kf.poses, js.kf.poses),
                       ("map.xyz", ts.map.xyz, js.map.xyz),
                       ("rel", ts.rel, js.rel),
                       ("T_w_cam", ts.T_w_cam, js.T_w_cam)):
        _assert_close(name, a, b)
    f = np.ones(ts.traj.shape[0], bool)
    f[touched_frames] = False
    assert torch.equal(ts.traj[f], t_in.traj[f])
    r = np.ones(ts.kf.poses.shape[0], bool)
    r[touched_rows] = False
    assert torch.equal(ts.kf.poses[r], t_in.kf.poses[r])
    e = np.ones(ts.rel.shape[0], bool)
    e[min(touched_frames):max(touched_frames) + 2] = False
    assert torch.equal(ts.rel[e], t_in.rel[e])
    # everything else is shared with the input state
    for name in ("desc", "count", "valid", "obs", "obs_count"):
        assert getattr(ts.map, name) is getattr(t_in.map, name)
    assert ts.rel_mask is t_in.rel_mask and ts.kf.xyz is t_in.kf.xyz


@pytest.mark.parametrize("end_kf", [None, 8])
def test_local_ba_step_matches_jax(carried, end_kf):
    exported, jcam, tcam = carried
    jcfg, tcfg = _cfgs()
    t_in = _tstate(exported)
    before = [x.clone() for x in (t_in.traj, t_in.kf.poses, t_in.map.xyz,
                                  t_in.rel)]
    js, jcost = jpipe.local_ba_step(
        _jstate(exported), jcam, jcfg,
        end_kf=None if end_kf is None else jnp.asarray(end_kf, jnp.int32))
    ts, tcost = tpipe.local_ba_step(t_in, tcam, tcfg, end_kf=end_kf)
    assert abs(float(tcost) - float(jcost)) <= 1e-3 * float(jcost)
    end = N_FRAMES if end_kf is None else end_kf
    window = list(range(end - tcfg.ba.window, end))     # keyframe = frame
    _compare_states(ts, js, t_in, window, window)
    # the step moved something, and wrote nothing into its input
    assert float((ts.traj - t_in.traj).abs().max()) > 1e-5
    for a, b in zip(before, (t_in.traj, t_in.kf.poses, t_in.map.xyz,
                             t_in.rel)):
        assert torch.equal(a, b)
    # landmarks outside the window's observations stay as they were
    moved = (ts.map.xyz != t_in.map.xyz).any(dim=1)
    seen = torch.zeros_like(moved)
    lm = t_in.map.obs[window][..., 1].long().reshape(-1)
    seen[lm[lm >= 0]] = True
    assert not bool((moved & ~seen).any())


@pytest.mark.parametrize("case", list(GLOBAL_CASES))
def test_global_ba_step_matches_jax(carried, case):
    exported, jcam, tcam = carried
    n_kf, garbage = GLOBAL_CASES[case]
    if garbage:
        exported = _with_garbage_tail(exported)
    jcfg, tcfg = _cfgs()
    rows = _loop_rows(exported)
    bucket = _obs_bucket(exported)
    t_in = _tstate(exported)
    js, jcost, jtr = jpipe.global_ba_step(
        _jstate(exported), jcam, jcfg, n_kf=n_kf, obs_bucket=bucket,
        return_trace=True, loop_rows=tuple(jnp.asarray(a) for a in rows))
    ts, tcost, ttr = tpipe.global_ba_step(
        t_in, tcam, tcfg, n_kf=n_kf, obs_bucket=bucket, return_trace=True,
        loop_rows=tuple(torch.as_tensor(a) for a in rows))
    assert ttr.accept.tolist() == np.asarray(jtr.accept).tolist()
    assert sum(ttr.accept.tolist()) >= 1
    compared = [("traj", ts.traj, js.traj), ("kf.poses", ts.kf.poses,
                                             js.kf.poses),
                ("T_w_cam", ts.T_w_cam, js.T_w_cam)]
    if case != "cg":
        assert ttr.n_obs.tolist() == np.asarray(jtr.n_obs).tolist()
        np.testing.assert_allclose(ttr.cost.numpy(), np.asarray(jtr.cost),
                                   rtol=1e-3)
        assert abs(float(tcost) - float(jcost)) <= 1e-3 * float(jcost)
        compared.append(("map.xyz", ts.map.xyz, js.map.xyz))
    else:
        assert float(tcost) <= float(ttr.cost[0]) < float(jtr.cost[0])
        assert int(ttr.n_obs[-1]) == int(ttr.n_obs[0])
    if garbage:
        # the gate took the thrown observations out before the solve
        tp, _ = tpipe.build_global_problem(t_in, n_kf, bucket)
        assert int(ttr.n_obs[0]) <= int(tp.w.sum()) - 25
    for name, a, b in compared:
        _assert_close(name, a, b)
    # padding rows of the bucket write nothing: frame 0 keeps the gauge,
    # later frames and rows stay as they were
    assert torch.equal(ts.traj[N_FRAMES:], t_in.traj[N_FRAMES:])
    assert torch.equal(ts.kf.poses[N_FRAMES:], t_in.kf.poses[N_FRAMES:])
    np.testing.assert_allclose(ts.traj[0].numpy(), t_in.traj[0].numpy(),
                               rtol=0, atol=1e-6)
    assert ts.rel is t_in.rel
    frames = list(range(N_FRAMES))
    assert float((ts.traj[frames] - t_in.traj[frames]).abs().max()) > 1e-5
    # without the trace: the same state
    ts2, tcost2 = tpipe.global_ba_step(
        t_in, tcam, tcfg, n_kf=n_kf, obs_bucket=bucket,
        loop_rows=tuple(torch.as_tensor(a) for a in rows))
    assert torch.equal(ts2.traj, ts.traj) and float(tcost2) == float(tcost)
