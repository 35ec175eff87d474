"""The distributed options of `slam-torch` against the JAX package's CLI,
on the CPU.

One state, two checkpoints: the reference's `SlamSystem` runs 12 frames
of the loop clip at `tiny_config()` (BA off) and saves its checkpoint;
the same state, carried into the port with `interop.slam_state`, is
saved as the port's checkpoint. Then `ba --state ... --distributed`
runs on each: the reference at lm = 2 on the conftest's 8 virtual
devices, the port at lm = 1 in this process (a world of one) and at
lm = 2 over two gloo ranks (`torch_dist_ranks`, a file:// rendezvous).

Tolerances: keyframe and dropped-observation counts and the mesh equal;
final costs within 1e-3 relative; keyframe positions within 1e-3 m (12
keyframes, 128-row bucket: the CG path, on which the two packages' sums
differ in order only). `run --multihost --vo-only` at a world of one
equals the plain `run --vo-only` exactly.
"""

import dataclasses
import json

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from slam1_tpu import cli as jcli
from slam1_tpu.config import tiny_config as jtiny
from slam1_tpu.models import pipeline as jpipe
from slam1_tpu.utils.synthetic import make_world, render_sequence
from slam1_tpu_torch import cli
from slam1_tpu_torch.config import tiny_config
from slam1_tpu_torch.models import pipeline as tpipe
from slam1_tpu_torch.parallel import mesh as mesh_mod
from slam1_tpu_torch.utils import interop
from torch_dist_ranks import run_ranks
from torch_threads import one_torch_thread  # noqa: F401

N_FRAMES = 12


def _ba_off(cfg):
    return cfg.replace(ba=dataclasses.replace(cfg.ba, local_every=0))


@pytest.fixture(scope="module")
def checkpoints(tmp_path_factory):
    """(reference checkpoint, port checkpoint, the reference CLI's line
    and saved poses at lm = 2, tmp dir)."""
    tmp = tmp_path_factory.mktemp("cli_dist")
    jcfg = _ba_off(jtiny())
    h, w = jcfg.image.height, jcfg.image.width
    world = make_world(jax.random.PRNGKey(3), n_frames=36, n_points=1200,
                       trajectory="loop", speed=0.9, image_hw=(h, w))
    lefts, rights = render_sequence(world, h, w)
    js = jpipe.SlamSystem(world.cam, jcfg, bow_train_frame=8)
    for i in range(N_FRAMES):
        js.process(lefts[i], rights[i])
    js.finalize(run_pgo=False)
    jpath, tpath = str(tmp / "jax.npz"), str(tmp / "port.npz")
    js.save_checkpoint(jpath)

    exported = jax.device_get(js.state)
    ts = tpipe.SlamSystem(interop.camera(jax.device_get(world.cam), "cpu"),
                          _ba_off(tiny_config()), bow_train_frame=8)
    ts.state = interop.slam_state(exported._replace(key=None), "cpu")
    ts.frame_count = js.frame_count
    ts.save_checkpoint(tpath)

    jout = str(tmp / "jax_opt.npy")
    line = _main(jcli.main, ["ba", "--state", jpath, "--tiny",
                             "--distributed", "--lm-shards", "2", "--out",
                             jout])
    return jpath, tpath, line, np.load(jout), tmp


def _main(main, argv):
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _hold(res, poses, ref, ref_poses, lm):
    assert res["keyframes"] == ref["keyframes"] == N_FRAMES
    assert res["dropped_obs"] == ref["dropped_obs"] == 0
    assert res["mesh"] == {"batch": 1, "lm": lm}
    assert np.isfinite(res["final_cost"])
    assert abs(res["final_cost"] - ref["final_cost"]) <= 1e-3 * ref[
        "final_cost"]
    assert poses.shape == ref_poses.shape
    np.testing.assert_allclose(poses[:, :3, 3], ref_poses[:, :3, 3], rtol=0,
                               atol=1e-3)


def test_ba_distributed_one_rank_matches_jax(checkpoints):
    _, tpath, ref, ref_poses, tmp = checkpoints
    out = str(tmp / "lm1.npy")
    res = _main(cli.main, ["ba", "--state", tpath, "--tiny", "--distributed",
                           "--lm-shards", "1", "--device", "cpu", "--out",
                           out])
    _hold(res, np.load(out), ref, ref_poses, 1)
    assert not dist.is_initialized()      # the CLI's own world is gone


def test_ba_distributed_two_ranks_match_jax(checkpoints):
    _, tpath, ref, ref_poses, tmp = checkpoints
    out = str(tmp / "lm2.npy")
    argv = ["ba", "--state", tpath, "--tiny", "--distributed", "--lm-shards",
            "2", "--device", "cpu", "--out", out]
    ranks = run_ranks(2, ("cli",), {"cli": {"argv": argv}},
                      tmp / "ranks")
    assert [r["cli"]["rc"] for r in ranks] == [0, 0]
    assert ranks[1]["cli"]["stdout"] == ""          # rank 0 reports
    res = json.loads(ranks[0]["cli"]["stdout"].strip().splitlines()[-1])
    _hold(res, np.load(out), ref, ref_poses, 2)


def test_run_multihost_equals_plain_run(tmp_path, capsys):
    base = ["run", "--synthetic", "6", "--tiny", "--vo-only", "--device",
            "cpu"]
    plain = _main(cli.main, base + ["--out", str(tmp_path / "a.npy")])
    capsys.readouterr()
    multi = _main(cli.main, base + [
        "--out", str(tmp_path / "b.npy"), "--multihost", "--coordinator",
        f"file://{tmp_path / 'rendezvous'}", "--num-processes", "1",
        "--process-id", "0"])
    assert "multihost: process 0/1, device cpu" in capsys.readouterr().err
    np.testing.assert_array_equal(np.load(tmp_path / "b.npy"),
                                  np.load(tmp_path / "a.npy"))
    assert multi["ate_rmse_m"] == plain["ate_rmse_m"]
    assert not dist.is_initialized()


@pytest.mark.parametrize("argv,err", [
    (["run", "--synthetic", "4", "--tiny", "--multihost", "--coordinator",
      "127.0.0.1:1"], "num_processes"),
    (["run", "--synthetic", "4", "--tiny", "--multihost",
      "--num-processes", "2"], "without a coordinator"),
    (["ba", "--state", "x.npz", "--tiny", "--distributed", "--lm-shards",
      "3"], "does not divide"),
])
def test_distributed_options_reject_bad_input(argv, err):
    with pytest.raises(ValueError, match=err):
        cli.main(argv + ["--device", "cpu"])
    if dist.is_initialized():
        dist.destroy_process_group()


def test_init_multihost_keeps_a_group_and_checks_its_size():
    """An existing group is kept (the second call is a no-op); a size
    other than the group's raises, it does not run a smaller world."""
    try:
        assert mesh_mod.init_multihost(device="cpu") == "gloo"
        assert mesh_mod.init_multihost(device="cpu") == "gloo"
        with pytest.raises(RuntimeError, match="world size 1 != 2"):
            mesh_mod.init_multihost(num_processes=2, device="cpu")
        m = mesh_mod.make_mesh(device="cpu")
        assert m.shape == {"batch": 1, "lm": 1}
        x = torch.arange(6.0)
        assert torch.equal(mesh_mod.ring_shift(m, x, 1), x)
        assert torch.equal(mesh_mod.lm_shard(m, x), x)
    finally:
        dist.destroy_process_group()


def test_backend_rule():
    assert mesh_mod.choose_backend("cpu", 4)[0] == "gloo"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            mesh_mod.rank_device("cuda", 0)
