"""The port's user entry points and host utilities against the JAX
package, on the CPU: the KITTI loader and the native prefetcher on a
sequence the test writes, export round trips, metrics, viz, and the
`slam-torch` CLI (`run`, `eval`, `ba`).

Tolerances: decoded frames, ground truth, exports, evaluation numbers
exact; the camera's float32 parameters exact; `ba` on a trajectory
against the reference's `ba` 1e-4 m (two pose-graph solvers of the same
algorithm in float32).
"""

import json
import os

import numpy as np
import pytest
import torch

from slam1_tpu import cli as jcli
from slam1_tpu.utils import export as jexport
from slam1_tpu.utils import kitti as jkitti
from slam1_tpu_torch import cli
from slam1_tpu_torch.config import tiny_config
from slam1_tpu_torch.models import pipeline, vo
from slam1_tpu_torch.utils import export, kitti, metrics, native_loader, viz
from slam1_tpu_torch.utils import synthetic as tsyn
from torch_threads import one_torch_thread  # noqa: F401

N_FRAMES = 10
CROP = (120, 250)      # written images are smaller than the 128x256 canvas


@pytest.fixture(scope="module")
def world():
    cfg = tiny_config()
    w = tsyn.make_world(5, n_frames=N_FRAMES, n_points=1500, speed=0.45,
                        image_hw=(cfg.image.height, cfg.image.width),
                        device="cpu")
    lefts, rights = tsyn.render_sequence(w, cfg.image.height, cfg.image.width)
    return cfg, w, lefts.numpy(), rights.numpy()


@pytest.fixture(scope="module")
def kitti_dir(world, tmp_path_factory):
    _, w, lefts, rights = world
    h, wd = CROP
    root = str(tmp_path_factory.mktemp("kitti_seq"))
    kitti.write_sequence(root, lefts[:, :h, :wd], rights[:, :h, :wd], w.cam,
                         w.poses.numpy())
    return root


def test_write_png_and_pgm_decode(tmp_path):
    import cv2
    img = np.random.default_rng(0).integers(0, 256, (37, 53), np.uint8)
    kitti.write_png(str(tmp_path / "a.png"), img)
    kitti.write_pgm(str(tmp_path / "a.pgm"), img)
    for name in ("a.png", "a.pgm"):
        np.testing.assert_array_equal(
            cv2.imread(str(tmp_path / name), cv2.IMREAD_GRAYSCALE), img)
    np.testing.assert_array_equal(kitti._read_pgm(str(tmp_path / "a.pgm")),
                                  img)


def test_kitti_sequence_matches_jax(world, kitti_dir):
    cfg, w, _, _ = world
    hw = (cfg.image.height, cfg.image.width)
    poses = os.path.join(kitti_dir, "poses.txt")
    j = jkitti.KittiSequence(kitti_dir, hw, poses_path=poses)
    t = kitti.KittiSequence(kitti_dir, hw, poses_path=poses, device="cpu")
    assert len(t) == len(j) == N_FRAMES
    for a, b, c in zip(j.cam, t.cam, w.cam):
        assert float(np.asarray(a)) == float(b) == float(c)
    np.testing.assert_array_equal(t.gt, j.gt)
    np.testing.assert_array_equal(t.P0, j.P0)
    np.testing.assert_array_equal(t.P1, j.P1)
    np.testing.assert_allclose(t.gt, w.poses.numpy(), atol=1e-6)
    for (jl, jr), (tl, tr) in zip(j.frames(), t.frames()):
        np.testing.assert_array_equal(tl, jl)
        np.testing.assert_array_equal(tr, jr)
        assert tl.shape == hw and tl[CROP[0]:].max() == 0.0


@pytest.mark.parametrize("decoder", ["cv2", "PIL", "native", "pgm"])
def test_load_image_decoders_agree(kitti_dir, tmp_path, monkeypatch, decoder):
    """Every decoder gives the levels cv2 gives."""
    import cv2
    png = kitti.list_images(os.path.join(kitti_dir, "image_0"))[3]
    u8 = cv2.imread(png, cv2.IMREAD_GRAYSCALE)
    path = png
    if decoder == "pgm":
        path = str(tmp_path / "a.pgm")
        kitti.write_pgm(path, u8)
    order = {"cv2": [], "PIL": ["cv2"], "native": ["cv2", "PIL"],
             "pgm": ["cv2", "PIL", "native"]}[decoder]
    monkeypatch.setattr(kitti, "_DECODERS", {
        k: ((lambda: False) if k in order else v[0], v[1])
        for k, v in kitti._DECODERS.items()})
    assert kitti.decoder_for(path) == decoder
    np.testing.assert_array_equal(kitti.load_image(path),
                                  u8.astype(np.float32) / 255.0)


def test_load_image_without_decoder_raises(kitti_dir, monkeypatch):
    monkeypatch.setattr(kitti, "_DECODERS", {
        k: (lambda: False, v[1]) for k, v in kitti._DECODERS.items()})
    png = kitti.list_images(os.path.join(kitti_dir, "image_0"))[0]
    with pytest.raises(RuntimeError, match="cv2 and PIL"):
        kitti.load_image(png)


def test_native_loader_matches_python_loader(world, kitti_dir):
    cfg, _, _, _ = world
    path = native_loader.build_library()
    assert path is not None
    assert os.path.dirname(path) == native_loader.BUILD_DIR
    assert native_loader.BUILD_DIR.endswith(
        os.path.join("slam1_tpu_torch", "build"))
    seq = kitti.KittiSequence(kitti_dir, (cfg.image.height, cfg.image.width),
                              device="cpu")
    pairs = list(native_loader.stereo_frames(
        seq.lefts, seq.rights, cfg.image.height, cfg.image.width))
    assert len(pairs) == N_FRAMES
    for (nl, nr), (pl, pr) in zip(pairs, seq.frames()):
        np.testing.assert_array_equal(nl, pl)
        np.testing.assert_array_equal(nr, pr)
    one = native_loader.decode_gray(seq.lefts[0])
    assert one.shape == CROP
    np.testing.assert_array_equal(one, kitti.load_image(seq.lefts[0]))


def test_kitti_pose_roundtrip(world, tmp_path):
    poses = world[1].poses.numpy()
    p = export.save_kitti_poses(str(tmp_path / "p.txt"), poses)
    np.testing.assert_array_equal(export.load_kitti_poses(p),
                                  jexport.load_kitti_poses(p))
    np.testing.assert_allclose(export.load_kitti_poses(p), poses, atol=1e-6)


def test_bal_roundtrip_matches_jax(world, tmp_path):
    poses = world[1].poses.numpy()[:5]
    rng = np.random.default_rng(3)
    pts = rng.normal(0, 5, (40, 3)) + [0, 0, 20]
    ci, li = rng.integers(0, 5, 120), rng.integers(0, 40, 120)
    uv = rng.uniform(0, 256, (120, 2))
    w = (rng.random(120) > 0.1).astype(np.float32)
    a = export.load_bal(export.save_bal(str(tmp_path / "t.bal"), poses, pts,
                                        ci, li, uv, w, 300.0, 128.0, 64.0))
    b = jexport.load_bal(jexport.save_bal(str(tmp_path / "j.bal"), poses,
                                          pts, ci, li, uv, w, 300.0, 128.0,
                                          64.0))
    assert a.keys() == b.keys() and len(a["uv"]) == int(w.sum())
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=1e-6)


def test_metrics_logger_and_stage_timers(tmp_path):
    path = str(tmp_path / "m.jsonl")
    log = metrics.MetricsLogger(path, every=2)
    for i in range(5):
        log.log(frame=i, err=np.float32(0.5))
    log.close()
    rows = [json.loads(x) for x in open(path)]
    assert [r["frame"] for r in rows] == [1, 3] and rows[0]["err"] == 0.5
    timers = metrics.StageTimers()
    for _ in range(3):
        with timers.stage("a"):
            pass
    s = timers.summary()["a"]
    assert s["count"] == 3 and s["total_s"] >= 0.0
    with metrics.profiler_trace(str(tmp_path / "prof")) as prof:
        torch.ones(8).sum()
    assert prof is not None
    assert os.path.getsize(tmp_path / "prof" / "trace.json") > 0
    with metrics.profiler_trace(None) as prof:
        assert prof is None


def test_viz_outputs_files(world, tmp_path):
    _, w, _, _ = world
    poses = w.poses.numpy()
    ms = [vo.VOMetrics(*[np.asarray(v) for v in (10, 8, 7, 0.5, True)])] * 4
    pts = np.random.default_rng(0).normal(0, 5, (300, 3))
    for p in (viz.plot_trajectories(poses, poses, str(tmp_path / "t.png"),
                                    corrected=poses),
              viz.plot_metrics(ms, str(tmp_path / "m.png")),
              viz.plot_map(pts, np.ones(300, bool), poses,
                           str(tmp_path / "map.png"))):
        assert os.path.getsize(p) > 1000


def run_cli(capsys, argv):
    assert cli.main(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_run_synthetic_tiny(tmp_path, capsys):
    traj = str(tmp_path / "traj.npy")
    res = run_cli(capsys, ["run", "--synthetic", "24", "--tiny", "--device",
                           "cpu", "--out", traj, "--log-every", "100"])
    assert res["frames"] == 24 and "loop_closures" in res
    assert res["ate_rmse_m"] < 2.0
    assert np.load(traj).shape == (24, 4, 4)


def test_run_vo_only_matches_library(world, kitti_dir, tmp_path, capsys):
    """`run --data --vo-only` equals vo.run_sequence on the same decoded
    frames and seed."""
    cfg, w, _, _ = world
    traj = str(tmp_path / "vo.npy")
    res = run_cli(capsys, [
        "run", "--data", kitti_dir, "--poses",
        os.path.join(kitti_dir, "poses.txt"), "--tiny", "--vo-only",
        "--device", "cpu", "--seed", "3", "--out", traj,
        "--metrics", str(tmp_path / "m.jsonl"), "--log-every", "2"])
    seq = kitti.KittiSequence(kitti_dir, (cfg.image.height, cfg.image.width),
                              device="cpu")
    L, R = (torch.as_tensor(np.stack(x)) for x in zip(*seq.frames()))
    poses, _ = vo.run_sequence(L, R, seq.cam, cfg, seed=3)
    np.testing.assert_array_equal(np.load(traj), poses)
    assert res["frames"] == N_FRAMES and res["decoder"] == "cv2"
    assert len(open(tmp_path / "m.jsonl").readlines()) >= 2


def test_eval_matches_jax(world, tmp_path, capsys):
    gt = world[1].poses.numpy()
    est = gt.copy()
    est[:, :3, 3] += np.random.default_rng(1).normal(0, 0.05, (N_FRAMES, 3))
    e, g = str(tmp_path / "est.npy"), str(tmp_path / "gt.txt")
    np.save(e, est)
    export.save_kitti_poses(g, gt)
    for extra in ([], ["--no-align", "--delta", "2"]):
        assert jcli.main(["eval", e, g, *extra]) == 0
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert run_cli(capsys, ["eval", e, g, *extra]) == want


def test_ba_state_and_trajectory(world, tmp_path, capsys):
    cfg, w, lefts, rights = world
    sys_ = pipeline.SlamSystem(w.cam, cfg, bow_train_frame=6)
    for i in range(N_FRAMES):
        sys_.process(torch.as_tensor(lefts[i]), torch.as_tensor(rights[i]))
    sys_.finalize()
    ckpt = str(tmp_path / "state.npz")
    sys_.save_checkpoint(ckpt)
    res = run_cli(capsys, ["ba", "--state", ckpt, "--tiny", "--iters", "4",
                           "--device", "cpu", "--out",
                           str(tmp_path / "opt.npy")])
    assert res["keyframes"] == int(sys_.state.kf.n) > 0
    assert np.isfinite(res["final_cost"])
    assert np.load(tmp_path / "opt.npy").shape == (N_FRAMES, 4, 4)

    traj = str(tmp_path / "traj.npy")
    noisy = w.poses.numpy().copy()
    noisy[:, :3, 3] += np.random.default_rng(2).normal(0, 0.02,
                                                      (N_FRAMES, 3))
    np.save(traj, noisy.astype(np.float32))
    res = run_cli(capsys, ["ba", traj, "--device", "cpu", "--out",
                           str(tmp_path / "t.npy")])
    assert jcli.main(["ba", traj, "--out", str(tmp_path / "j.npy")]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert res["frames"] == want["frames"] == N_FRAMES
    assert np.isfinite(res["final_cost"])
    np.testing.assert_allclose(np.load(tmp_path / "t.npy"),
                               np.load(tmp_path / "j.npy"), atol=1e-4)


def test_default_device_is_the_card(capsys):
    """Without --device the CLI runs on the card; where there is none it
    raises instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default run would use it")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        cli.main(["run", "--synthetic", "4", "--tiny"])
    with pytest.raises(SystemExit):
        cli.main(["bench"])
