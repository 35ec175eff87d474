"""A run with the timed path broken underneath comes out not correct.

Each case drives the rest of a run of the cell on the CPU at a tiny size
(the look for a card skipped), with one fault planted in the program,
and requires the numbers compared to fail the cell's limits
(`traffic/<name>.json`) and to read worse than the same run unbroken.
The faults are those a cell can have: a step that returns its state
unchanged, half of a batch (a block of frames, the observations) left
out, an answer altered where it is produced; the live cell feeds one
frame at a time, so it has no batch to halve. No cell spans chips, so
no exchange between chips can be left out.
"""

import dataclasses
import json
import math
import pathlib
import time

import pytest
import torch

from benchmark.harness import cli, offline, slam, trace

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
torch.set_num_threads(1)


def tiny(config_name, traffic_name):
    """A configuration and a traffic mix cut to a CPU test's size."""
    from slam1_tpu_torch.config import tiny_config
    conf = json.loads((ROOT / next(c["file"] for c in BENCH["configs"]
                                   if c["name"] == config_name)).read_text())
    tr = json.loads((ROOT / "benchmark" / "traffic"
                     / f"{traffic_name}.json").read_text())
    if config_name == "kitti-stereo-slam":
        t = tiny_config()
        fx = 718.856 * 256 / 1226
        conf["image"] = dataclasses.asdict(t.image)
        conf["camera"] = {"fx": fx, "fy": fx, "cx": 128.0, "cy": 64.0,
                          "baseline": 0.5371657}
        conf["slam_config"] = {g: dataclasses.asdict(getattr(t, g)) for g in (
            "image", "detector", "mapping", "bow", "tracking", "disparity")}
        conf["slam_config"]["bow"]["place_query"] = True
        tr["drive"].update(frames=90)
        tr["world"].update(points_per_m=14, z_range=[9.0, 34.0])
        tr["warm_frames"] = 45
    else:
        conf["drive_frames"] = 80
        tr["problem"]["camera_rows"] = 48
        tr["world"]["points_per_m"] = 50
    return conf, tr


def drive(config_name, traffic_name, seconds):
    conf, tr = tiny(config_name, traffic_name)
    run = cli.Run(traffic_name, conf, tr, 2 ** 31 + 7, seconds, False,
                  time.perf_counter())
    run.window = trace.Window(False, 1.0)
    module, fn = tr["driver"].rsplit(".", 1)
    getattr({"slam": slam, "offline": offline}[module], fn)(
        run, torch.device("cpu"))
    return run


def verdict(run):
    limits = run.traffic["limits"]
    vals = {n: run.checks.get(n) for n in limits}
    ok = all(v is not None and math.isfinite(v) and v <= limits[n]
             for n, v in vals.items())
    return ok, vals


def worse(broken, sound):
    """Some compared number of the broken run exceeds its limit and the
    sound run's reading."""
    limits = broken.traffic["limits"]
    return any(broken.checks[n] > max(limits[n], sound.checks[n])
               for n in limits)


@pytest.fixture(scope="module")
def sound_runs():
    return {}


def sound(sound_runs, mix):
    if mix not in sound_runs:
        sound_runs[mix] = drive(*mix)
    return sound_runs[mix]


def _step_unchanged(monkeypatch):
    from slam1_tpu_torch.models import pipeline
    orig = pipeline._step_core

    def step(state, *a, **k):
        new, row, feats = orig(state, *a, **k)
        return state, row, feats
    monkeypatch.setattr(pipeline, "_step_core", step)


def _half_block(monkeypatch):
    from slam1_tpu_torch.models import pipeline
    orig = pipeline.SlamSystem.process_block

    def block(self, lefts, rights):
        k = lefts.shape[0]
        orig(self, lefts[:(k + 1) // 2], rights[:(k + 1) // 2])
        self.frame_count += k - (k + 1) // 2
    monkeypatch.setattr(pipeline.SlamSystem, "process_block", block)


def _last_pose_altered(frame):
    """The pose of `frame`, the last the run feeds, moved 1 m where the
    step makes it, with the motion it records (`rel`, the pose graph's
    odometry), as a wrong PnP solution would be. (Earlier in the drive,
    the next local BA window pulls a 1 m error back, and the trajectory
    the run hands over holds no fault.)"""
    def fault(monkeypatch):
        from slam1_tpu_torch.models import pipeline
        from slam1_tpu_torch.ops import se3
        orig = pipeline._step_core

        def step(state, *a, **k):
            new, row, feats = orig(state, *a, **k)
            f = int(new.frame)
            if f == frame:
                T = new.T_w_cam.clone()
                T[0, 3] += 1.0
                new.traj[f] = T
                new.rel[f] = -se3.log_se3(se3.inverse(new.traj[f - 1]) @ T)
                new = new._replace(T_w_cam=T)
            return new, row, feats
        monkeypatch.setattr(pipeline, "_step_core", step)
    fault.__name__ = "_last_pose_altered"
    return fault


def _ba_unchanged(monkeypatch):
    from slam1_tpu_torch.models import ba
    monkeypatch.setattr(ba, "bundle_adjust",
                        lambda p, cam, cfg, **k: (p, ba.final_cost(
                            p, cam, cfg, p.poses, p.points)))


def _ba_half(monkeypatch):
    from slam1_tpu_torch.models import ba
    orig = ba.bundle_adjust

    def half(p, cam, cfg, **k):
        keep = (torch.arange(p.w.shape[0]) % 2 == 0).to(p.w.dtype)
        out, cost = orig(p._replace(w=p.w * keep), cam, cfg, **k)
        return out._replace(w=p.w), cost
    monkeypatch.setattr(ba, "bundle_adjust", half)


def _ba_altered(monkeypatch):
    from slam1_tpu_torch.models import ba
    orig = ba.bundle_adjust

    def altered(p, cam, cfg, **k):
        out, cost = orig(p, cam, cfg, **k)
        poses = out.poses.clone()
        poses[7, 0, 3] += 0.1
        return out._replace(poses=poses), cost
    monkeypatch.setattr(ba, "bundle_adjust", altered)


# (configuration, traffic, window s): the cells' mixes, and
# `drive-closed`, whose cell waits for the program (PERF.md, Open
# questions) with its driver; its window runs to the drive's end.
LIVE = ("kitti-stereo-slam", "drive-live-10hz", 2.0)
CLOSED = ("kitti-stereo-slam", "drive-closed", 600.0)
BA = ("kitti-offline", "ba-drive-2000", 2.0)
FAULTS = [
    (LIVE, _step_unchanged),
    (LIVE, _last_pose_altered(64)),     # frames 45-64: 2 s at 10 Hz
    (CLOSED, _step_unchanged),
    (CLOSED, _half_block),
    (CLOSED, _last_pose_altered(89)),   # the drive's last frame
    (BA, _ba_unchanged),
    (BA, _ba_half),
    (BA, _ba_altered),
]


@pytest.mark.parametrize("mix,fault", FAULTS,
                         ids=[f"{m[1]}-{f.__name__[1:]}" for m, f in FAULTS])
def test_fault_comes_out_not_correct(mix, fault, monkeypatch, sound_runs):
    base = sound(sound_runs, mix)
    fault(monkeypatch)
    broken = drive(*mix)
    ok, vals = verdict(broken)
    assert not ok, vals
    assert worse(broken, base), (vals, base.checks)
