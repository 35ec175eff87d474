"""The rank processes of the distributed CPU tests (not collected).

`run_ranks(world, cases, inputs, tmp)` spawns `world` ranks with
torch.multiprocessing over gloo (a file:// rendezvous in `tmp`, so
parallel test workers never share a port), each on one PyTorch thread,
and joins them under a time limit; every rank runs each of `cases`
(names in CASES) on the numpy `inputs[case]`, one after the other in
one process group. Returns, per rank, {case: dict of numpy arrays}. A
failed or hung rank raises. This module imports torch and the port
only, so the ranks start without jax.
"""

import os
import pickle
import time

import numpy as np
import torch
import torch.multiprocessing as mp

JOIN_TIMEOUT_S = 240.0
PG_TIMEOUT_S = 120.0


def _t(a):
    return torch.as_tensor(np.array(a))


def _ba_problem(d):
    from slam1_tpu_torch.models.ba import make_problem
    return make_problem(**{k: _t(d[k]) for k in (
        "poses", "points", "cam_idx", "lm_idx", "uv", "w", "ur", "wr")})


def _case_ba(mesh_mod, inputs):
    from slam1_tpu_torch.config import BAConfig
    from slam1_tpu_torch.ops.camera import StereoCamera
    from slam1_tpu_torch.parallel import dist_ba
    mesh = mesh_mod.make_mesh(lm_axis=inputs["lm"], device="cpu")
    sp, _ = dist_ba.partition_problem(_ba_problem(inputs), inputs["lm"])
    cam = StereoCamera(*[_t(x) for x in inputs["cam"]])
    cfg = BAConfig(lm_iters=int(inputs["lm_iters"]),
                   cg_iters=int(inputs["cg_iters"]))
    out, cost, trace = dist_ba.distributed_bundle_adjust(
        sp, cam, cfg, mesh, return_trace=True)
    return dict(poses=out.poses.numpy(), points=out.points.numpy(),
                cost=cost.numpy(), trace=trace.numpy(),
                shape=np.array([mesh.shape["batch"], mesh.shape["lm"]]),
                comm=np.array([mesh.comm["all_reduce_calls"],
                               mesh.comm["all_reduce_bytes"]]))


def _case_pgo(mesh_mod, inputs):
    from slam1_tpu_torch.parallel import dist_pgo
    mesh = mesh_mod.make_mesh(lm_axis=inputs["lm"], device="cpu")
    out = {}
    for name in inputs["graphs"]:
        g = inputs[name]
        poses, cost = dist_pgo.optimize_sharded(
            *[_t(g[k]) for k in ("poses", "z", "w", "le_i", "le_j", "le_z",
                                 "le_w")], mesh=mesh, axis="lm",
            iters=int(g["iters"]), cg_iters=int(g["cg_iters"]))
        out[name + "_poses"] = poses.numpy()
        out[name + "_cost"] = cost.numpy()
    out["p2p_calls"] = np.array(mesh.comm["p2p_calls"])
    return out


def _case_mesh(mesh_mod, inputs):
    """The mesh at every lm axis, and detect_batch split over "batch"."""
    from slam1_tpu_torch.config import tiny_config
    from slam1_tpu_torch.ops.detector import detect_batch
    out = {}
    for lm in (None, 1, 2, 4):
        m = mesh_mod.make_mesh(lm_axis=lm, device="cpu")
        out[f"mesh_{lm}"] = np.array([m.shape["batch"], m.shape["lm"],
                                      m.batch_index, m.lm_index])
    m = mesh_mod.make_mesh(lm_axis=2, device="cpu")
    imgs = mesh_mod.batch_shard(m, _t(inputs["imgs"]))
    f = detect_batch(imgs, tiny_config().detector)
    out.update({f"feat_{k}": v.numpy() for k, v in f._asdict().items()})
    out["batch_index"] = np.array(m.batch_index)
    return out


def _case_cli(mesh_mod, inputs):
    """`slam-torch` in the rank's process group: its stdout lines."""
    import contextlib
    import io

    from slam1_tpu_torch import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(list(inputs["argv"]))
    return {"rc": rc, "stdout": buf.getvalue()}


def _case_dist_ba_scale(mesh_mod, inputs):
    """tools/port_dist_ba_scale.py's comparison in the rank's process
    group: rank 0's record."""
    from tools import port_dist_ba_scale
    rec = port_dist_ba_scale.run(inputs["ckpt"], device="cpu", tiny=True,
                                 lm_iters=inputs["lm_iters"],
                                 cg_iters=inputs["cg_iters"])
    return {"record": rec}


def _graph_counts(kind):
    """{base name: [(captured, replays), ...]} of the registry's graphs of
    `kind`, in the order they were made."""
    from torch_graph_helpers import by_base

    from slam1_tpu_torch.utils.graphs import GRAPHS
    return {name: [(g.graph is not None, g.replays) for g in gs]
            for name, gs in by_base(GRAPHS, kind).items()}


def _case_dist_graphs(mesh_mod, inputs):
    """The sharded solvers at each lm axis of inputs["lms"], eagerly
    (`graphs=False`) and twice through emulated graphs
    (`torch_graph_helpers.emulate_graphs`; the first call captures):
    per run the outputs and `mesh.comm`, per axis the graphs' keys,
    captures and replays."""
    import pytest
    from torch_graph_helpers import emulate_graphs

    from slam1_tpu_torch import parallel
    from slam1_tpu_torch.config import BAConfig
    from slam1_tpu_torch.ops.camera import StereoCamera
    from slam1_tpu_torch.parallel import dist_ba, dist_pgo
    prob = _ba_problem(inputs["ba"])
    cam = StereoCamera(*[_t(x) for x in inputs["cam"]])
    g = inputs["pgo"]
    pargs = [_t(g[k]) for k in ("poses", "z", "w", "le_i", "le_j", "le_z",
                                "le_w")]
    runs = (("eager", False), ("graphed", True), ("replayed", True))
    out = {}
    patch = pytest.MonkeyPatch()
    emulate_graphs(patch)
    try:
        for lm in inputs["lms"]:
            mesh = mesh_mod.make_mesh(lm_axis=lm, device="cpu")
            sp, _ = dist_ba.partition_problem(prob, lm)
            parallel.clear_graphs()
            for name, opx in (("cut", 8.0), ("nocut", 0.0)):
                cfg = BAConfig(lm_iters=int(inputs["lm_iters"]),
                               cg_iters=int(inputs["cg_iters"]),
                               outlier_px=opx)
                for run, graphs in runs:
                    mesh.comm.update({k: 0 for k in mesh.comm})
                    res, cost, trace = dist_ba.distributed_bundle_adjust(
                        sp, cam, cfg, mesh, return_trace=True,
                        graphs=graphs)
                    out[f"ba{lm}_{name}_{run}"] = dict(
                        poses=res.poses.numpy(), points=res.points.numpy(),
                        cost=cost.numpy(), trace=trace.numpy(),
                        comm=dict(mesh.comm))
            for run, graphs in runs:
                mesh.comm.update({k: 0 for k in mesh.comm})
                poses, cost = dist_pgo.optimize_sharded(
                    *pargs, mesh=mesh, axis="lm", iters=int(g["iters"]),
                    cg_iters=int(g["cg_iters"]), n_live=int(g["n_live"]),
                    graphs=graphs)
                out[f"pgo{lm}_{run}"] = dict(poses=poses.numpy(),
                                             cost=cost.numpy(),
                                             comm=dict(mesh.comm))
            out[f"ba{lm}_graphs"] = _graph_counts("dist_ba")
            out[f"pgo{lm}_graphs"] = _graph_counts("dist_pgo")
    finally:
        patch.undo()
    return out


CASES = {"ba": _case_ba, "pgo": _case_pgo, "mesh": _case_mesh,
         "cli": _case_cli, "dist_ba_scale": _case_dist_ba_scale,
         "dist_graphs": _case_dist_graphs}


def _rank_main(rank, world, cases, in_path, init_file, out_dir):
    torch.set_num_threads(1)
    from slam1_tpu_torch import parallel
    from slam1_tpu_torch.parallel import mesh as mesh_mod
    with open(in_path, "rb") as f:
        inputs = pickle.load(f)
    mesh_mod.init_multihost(f"file://{init_file}", world, rank,
                            device="cpu", timeout_s=PG_TIMEOUT_S)
    try:
        out = {case: CASES[case](mesh_mod, inputs[case]) for case in cases}
    finally:
        parallel.clear_graphs()
        torch.distributed.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def run_ranks(world: int, cases, inputs: dict, tmp) -> list:
    tmp = str(tmp)
    os.makedirs(tmp, exist_ok=True)
    in_path = os.path.join(tmp, "inputs.pkl")
    with open(in_path, "wb") as f:
        pickle.dump(inputs, f)
    init_file = os.path.join(tmp, f"rendezvous_{time.time_ns()}")
    ctx = mp.start_processes(_rank_main, args=(world, tuple(cases), in_path,
                                               init_file, tmp),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + JOIN_TIMEOUT_S
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"ranks did not finish in {JOIN_TIMEOUT_S} s")
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
