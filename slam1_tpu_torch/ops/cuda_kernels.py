"""The hand-written Hopper kernels, their build, and their plain twins.

CUDA C++ kernels for sm_90a live in `slam1_tpu_torch/csrc/`:

  - `fast_score.cu`   — FAST-9 score maps; replaces the TPU kernel
    `slam1_tpu/ops/pallas_kernels.py:fast_score`. Its levels entry
    scores every pyramid level of a frame in one launch.
  - `hamming_top2.cu` — fused Hamming top-2 + column argmin with an
    optional geometric gate; replaces
    `slam1_tpu/ops/pallas_kernels.py:hamming_top2`. Its batched entry
    runs a whole loop-verification slate (the vmapped Pallas call of
    `verify_loop_slate`) in one launch.
  - `chain_sweep.cu`  — the two sequential sweeps of the pose graph's
    square-root chain preconditioner (an XLA scan in the reference,
    `slam1_tpu/models/posegraph.py:_chain_sqrt_solve`), and the
    `chain_prepare` launch that fuses the chain's 6x6 blocks once per
    Gauss-Newton iteration.
  - `ba_schur.cu`     — the two halves of the product with bundle
    adjustment's reduced camera system (landmarks, then cameras) that
    its CG path takes 65 times an LM iteration; replaces no TPU kernel
    but the reference's einsums (`slam1_tpu/models/ba.py:256-265`).
  - `ba_obs.cu`       — the observation pass of the same CG path: per
    observation the residual, Huber weight, cut, costs, Jacobians and
    normal blocks, summed by camera and by landmark, and the costs alone
    at another estimate; replaces no TPU kernel but the reference's
    gathers, Jacobians and einsums (`slam1_tpu/models/ba.py` `_cost`,
    `_linearize`, `_schur_solve`).
  - `ba_cg.cu`        — the vector update of the same CG path's
    preconditioned conjugate gradients (step length, x and r, the
    block-Jacobi preconditioner, r.z, the new direction) as one launch
    an iteration, one thread-block cluster, and its start; replaces no
    TPU kernel but `ops/cg.py`'s iteration body (the scan body of
    `slam1_tpu/ops/cg.py`).
  - `bal_obs.cu`      — the observation pass of the same CG path for
    BAL's 9-parameter cameras (`ops/bal_obs.py`): three launches with
    `ba_obs.cu`'s contract; replaces no TPU kernel but the reference's
    `jax.jacfwd` and einsums (`slam1_tpu/models/bal.py`).

`ba_schur.cu` and `ba_cg.cu` take the camera block's width D: 6 (the
stereo rig's twists, camera 0 held as the gauge) or 9 (BAL's cameras,
no camera held); their wrappers read D from the operands' shapes.

Each source is compiled with nvcc into its own shared library with a
plain C interface at first use (all sources at once, from the repo's
sources only, into `slam1_tpu_torch/build/`, each keyed by a hash of
its source) and called through ctypes on PyTorch's current stream;
a build that compiles runs inside the span `host:kernels.build` and
adds the sources it compiled to the counter `kernel_builds`
(`utils/metrics.py`).
Each launch returns `cudaGetLastError()`; the wrapper raises when it is
not 0. Wrappers
allocate every output and scratch buffer with `torch.empty`; the
kernels allocate nothing.

Each `*_cuda` wrapper takes CUDA tensors only and counts its launches
in a plain integer attribute (`fast_score_cuda.launches`, ...), so a
run can show that the main path went through the kernel.
`ops/dispatch.py` picks the kernel for a CUDA tensor and the plain twin
for a CPU tensor.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from typing import NamedTuple

import torch

from slam1_tpu_torch.ops.ba_obs import ObsTerms
from slam1_tpu_torch.ops.brief import unpack_bits
from slam1_tpu_torch.ops.segment import seg_sum
from slam1_tpu_torch.utils import metrics

BIG = 1 << 20
# Levels of the chain sweep's prepared blocks (strides 1, 2, 4, 8): it
# marches 2^(CHAIN_LEVELS - 1) interleaved chains. csrc/chain_sweep.cu
# holds the same constant; build() checks that they agree.
CHAIN_LEVELS = 4
# Most images one fast_score launch takes. csrc/fast_score.cu holds the
# same constant; build() checks that they agree.
FAST_MAX_LEVELS = 8
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("fast_score.cu", "hamming_top2.cu", "chain_sweep.cu",
           "ba_schur.cu", "ba_obs.cu", "ba_cg.cu", "bal_obs.cu")
# Camera block widths of the CG path's kernels: the stereo rig's SE(3)
# twist and BAL's [w, t, f, k1, k2].
WIDTHS = (6, 9)
# Most threads a block of csrc/ba_cg.cu's launch takes (its MAX_THREADS;
# build() checks that they agree).
BA_CG_MAX_THREADS = 256
# ops/cg.cg's default guard, which the CG path's vector update keeps.
CG_EPS = 1e-12
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lib = None
build_seconds = None  # wall time of the nvcc builds in this process


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH or $CUDA_HOME/bin): the CUDA "
                       "kernels cannot be built")


def library_path(source: str) -> str:
    """Where the shared library built from csrc/`source` lives."""
    h = hashlib.sha256()
    with open(os.path.join(CSRC, source), "rb") as f:
        h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    stem = os.path.splitext(source)[0]
    return os.path.join(BUILD_DIR, f"libslam1_{stem}_{h.hexdigest()[:16]}.so")


def tensor_core_sass(source: str):
    """Tensor-core instructions in the SASS of the library built from
    csrc/`source`, as {mnemonic: count} (cuobjdump of the CUDA toolkit);
    None where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or os.path.join(
        os.path.dirname(_nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    sass = subprocess.run([tool, "-sass", library_path(source)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    found = {}
    for line in sass.splitlines():
        for word in line.replace(";", " ").split():
            if "MMA" in word and word[0].isalpha():
                found[word] = found.get(word, 0) + 1
    return found


class _FastLevel(ctypes.Structure):
    """One image of a fast_score launch, as csrc/fast_score.cu reads it
    (`FastLevelArg`): input, output, B, H, W."""
    _fields_ = [("img", ctypes.c_void_p), ("out", ctypes.c_void_p),
                ("b", ctypes.c_int), ("h", ctypes.c_int),
                ("w", ctypes.c_int)]


class _ObsArgs(ctypes.Structure):
    """What every entry of csrc/ba_obs.cu reads (`ObsArgs`): the
    problem's and the camera's device pointers, the 0-d cut and cap (or
    null), the ordering, the squared Huber delta and the sizes."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "poses", "points", "uv", "ur", "wr", "w", "fx", "fy", "cx", "cy",
        "baseline", "cut2", "cap", "cam_rows", "cam_lms", "cam_off",
        "lm_rows", "lm_cams", "lm_off")] + [
        ("delta2", ctypes.c_float), ("n_cams", ctypes.c_int),
        ("n_lms", ctypes.c_int), ("n_obs", ctypes.c_int)]


class _BalArgs(ctypes.Structure):
    """What every entry of csrc/bal_obs.cu reads (`BalArgs`): the
    problem's device pointers, the ordering, the squared Huber delta and
    the sizes."""
    _fields_ = [(name, ctypes.c_void_p) for name in (
        "cams", "points", "uv", "w", "cam_rows", "cam_lms", "cam_off",
        "lm_rows", "lm_cams", "lm_off")] + [
        ("delta2", ctypes.c_float), ("n_cams", ctypes.c_int),
        ("n_lms", ctypes.c_int), ("n_obs", ctypes.c_int)]


class _Kernels:
    """The C entry points of the seven libraries, argtypes declared."""

    def __init__(self, libs):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        self.libs = libs
        fast = libs["fast_score.cu"]
        self.slam_fast_score = fast.slam_fast_score
        self.slam_fast_score.argtypes = [p, p, i, i, i, f, i, p]
        self.slam_fast_score_levels = fast.slam_fast_score_levels
        self.slam_fast_score_levels.argtypes = [
            ctypes.POINTER(_FastLevel), i, f, i, p]
        fast.slam_fast_score_max_levels.argtypes = []
        fast.slam_fast_score_max_levels.restype = i
        if fast.slam_fast_score_max_levels() != FAST_MAX_LEVELS:
            raise RuntimeError("csrc/fast_score.cu and FAST_MAX_LEVELS "
                               "disagree")
        ham = libs["hamming_top2.cu"]
        self.slam_hamming_top2 = ham.slam_hamming_top2
        self.slam_hamming_top2.argtypes = [p, p, p, p, p, p, i, i, i, f, f,
                                           f, i, p, p, p, p, p, p]
        self.slam_hamming_top2_batched = ham.slam_hamming_top2_batched
        self.slam_hamming_top2_batched.argtypes = [p, p, p, p, i, i, i, i,
                                                   p, p, p, p, p, p]
        chain = libs["chain_sweep.cu"]
        self.slam_chain_prepare = chain.slam_chain_prepare
        self.slam_chain_prepare.argtypes = [p, p, i, p, p, p]
        self.slam_chain_sweep = chain.slam_chain_sweep
        self.slam_chain_sweep.argtypes = [p, p, p, p, i, p, p, p, p]
        schur = libs["ba_schur.cu"]
        self.slam_ba_schur_landmarks = schur.slam_ba_schur_landmarks
        self.slam_ba_schur_landmarks.argtypes = [p, p, p, p, p, p, p, i, i,
                                                 p, p]
        self.slam_ba_schur_cameras = schur.slam_ba_schur_cameras
        self.slam_ba_schur_cameras.argtypes = [p, p, p, p, p, p, p, p, i, i,
                                               p, p]
        obs = libs["ba_obs.cu"]
        args = ctypes.POINTER(_ObsArgs)
        self.slam_ba_obs_cameras = obs.slam_ba_obs_cameras
        self.slam_ba_obs_cameras.argtypes = [args, p, p, p, p, p, p, p]
        self.slam_ba_obs_landmarks = obs.slam_ba_obs_landmarks
        self.slam_ba_obs_landmarks.argtypes = [args, p, p, p]
        self.slam_ba_obs_cost = obs.slam_ba_obs_cost
        self.slam_ba_obs_cost.argtypes = [args, p, p, p]
        cg = libs["ba_cg.cu"]
        self.slam_ba_cg_update = cg.slam_ba_cg_update
        self.slam_ba_cg_update.argtypes = [p, p, p, p, p, p, i, i, f, i, i, p,
                                           p, p, p, p]
        bal = libs["bal_obs.cu"]
        bargs = ctypes.POINTER(_BalArgs)
        self.slam_bal_obs_cameras = bal.slam_bal_obs_cameras
        self.slam_bal_obs_cameras.argtypes = [bargs, p, p, p, p, p, p, p]
        self.slam_bal_obs_landmarks = bal.slam_bal_obs_landmarks
        self.slam_bal_obs_landmarks.argtypes = [bargs, p, p, p]
        self.slam_bal_obs_cost = bal.slam_bal_obs_cost
        self.slam_bal_obs_cost.argtypes = [bargs, p, p, p]
        for fn in (self.slam_fast_score, self.slam_fast_score_levels,
                   self.slam_hamming_top2,
                   self.slam_hamming_top2_batched, self.slam_chain_prepare,
                   self.slam_chain_sweep, self.slam_ba_schur_landmarks,
                   self.slam_ba_schur_cameras, self.slam_ba_obs_cameras,
                   self.slam_ba_obs_landmarks, self.slam_ba_obs_cost,
                   self.slam_ba_cg_update, self.slam_bal_obs_cameras,
                   self.slam_bal_obs_landmarks, self.slam_bal_obs_cost):
            fn.restype = i
        obs.slam_ba_obs_args_size.argtypes = []
        obs.slam_ba_obs_args_size.restype = i
        if obs.slam_ba_obs_args_size() != ctypes.sizeof(_ObsArgs):
            raise RuntimeError("csrc/ba_obs.cu's ObsArgs and _ObsArgs "
                               "disagree")
        bal.slam_bal_obs_args_size.argtypes = []
        bal.slam_bal_obs_args_size.restype = i
        if bal.slam_bal_obs_args_size() != ctypes.sizeof(_BalArgs):
            raise RuntimeError("csrc/bal_obs.cu's BalArgs and _BalArgs "
                               "disagree")
        if chain.slam_chain_levels() != CHAIN_LEVELS:
            raise RuntimeError("csrc/chain_sweep.cu and CHAIN_LEVELS disagree")
        # Most rows (F) whose offsets one chain_sweep launch holds in
        # shared memory; a larger F keeps them in a device scratch buffer.
        self.chain_max_live = chain.slam_chain_sweep_max_live()
        cg.slam_ba_cg_max_threads.restype = i
        if cg.slam_ba_cg_max_threads() != BA_CG_MAX_THREADS:
            raise RuntimeError("csrc/ba_cg.cu and BA_CG_MAX_THREADS disagree")
        # The largest cluster the CG update can launch on this card, by
        # camera width (the query also allows it clusters above the
        # portable 8).
        cg.slam_ba_cg_max_cluster.argtypes = [i]
        cg.slam_ba_cg_max_cluster.restype = i
        self.cg_max_cluster = {d: cg.slam_ba_cg_max_cluster(d)
                               for d in WIDTHS}
        for d, n in self.cg_max_cluster.items():
            if n < 1:
                raise RuntimeError(f"csrc/ba_cg.cu: cluster query failed at "
                                   f"D={d} (CUDA error {-n})")


def build(verbose: bool = False) -> _Kernels:
    """Compile (where needed: one nvcc per source, all started together)
    and load the kernel libraries. `verbose` adds -Xptxas=-v and prints
    what the compiler says (registers, shared memory, spills)."""
    global _lib
    if _lib is not None:
        return _lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    todo = [src for src in SOURCES if not os.path.exists(library_path(src))]
    if todo:
        with metrics.span("host:kernels.build"):
            _compile(todo, verbose)
        metrics.count("kernel_builds", len(todo))
    _lib = _Kernels({src: ctypes.CDLL(library_path(src)) for src in SOURCES})
    return _lib


def _compile(sources, verbose: bool):
    """nvcc of each of `sources`, all started together, into
    `library_path`."""
    global build_seconds
    procs = []
    t0 = time.perf_counter()
    for src in sources:
        path = library_path(src)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, src)]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        procs.append((src, path, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for src, path, tmp, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed on {src} ({proc.returncode}):\n{out}")
            continue
        if verbose:
            print(f"nvcc {src}:\n{out}", flush=True)
        os.replace(tmp, path)
    build_seconds = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n".join(failed))


def _check(t: torch.Tensor, name: str, dtype, shape=None):
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _raise_on(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} "
                           f"({torch.cuda.get_device_name()})")


# ---------------------------------------------------------------------------
# FAST-9 score
# ---------------------------------------------------------------------------

def _check_fast_args(imgs, arc, single=None):
    """What the FAST kernel takes: float32, contiguous (B,H,W) CUDA
    tensors with at least one pixel, all on one device with one B.
    `single` names the argument when it is one image, not a list."""
    if not 1 <= arc <= 16:
        raise ValueError(f"arc must be in [1, 16], got {arc}")
    if not 1 <= len(imgs) <= FAST_MAX_LEVELS:
        raise ValueError(f"imgs: expected 1 to {FAST_MAX_LEVELS} levels, "
                         f"got {len(imgs)}")
    for n, im in enumerate(imgs):
        name = single or f"imgs[{n}]"
        if im.dim() != 3:
            raise ValueError(f"{name}: expected (B,H,W), got "
                             f"{tuple(im.shape)}")
        _check(im, name, torch.float32)
        if im.numel() == 0:
            raise ValueError(f"{name}: empty image {tuple(im.shape)}")
        if im.device != imgs[0].device:
            raise ValueError(f"{name}: on {im.device}, imgs[0] on "
                             f"{imgs[0].device}")
        if im.shape[0] != imgs[0].shape[0]:
            raise ValueError(f"{name}: batch {im.shape[0]}, imgs[0] has "
                             f"{imgs[0].shape[0]}")


def fast_score_levels_cuda(imgs, threshold: float, arc: int = 9):
    """FAST scores of 1 to 8 (B,H,W) float32 CUDA tensors (the levels of
    a pyramid; any sizes, one B) in ONE launch of csrc/fast_score.cu.
    Returns one score map per image, as ops.fast.fast_score gives it."""
    imgs = list(imgs)
    _check_fast_args(imgs, arc)
    # One allocation per level: PyTorch's allocator hands out 512-byte
    # aligned blocks, so the kernel can store vectors wherever W % 4 ==
    # 0, and an empty_like costs the host less than a slice and a view
    # of one shared buffer.
    outs = [torch.empty_like(im) for im in imgs]
    levels = (_FastLevel * len(imgs))(*[
        _FastLevel(im.data_ptr(), o.data_ptr(), *im.shape)
        for im, o in zip(imgs, outs)])
    lib = build()
    stream = torch.cuda.current_stream(imgs[0].device).cuda_stream
    _raise_on(lib.slam_fast_score_levels(levels, len(imgs), float(threshold),
                                         int(arc), stream),
              "fast_score launch")
    fast_score_cuda.launches += 1
    return outs


def fast_score_cuda(img: torch.Tensor, threshold: float,
                    arc: int = 9) -> torch.Tensor:
    """FAST score of a (B,H,W) or (H,W) float32 CUDA tensor via the
    kernel in csrc/fast_score.cu (its one-level case). Same contract as
    ops.fast.fast_score."""
    if img.dim() not in (2, 3):
        raise ValueError(f"img: expected (B,H,W) or (H,W), got "
                         f"{tuple(img.shape)}")
    x = img[None] if img.dim() == 2 else img
    _check_fast_args([x], arc, single="img")
    out = torch.empty_like(x)
    lib = build()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise_on(lib.slam_fast_score(x.data_ptr(), out.data_ptr(), *x.shape,
                                  float(threshold), int(arc), stream),
              "fast_score launch")
    fast_score_cuda.launches += 1
    return out.view(img.shape)


# Launches of the FAST kernel through either wrapper.
fast_score_cuda.launches = 0


# ---------------------------------------------------------------------------
# Hamming top-2
# ---------------------------------------------------------------------------

def _gate_args(uv_a, uv_b, dy_tol):
    if (uv_a is None) != (dy_tol is None) or (uv_a is None) != (uv_b is None):
        raise ValueError("uv_a, uv_b and dy_tol go together")


def hamming_top2_plain(desc_a, desc_b, mask_a, mask_b, *, uv_a=None,
                       uv_b=None, dy_tol=None, dx_lo=0.0, dx_hi=0.0):
    """Plain twin of hamming_top2_cuda: a dense (N,M) distance matrix,
    the gate applied to it, then first-occurrence top-2 / argmins.
    Returns d1, d2, idx (N,) and col_best (M,), all int32."""
    _gate_args(uv_a, uv_b, dy_tol)
    d = distance_matrix(desc_a, desc_b, mask_a, mask_b)
    if uv_a is not None:
        dy = torch.abs(uv_a[:, 1:2] - uv_b[None, :, 1])
        dx = uv_a[:, 0:1] - uv_b[None, :, 0]
        bad = (dy > dy_tol) | (dx < dx_lo) | (dx > dx_hi)
        d = torch.where(bad, torch.full_like(d, BIG), d)
    d1, idx = torch.min(d, dim=1)            # first occurrence on ties
    cols = torch.arange(d.shape[1], device=d.device)
    d2 = torch.min(torch.where(cols[None, :] == idx[:, None],
                               torch.full_like(d, BIG), d), dim=1).values
    col_best = torch.argmin(d, dim=0)
    return (d1.int(), d2.int(), idx.int(), col_best.int())


def distance_matrix(desc_a, desc_b, mask_a=None, mask_b=None):
    """Packed uint8 descriptors (..., N, 32), (..., M, 32) -> (..., N, M)
    int32 Hamming distances, with the sentinel 2^20 on invalid rows and
    columns. Computed as a {-1,+1} float32 product, which is exact for
    integers this small."""
    bits = desc_a.shape[-1] * 8
    a = unpack_bits(desc_a).float() * 2.0 - 1.0
    b = unpack_bits(desc_b).float() * 2.0 - 1.0
    sim = (a @ b.transpose(-1, -2)).int()
    d = (bits - sim) // 2
    big = torch.full_like(d, BIG)
    if mask_a is not None:
        d = torch.where(mask_a[..., :, None], d, big)
    if mask_b is not None:
        d = torch.where(mask_b[..., None, :], d, big)
    return d


def hamming_top2_cuda(desc_a, desc_b, mask_a, mask_b, *, uv_a=None,
                      uv_b=None, dy_tol=None, dx_lo=0.0, dx_hi=0.0):
    """Fused Hamming top-2 on CUDA tensors via csrc/hamming_top2.cu, at
    any N and M (>= 2 columns). Same contract as hamming_top2_plain."""
    _gate_args(uv_a, uv_b, dy_tol)
    n, m = desc_a.shape[0], desc_b.shape[0]
    _check(desc_a, "desc_a", torch.uint8, (n, 32))
    _check(desc_b, "desc_b", torch.uint8, (m, 32))
    _check(mask_a, "mask_a", torch.bool, (n,))
    _check(mask_b, "mask_b", torch.bool, (m,))
    if m < 2 or n < 1 or n >= (1 << 23) or m >= (1 << 22):
        raise ValueError(f"hamming_top2_cuda: unsupported N={n}, M={m}")
    _check_aligned(desc_a=desc_a, desc_b=desc_b)
    gated = uv_a is not None
    if gated:
        _check(uv_a, "uv_a", torch.float32, (n, 2))
        _check(uv_b, "uv_b", torch.float32, (m, 2))
        _check_aligned(8, uv_a=uv_a, uv_b=uv_b)
    dev = desc_a.device
    cols, words = _column_strips(n, m, 1)
    scratch = torch.empty((words,), dtype=torch.int32, device=dev)
    d1 = torch.empty((n,), dtype=torch.int32, device=dev)
    d2 = torch.empty_like(d1)
    idx = torch.empty_like(d1)
    col_best = torch.empty((m,), dtype=torch.int32, device=dev)
    lib = build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.slam_hamming_top2(
        desc_a.data_ptr(), desc_b.data_ptr(), mask_a.data_ptr(),
        mask_b.data_ptr(), uv_a.data_ptr() if gated else None,
        uv_b.data_ptr() if gated else None, n, m, int(gated),
        float(dy_tol) if gated else 0.0, float(dx_lo), float(dx_hi),
        cols, scratch.data_ptr(), d1.data_ptr(), d2.data_ptr(),
        idx.data_ptr(), col_best.data_ptr(), stream)
    _raise_on(err, "hamming_top2 launch")
    hamming_top2_cuda.launches += 1
    return d1, d2, idx, col_best


hamming_top2_cuda.launches = 0


def _check_aligned(align: int = 16, **tensors):
    for name, t in tensors.items():
        if t.data_ptr() % align:
            raise ValueError(f"{name}: expected {align}-byte alignment")


def _column_strips(n, m, problems):
    """How csrc/hamming_top2.cu cuts the columns: (columns per strip,
    int32 words of scratch). Strips are a multiple of 8 columns (one MMA
    tile), at most 512 (the kernel's shared memory), and narrow enough
    that >= 2 blocks of 128 rows sit on each of the 132 SMs."""
    row_blocks = -(-n // 128)
    splits = max(-(-264 // (row_blocks * problems)), -(-m // 512))
    cols = -(-(-(-m // splits)) // 8) * 8
    splits = -(-m // cols)
    head = problems * (m + row_blocks + 1)
    return cols, head + head % 2 + problems * 2 * splits * n


def hamming_top2_batched_plain(desc_a, desc_b, mask_a, mask_b):
    """Plain twin of hamming_top2_batched_cuda: B ungated problems,
    (B,N,32) x (B,M,32) -> d1, d2, idx (B,N) and col_best (B,M)."""
    d = distance_matrix(desc_a, desc_b, mask_a, mask_b)     # (B,N,M)
    d1, idx = torch.min(d, dim=2)
    cols = torch.arange(d.shape[2], device=d.device)
    d2 = torch.min(torch.where(cols == idx[..., None],
                               torch.full_like(d, BIG), d), dim=2).values
    col_best = torch.argmin(d, dim=1)
    return (d1.int(), d2.int(), idx.int(), col_best.int())


def hamming_top2_batched_cuda(desc_a, desc_b, mask_a, mask_b):
    """B ungated Hamming top-2 problems in one launch of the batched
    entry of csrc/hamming_top2.cu. Same contract as the plain twin."""
    b, n = desc_a.shape[:2]
    m = desc_b.shape[1]
    _check(desc_a, "desc_a", torch.uint8, (b, n, 32))
    _check(desc_b, "desc_b", torch.uint8, (b, m, 32))
    _check(mask_a, "mask_a", torch.bool, (b, n))
    _check(mask_b, "mask_b", torch.bool, (b, m))
    if (m < 2 or n < 1 or n >= (1 << 23) or m >= (1 << 22) or b < 1
            or b > 65535):
        raise ValueError(f"hamming_top2_batched_cuda: unsupported B={b}, "
                         f"N={n}, M={m}")
    _check_aligned(desc_a=desc_a, desc_b=desc_b)
    dev = desc_a.device
    cols, words = _column_strips(n, m, b)
    scratch = torch.empty((words,), dtype=torch.int32, device=dev)
    d1 = torch.empty((b, n), dtype=torch.int32, device=dev)
    d2 = torch.empty_like(d1)
    idx = torch.empty_like(d1)
    col_best = torch.empty((b, m), dtype=torch.int32, device=dev)
    lib = build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.slam_hamming_top2_batched(
        desc_a.data_ptr(), desc_b.data_ptr(), mask_a.data_ptr(),
        mask_b.data_ptr(), b, n, m, cols, scratch.data_ptr(), d1.data_ptr(),
        d2.data_ptr(), idx.data_ptr(), col_best.data_ptr(), stream)
    _raise_on(err, "hamming_top2_batched launch")
    hamming_top2_batched_cuda.launches += 1
    return d1, d2, idx, col_best


hamming_top2_batched_cuda.launches = 0


# ---------------------------------------------------------------------------
# Pose-graph chain sweeps
# ---------------------------------------------------------------------------
#
# `n_live` is an int or a 0-d int32 tensor: the kernels read it from
# device memory, so that one captured launch serves every value; the
# plain twins loop over the live rows and read its value on the host.

def chain_sweep_plain(jj_inv, ji, winv, v, n_live):
    """Plain twin of chain_sweep_cuda: the two sweeps of the square-root
    chain preconditioner as a loop over rows (see csrc/chain_sweep.cu).
    jj_inv, ji (F,6,6); winv (F,); v (F,6) -> x (F,6), x_0 = 0; rows
    from n_live on are decoupled (x_i = winv_i v_i)."""
    n_live = int(n_live)
    x = winv[:, None] * v
    x[0].zero_()
    s = torch.zeros(6, dtype=v.dtype, device=v.device)
    for i in range(n_live - 1, 0, -1):
        w = ji[i + 1].T @ s if i + 1 < n_live else torch.zeros_like(s)
        s = jj_inv[i].T @ (v[i] - w)
        x[i] = s
    xp = torch.zeros_like(s)
    for i in range(1, n_live):
        xp = jj_inv[i] @ (winv[i] * x[i] - ji[i] @ xp)
        x[i] = xp
    return x


def chain_prepare_plain(jj_inv, ji, n_live):
    """Plain twin of chain_prepare_cuda: the fused blocks of the chain,
    (CHAIN_LEVELS, 2, F, 6, 6). Level 0 holds, for live rows i,
    [0,i] = -JjInv_i^T Ji_{i+1}^T (the backward sweep's step from row
    i + 1; zero at the last live row) and [1,i] = -JjInv_i Ji_i (the
    forward sweep's step from row i - 1; zero at row 1, since x_0 = 0).
    Level l + 1 composes two steps of level l: [0,i] = B_i B_{i+j},
    [1,i] = B_i B_{i-j}, j = 2^l, zero where the step leaves the live
    rows [1, n_live)."""
    prep = torch.zeros((CHAIN_LEVELS, 2, jj_inv.shape[0], 6, 6),
                       dtype=jj_inv.dtype, device=jj_inv.device)
    n = int(n_live)
    if n >= 3:
        prep[0, 0, 1:n - 1] = -(jj_inv[1:n - 1].transpose(1, 2)
                                @ ji[2:n].transpose(1, 2))
        prep[0, 1, 2:n] = -(jj_inv[2:n] @ ji[2:n])
    for lvl in range(CHAIN_LEVELS - 1):
        j = 1 << lvl
        if n - j > 1:
            back, fwd = prep[lvl]
            prep[lvl + 1, 0, 1:n - j] = back[1:n - j] @ back[1 + j:n]
            prep[lvl + 1, 1, 1 + j:n] = fwd[1 + j:n] @ fwd[1:n - j]
    return prep


def _strided_solve(blocks, d):
    """y_k = d_k + B_k y_{k-1} (y_{-1} = 0) over k = 0..n-1 as
    csrc/chain_sweep.cu solves it: blocks (L, n, 6, 6) with level l
    stepping 2^l rows; the offsets doubled L - 1 times, then K = 2^(L-1)
    interleaved chains y_k = d_k + B_k y_{k-K} marched side by side."""
    levels, n = blocks.shape[:2]
    for lvl in range(levels - 1):
        j = 1 << lvl
        if j < n:
            d = torch.cat([d[:j], d[j:] + torch.einsum(
                "kab,kb->ka", blocks[lvl, j:], d[:-j])])
    k = 1 << (levels - 1)
    y = torch.zeros_like(d)
    prev = torch.zeros((k, 6), dtype=d.dtype, device=d.device)
    for t in range(0, n, k):
        m = min(k, n - t)
        prev = d[t:t + m] + torch.einsum("kab,kb->ka",
                                         blocks[-1, t:t + m], prev[:m])
        y[t:t + m] = prev
    return y


def chain_sweep_fused_plain(jj_inv, ji, winv, v, n_live):
    """The algebra of csrc/chain_sweep.cu in plain PyTorch, for the
    tests: the 6x6 blocks fused and doubled once (chain_prepare_plain),
    the offsets c_i = JjInv_i^T v_i and e_i = JjInv_i (winv_i s_i)
    computed for all rows at once, and each sweep solved as
    2^(CHAIN_LEVELS - 1) interleaved chains of one product per row.
    Same contract as chain_sweep_plain; the float32 sums are associated
    differently."""
    n_live = int(n_live)
    x = winv[:, None] * v
    x[0].zero_()
    if n_live < 2:
        return x
    live = slice(1, n_live)
    prep = chain_prepare_plain(jj_inv, ji, n_live)
    c = torch.einsum("iba,ib->ia", jj_inv[live], v[live])
    # Backward: row n_live - 1 first.
    s = _strided_solve(prep[:, 0, live].flip(1), c.flip(0)).flip(0)
    e = torch.einsum("iab,ib->ia", jj_inv[live], winv[live, None] * s)
    x[live] = _strided_solve(prep[:, 1, live], e)
    return x


def _live_arg(n_live, device, f: int, what: str) -> torch.Tensor:
    """n_live as the chain kernels read it: a 0-d int32 tensor on
    `device`. An int is checked against [1, f] here and filled on the
    device; a tensor is taken as it is (reading it would stall the host),
    and the kernels bound its value."""
    if isinstance(n_live, torch.Tensor):
        _check(n_live, f"{what}: n_live", torch.int32, ())
        if n_live.device != device:
            raise ValueError(f"{what}: n_live on {n_live.device}, the "
                             f"operands on {device}")
        return n_live
    if not 1 <= n_live <= f:
        raise ValueError(f"{what}: n_live={n_live} not in [1, {f}]")
    return torch.full((), n_live, dtype=torch.int32, device=device)


def chain_prepare_cuda(jj_inv, ji, n_live):
    """The fused 6x6 blocks of the chain, (CHAIN_LEVELS, 2, F, 6, 6), as
    chain_prepare_plain defines them, by the prepare kernels of
    csrc/chain_sweep.cu. They hold for as long as jj_inv and ji do (one
    Gauss-Newton iteration); chain_sweep_cuda takes them as `prep`.
    `n_live`: an int in [1, F], or a 0-d int32 tensor on the operands'
    device (a value above F counts as F)."""
    f = jj_inv.shape[0]
    _check(jj_inv, "jj_inv", torch.float32, (f, 6, 6))
    _check(ji, "ji", torch.float32, (f, 6, 6))
    live = _live_arg(n_live, jj_inv.device, f, "chain_prepare_cuda")
    prep = torch.empty((CHAIN_LEVELS, 2, f, 6, 6), dtype=torch.float32,
                       device=jj_inv.device)
    lib = build()
    stream = torch.cuda.current_stream(jj_inv.device).cuda_stream
    _raise_on(lib.slam_chain_prepare(jj_inv.data_ptr(), ji.data_ptr(), f,
                                     live.data_ptr(), prep.data_ptr(),
                                     stream),
              "chain_prepare launch")
    chain_prepare_cuda.launches += 1
    return prep


chain_prepare_cuda.launches = 0


def chain_sweep_staged(f: int) -> bool:
    """Whether chain_sweep_cuda keeps the offsets of an F-row chain in a
    device scratch buffer (F above the kernel's shared-memory rows, 8533
    on the H100) rather than in shared memory: decided by F alone."""
    return f > build().chain_max_live


def chain_sweep_cuda(jj_inv, ji, winv, v, n_live, prep=None):
    """The two chain sweeps in one launch of csrc/chain_sweep.cu. Same
    contract as chain_sweep_plain, for any F. `n_live`: an int in [1, F],
    or a 0-d int32 tensor on the operands' device, whose value the
    kernel bounds (outside [1, F] x is all NaN). Where F exceeds what
    shared memory holds (chain_sweep_staged) the kernel's offsets go to
    a (2, F, 6) scratch buffer allocated here. `prep` is
    chain_prepare_cuda's result for the same jj_inv, ji and n_live,
    which `posegraph.gn_step` makes once per Gauss-Newton iteration. It
    is optional only so that the call without it keeps working as it
    did before the blocks were fused: the blocks are then prepared here,
    by one more counted call of chain_prepare_cuda."""
    f = v.shape[0]
    _check(jj_inv, "jj_inv", torch.float32, (f, 6, 6))
    _check(ji, "ji", torch.float32, (f, 6, 6))
    _check(winv, "winv", torch.float32, (f,))
    _check(v, "v", torch.float32, (f, 6))
    lib = build()
    live = _live_arg(n_live, v.device, f, "chain_sweep_cuda")
    if prep is None:
        prep = chain_prepare_cuda(jj_inv, ji, live)
    _check(prep, "prep", torch.float32, (CHAIN_LEVELS, 2, f, 6, 6))
    x = torch.empty_like(v)
    scratch = None
    if chain_sweep_staged(f):
        scratch = torch.empty((2, f, 6), dtype=torch.float32,
                              device=v.device)
    stream = torch.cuda.current_stream(v.device).cuda_stream
    _raise_on(lib.slam_chain_sweep(
        jj_inv.data_ptr(), prep.data_ptr(), winv.data_ptr(), v.data_ptr(),
        f, live.data_ptr(), None if scratch is None else scratch.data_ptr(),
        x.data_ptr(), stream), "chain_sweep launch")
    chain_sweep_cuda.launches += 1
    return x


chain_sweep_cuda.launches = 0


# ---------------------------------------------------------------------------
# Bundle adjustment's reduced camera system
# ---------------------------------------------------------------------------
#
# S x = Hcc_d x - sum_o W_o Hll_inv_{l_o} sum_{o' in l_o} W_o'^T x_{c_o'}
# in two halves: the landmark half v = Hll_inv (a - s) and the camera
# half out = h - sum_o W_o v_{l_o} (see csrc/ba_schur.cu), at the camera
# width D of W (O,D,3), 6 or 9; at D = 6 (the stereo rig) camera row 0 is
# held as the gauge, at D = 9 (BAL) no row is.
# The plain twins are the einsums and float64 segment sums `models/ba.py`
# wrote before the kernels, operation for operation.


class SchurOrder(NamedTuple):
    """BA's observations as the reduced-system product visits them:
    `cam_idx`, `lm_idx` (O,) int64, which the plain twins index with, and
    for the kernels (None where the twins run) the observation rows
    sorted stably by landmark (`lm_rows`, each row's camera `lm_cams`,
    offsets `lm_off` (L+1,)) and by camera (`cam_rows`, each row's
    landmark `cam_lms`, offsets `cam_off` (C+1,)), all int32."""
    cam_idx: torch.Tensor
    lm_idx: torch.Tensor
    lm_rows: torch.Tensor | None = None
    lm_cams: torch.Tensor | None = None
    lm_off: torch.Tensor | None = None
    cam_rows: torch.Tensor | None = None
    cam_lms: torch.Tensor | None = None
    cam_off: torch.Tensor | None = None


def segment_order(idx, n: int):
    """(rows, off): the positions of `idx` (O,) sorted stably by value,
    int32, and offsets (n+1,) int32 such that rows[off[s]:off[s+1]] are
    the positions whose value is s, in their order. Made on idx's device
    with nothing read back (no bincount): a captured graph can hold it.
    Values outside [0, n) fall outside every segment. The keys are
    sorted as int32 (half the radix passes of int64)."""
    keys, rows = torch.sort(idx.int(), stable=True)
    bounds = torch.arange(n + 1, dtype=keys.dtype, device=keys.device)
    return rows.int(), torch.searchsorted(keys, bounds, out_int32=True)


def schur_order(cam_idx, lm_idx, n_cams: int, n_lms: int,
                kernels: bool, w=None) -> SchurOrder:
    """The SchurOrder of observations (cam_idx, lm_idx) over n_cams
    cameras and n_lms landmarks; the kernels' orderings only where
    `kernels` (made once per LM iteration, read by every kernel of it).

    Given the observations' weights w (O,), the kernels' orderings leave
    out every observation of weight zero (a bucket's padding): it adds a
    zero to each sum, and a problem's padding all points at one landmark,
    whose thread in a landmark kernel would walk every padded row. The
    left-out rows follow the others in `cam_rows` and `lm_rows`."""
    ci, li = cam_idx.long(), lm_idx.long()
    if not kernels:
        return SchurOrder(ci, li)
    if ci.shape[0] >= 1 << 31:
        raise ValueError(f"schur_order: {ci.shape[0]} observations do not "
                         f"fit int32 rows")
    lm_key, cam_key = li, ci
    if w is not None:
        zero = w == 0
        lm_key = torch.where(zero, n_lms, li)
        cam_key = torch.where(zero, n_cams, ci)
    lm_rows, lm_off = segment_order(lm_key, n_lms)
    cam_rows, cam_off = segment_order(cam_key, n_cams)
    return SchurOrder(ci, li, lm_rows, ci.index_select(0, lm_rows).int(),
                      lm_off, cam_rows, li.index_select(0, cam_rows).int(),
                      cam_off)


def ba_schur_landmarks_plain(W, hll_inv, order, x=None, a=None):
    """Plain twin of ba_schur_landmarks_cuda: v (L,3) = Hll_inv t with
    s = seg_sum_l(W^T x[c]) and t = a - s (x and a given), s (x alone:
    the product's own term) or a (a alone)."""
    if x is None:
        t = a
    else:
        u = torch.einsum("oij,oi->oj", W, x[order.cam_idx])        # (O,3)
        s = seg_sum(hll_inv.shape[0], order.lm_idx, u)
        t = s if a is None else a - s
    return torch.einsum("lij,lj->li", hll_inv, t)


def ba_schur_cameras_plain(W, v, order, hcc=None, x=None, b=None):
    """Plain twin of ba_schur_cameras_cuda: out (C,D) = Hcc_d x - y
    (hcc and x given: the product; at D = 6 row 0, the gauge, x_0) or
    b - y (b given: the right side; at D = 6 row 0 zero),
    y = seg_sum_c(W v[l])."""
    held = W.shape[1] == 6
    y = torch.einsum("oij,oj->oi", W, v[order.lm_idx])             # (O,D)
    if hcc is not None:
        out = torch.einsum("cij,cj->ci", hcc, x) - seg_sum(
            hcc.shape[0], order.cam_idx, y)
        if held:
            out[0] = x[0]
    else:
        out = b - seg_sum(b.shape[0], order.cam_idx, y)
        if held:
            out[0].zero_()
    return out


def _check_order(order, o: int):
    """The kernels' orderings of a SchurOrder over O observations ->
    (C, L)."""
    if order.lm_rows is None:
        raise ValueError("order: made without the kernels' orderings")
    for name in ("lm_rows", "lm_cams", "cam_rows", "cam_lms"):
        _check(getattr(order, name), f"order.{name}", torch.int32, (o,))
    n_cams, n_lms = order.cam_off.shape[0] - 1, order.lm_off.shape[0] - 1
    _check(order.cam_off, "order.cam_off", torch.int32, (n_cams + 1,))
    _check(order.lm_off, "order.lm_off", torch.int32, (n_lms + 1,))
    return n_cams, n_lms


def _ptr(t):
    return None if t is None else t.data_ptr()


def _width(W) -> int:
    """The camera width D of coupling blocks W (O,D,3), 6 or 9."""
    d = W.shape[1] if W.dim() == 3 else None
    if d not in WIDTHS:
        raise ValueError(f"W: expected (O,D,3) with D in {WIDTHS}, got "
                         f"{tuple(W.shape)}")
    return d


def _check_rows(d: int, align: int = 8, **tensors):
    """The alignment a kernel's vector loads need at D = 6 (`align`
    bytes); at D = 9 every row is read as floats."""
    if d == 6:
        _check_aligned(align, **tensors)


def ba_schur_landmarks_cuda(W, hll_inv, order, x=None, a=None):
    """The landmark half in one launch of csrc/ba_schur.cu. Same
    contract as ba_schur_landmarks_plain; `order` holds the kernels'
    orderings (schur_order with kernels=True)."""
    o, d = W.shape[0], _width(W)
    _check(W, "W", torch.float32, (o, d, 3))
    n_cams, n_lms = _check_order(order, o)
    _check(hll_inv, "hll_inv", torch.float32, (n_lms, 3, 3))
    if x is None and a is None:
        raise ValueError("ba_schur_landmarks_cuda: give x, a or both")
    if x is not None:
        _check(x, "x", torch.float32, (n_cams, d))
        _check_rows(d, x=x)
    if a is not None:
        _check(a, "a", torch.float32, (n_lms, 3))
    _check_rows(d, W=W)
    v = torch.empty((n_lms, 3), dtype=torch.float32, device=W.device)
    if n_lms == 0:
        return v
    lib = build()
    stream = torch.cuda.current_stream(W.device).cuda_stream
    _raise_on(lib.slam_ba_schur_landmarks(
        W.data_ptr(), order.lm_rows.data_ptr(), order.lm_cams.data_ptr(),
        order.lm_off.data_ptr(), _ptr(x), _ptr(a), hll_inv.data_ptr(), n_lms,
        d, v.data_ptr(), stream), "ba_schur landmarks launch")
    ba_schur_landmarks_cuda.launches += 1
    return v


# Launches of both halves.
ba_schur_landmarks_cuda.launches = 0


def ba_schur_cameras_cuda(W, v, order, hcc=None, x=None, b=None):
    """The camera half in one launch of csrc/ba_schur.cu. Same contract
    as ba_schur_cameras_plain; `order` as for ba_schur_landmarks_cuda."""
    o, d = W.shape[0], _width(W)
    _check(W, "W", torch.float32, (o, d, 3))
    n_cams, n_lms = _check_order(order, o)
    _check(v, "v", torch.float32, (n_lms, 3))
    if (hcc is None) != (x is None) or (hcc is None) == (b is None):
        raise ValueError("ba_schur_cameras_cuda: give hcc and x, or b")
    if hcc is not None:
        _check(hcc, "hcc", torch.float32, (n_cams, d, d))
        _check(x, "x", torch.float32, (n_cams, d))
    else:
        _check(b, "b", torch.float32, (n_cams, d))
    _check_rows(d, W=W)
    out = torch.empty((n_cams, d), dtype=torch.float32, device=W.device)
    if n_cams == 0:
        return out
    lib = build()
    stream = torch.cuda.current_stream(W.device).cuda_stream
    _raise_on(lib.slam_ba_schur_cameras(
        W.data_ptr(), order.cam_rows.data_ptr(), order.cam_lms.data_ptr(),
        order.cam_off.data_ptr(), v.data_ptr(), _ptr(hcc), _ptr(x), _ptr(b),
        n_cams, d, out.data_ptr(), stream),
        "ba_schur cameras launch")
    ba_schur_landmarks_cuda.launches += 1
    return out


# ---------------------------------------------------------------------------
# Bundle adjustment's observation pass
# ---------------------------------------------------------------------------
#
# Per observation the residual, Huber weight, cut, costs, Jacobians and
# normal blocks, by camera and by landmark (see csrc/ba_obs.cu). The
# plain twins are `ops/ba_obs.py`'s `cameras_plain`, `landmarks_plain`
# and `cost_plain`.


def _scalar_arg(t, name: str, device):
    """The device pointer of an optional 0-d float32 tensor (None: null)."""
    if t is None:
        return None
    _check(t, name, torch.float32, ())
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, the problem on {device}")
    return t.data_ptr()


def _obs_args(problem, cam, order, cut2, cap, huber_delta: float):
    """(_ObsArgs, the tensors it points into) of one launch of
    csrc/ba_obs.cu: the problem's poses, points, uv, ur, wr and w, the
    camera's five 0-d fields, the 0-d cut2 and cap (or None) and the
    kernels' orderings of `order`, all float32 or int32 on one card."""
    poses, points, uv, ur, wr, w = [x.contiguous() for x in (
        problem.poses, problem.points, problem.uv, problem.ur, problem.wr,
        problem.w)]
    c, n_l, o = poses.shape[0], points.shape[0], uv.shape[0]
    _check(poses, "poses", torch.float32, (c, 4, 4))
    _check(points, "points", torch.float32, (n_l, 3))
    _check(uv, "uv", torch.float32, (o, 2))
    for name, t in (("ur", ur), ("wr", wr), ("w", w)):
        _check(t, name, torch.float32, (o,))
    _check_aligned(16, poses=poses)
    _check_aligned(8, uv=uv)
    made_for = _check_order(order, o)
    if made_for != (c, n_l):
        raise ValueError(f"order: made for {made_for} cameras and "
                         f"landmarks, the problem has {(c, n_l)}")
    dev = poses.device
    for t in (points, uv, ur, wr, w, order.cam_rows, order.lm_rows):
        if t.device != dev:
            raise ValueError(f"the problem's tensors are on {t.device} and "
                             f"{dev}")
    if max(c, n_l, o) >= 1 << 31:
        raise ValueError(f"ba_obs: {(c, n_l, o)} do not fit int32")
    fields = [_scalar_arg(v, f"cam.{k}", dev) for k, v in
              zip(("fx", "fy", "cx", "cy", "baseline"), cam)]
    args = _ObsArgs(
        poses.data_ptr(), points.data_ptr(), uv.data_ptr(), ur.data_ptr(),
        wr.data_ptr(), w.data_ptr(), *fields,
        _scalar_arg(cut2, "cut2", dev), _scalar_arg(cap, "cap", dev),
        order.cam_rows.data_ptr(), order.cam_lms.data_ptr(),
        order.cam_off.data_ptr(), order.lm_rows.data_ptr(),
        order.lm_cams.data_ptr(), order.lm_off.data_ptr(),
        float(huber_delta) * float(huber_delta), c, n_l, o)
    return args, (poses, points, uv, ur, wr, w)


def ba_obs_cameras_cuda(problem, cam, order, cut2, cap, huber_delta: float):
    """The observation pass by camera in one launch of csrc/ba_obs.cu (and
    the costs' one-block sum). Same contract as ba_obs.cameras_plain;
    `order` holds the kernels' orderings (schur_order with kernels=True,
    made with the problem's weights)."""
    args, keep = _obs_args(problem, cam, order, cut2, cap, huber_delta)
    dev = keep[0].device
    W = torch.empty((args.n_obs, 6, 3), dtype=torch.float32, device=dev)
    hcc = torch.empty((args.n_cams, 6, 6), dtype=torch.float32, device=dev)
    bc = torch.empty((args.n_cams, 6), dtype=torch.float32, device=dev)
    part = torch.empty((args.n_cams, 3), dtype=torch.float64, device=dev)
    costs = torch.empty((2,), dtype=torch.float32, device=dev)
    n_kept = torch.empty((), dtype=torch.int32, device=dev)
    lib = build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(lib.slam_ba_obs_cameras(
        ctypes.byref(args), W.data_ptr(), hcc.data_ptr(), bc.data_ptr(),
        part.data_ptr(), costs.data_ptr(), n_kept.data_ptr(), stream),
        "ba_obs cameras launch")
    ba_obs_cameras_cuda.launches += 1
    return ObsTerms(W, hcc, bc, costs[0], costs[1], n_kept)


# Launches of the three entries.
ba_obs_cameras_cuda.launches = 0


def ba_obs_landmarks_cuda(problem, cam, order, cut2, huber_delta: float):
    """The observation pass by landmark in one launch of csrc/ba_obs.cu.
    Same contract as ba_obs.landmarks_plain; `order` as for
    ba_obs_cameras_cuda."""
    args, keep = _obs_args(problem, cam, order, cut2, None, huber_delta)
    dev = keep[0].device
    hll = torch.empty((args.n_lms, 3, 3), dtype=torch.float32, device=dev)
    bl = torch.empty((args.n_lms, 3), dtype=torch.float32, device=dev)
    if args.n_lms == 0:
        return hll, bl
    lib = build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(lib.slam_ba_obs_landmarks(
        ctypes.byref(args), hll.data_ptr(), bl.data_ptr(), stream),
        "ba_obs landmarks launch")
    ba_obs_cameras_cuda.launches += 1
    return hll, bl


def ba_obs_cost_cuda(problem, cam, order, cap, huber_delta: float):
    """The two costs in one launch of csrc/ba_obs.cu (and their one-block
    sum), the bits ba_obs_cameras_cuda gives at the same estimate. Same
    contract as ba_obs.cost_plain; `order` as for ba_obs_cameras_cuda."""
    args, keep = _obs_args(problem, cam, order, None, cap, huber_delta)
    dev = keep[0].device
    part = torch.empty((args.n_cams, 3), dtype=torch.float64, device=dev)
    costs = torch.empty((2,), dtype=torch.float32, device=dev)
    lib = build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(lib.slam_ba_obs_cost(ctypes.byref(args), part.data_ptr(),
                                   costs.data_ptr(), stream),
              "ba_obs cost launch")
    ba_obs_cameras_cuda.launches += 1
    return costs[0], costs[1]


# ---------------------------------------------------------------------------
# BAL's observation pass
# ---------------------------------------------------------------------------
#
# The same contract as the stereo pass's at BAL's 9-parameter cameras and
# 2 residuals (see csrc/bal_obs.cu), without its outlier cut: cut2 and cap
# must be None, and the truncated cost is the full one. The plain twins
# are `ops/bal_obs.py`'s `cameras_plain`, `landmarks_plain` and
# `cost_plain`.


def _bal_args(problem, order, huber_delta: float, *uncut):
    """(_BalArgs, the tensors it points into) of one launch of
    csrc/bal_obs.cu: the problem's cams, points, uv and w and the kernels'
    orderings of `order`, all float32 or int32 on one card. `uncut`, the
    launch's cut2 and cap, must be None."""
    if any(x is not None for x in uncut):
        raise ValueError("bal_obs: BAL's pass takes no outlier cut")
    cams, points, uv, w = [x.contiguous() for x in (
        problem.cams, problem.points, problem.uv, problem.w)]
    c, n_l, o = cams.shape[0], points.shape[0], uv.shape[0]
    _check(cams, "cams", torch.float32, (c, 9))
    _check(points, "points", torch.float32, (n_l, 3))
    _check(uv, "uv", torch.float32, (o, 2))
    _check(w, "w", torch.float32, (o,))
    _check_aligned(8, uv=uv)
    made_for = _check_order(order, o)
    if made_for != (c, n_l):
        raise ValueError(f"order: made for {made_for} cameras and "
                         f"landmarks, the problem has {(c, n_l)}")
    dev = cams.device
    for t in (points, uv, w, order.cam_rows, order.lm_rows):
        if t.device != dev:
            raise ValueError(f"the problem's tensors are on {t.device} and "
                             f"{dev}")
    if max(c, n_l, 27 * o) >= 1 << 31:
        raise ValueError(f"bal_obs: {(c, n_l, o)} do not fit int32")
    args = _BalArgs(
        cams.data_ptr(), points.data_ptr(), uv.data_ptr(), w.data_ptr(),
        order.cam_rows.data_ptr(), order.cam_lms.data_ptr(),
        order.cam_off.data_ptr(), order.lm_rows.data_ptr(),
        order.lm_cams.data_ptr(), order.lm_off.data_ptr(),
        float(huber_delta) * float(huber_delta), c, n_l, o)
    return args, (cams, points, uv, w)


def bal_obs_cameras_cuda(problem, cam, order, cut2, cap, huber_delta: float):
    """BAL's observation pass by camera in one launch of csrc/bal_obs.cu
    (and the costs' one-block sum). Same contract as
    bal_obs.cameras_plain (`cam` is not read); `order` holds the kernels'
    orderings (schur_order with kernels=True, made with the problem's
    weights)."""
    args, keep = _bal_args(problem, order, huber_delta, cut2, cap)
    dev = keep[0].device
    W = torch.empty((args.n_obs, 9, 3), dtype=torch.float32, device=dev)
    hcc = torch.empty((args.n_cams, 9, 9), dtype=torch.float32, device=dev)
    bc = torch.empty((args.n_cams, 9), dtype=torch.float32, device=dev)
    part = torch.empty((args.n_cams, 2), dtype=torch.float64, device=dev)
    cost = torch.empty((), dtype=torch.float32, device=dev)
    n_kept = torch.empty((), dtype=torch.int32, device=dev)
    lib = build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(lib.slam_bal_obs_cameras(
        ctypes.byref(args), W.data_ptr(), hcc.data_ptr(), bc.data_ptr(),
        part.data_ptr(), cost.data_ptr(), n_kept.data_ptr(), stream),
        "bal_obs cameras launch")
    bal_obs_cameras_cuda.launches += 1
    return ObsTerms(W, hcc, bc, cost, cost, n_kept)


# Launches of the three entries.
bal_obs_cameras_cuda.launches = 0


def bal_obs_landmarks_cuda(problem, cam, order, cut2, huber_delta: float):
    """BAL's observation pass by landmark in one launch of
    csrc/bal_obs.cu. Same contract as bal_obs.landmarks_plain; `order` as
    for bal_obs_cameras_cuda."""
    args, keep = _bal_args(problem, order, huber_delta, cut2)
    dev = keep[0].device
    hll = torch.empty((args.n_lms, 3, 3), dtype=torch.float32, device=dev)
    bl = torch.empty((args.n_lms, 3), dtype=torch.float32, device=dev)
    if args.n_lms == 0:
        return hll, bl
    lib = build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(lib.slam_bal_obs_landmarks(
        ctypes.byref(args), hll.data_ptr(), bl.data_ptr(), stream),
        "bal_obs landmarks launch")
    bal_obs_cameras_cuda.launches += 1
    return hll, bl


def bal_obs_cost_cuda(problem, cam, order, cap, huber_delta: float):
    """The cost in one launch of csrc/bal_obs.cu (and its one-block sum),
    the bits bal_obs_cameras_cuda gives at the same estimate, as (full,
    truncated), the same tensor. Same contract as bal_obs.cost_plain;
    `order` as for bal_obs_cameras_cuda."""
    args, keep = _bal_args(problem, order, huber_delta, cap)
    dev = keep[0].device
    part = torch.empty((args.n_cams, 2), dtype=torch.float64, device=dev)
    cost = torch.empty((), dtype=torch.float32, device=dev)
    lib = build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    _raise_on(lib.slam_bal_obs_cost(ctypes.byref(args), part.data_ptr(),
                                    cost.data_ptr(), stream),
              "bal_obs cost launch")
    bal_obs_cameras_cuda.launches += 1
    return cost, cost


# ---------------------------------------------------------------------------
# Bundle adjustment's PCG vector update
# ---------------------------------------------------------------------------
#
# One iteration of `ops/cg.cg` after its product Ap = S p, with the
# block-Jacobi preconditioner z = Minv r (Minv (C,D,D), D 6 or 9), and its
# start after r = b - S x0 (see csrc/ba_cg.cu). The plain twins are that
# iteration's torch operations in their order, and the preconditioner's
# einsum, so that a loop over them gives `cg`'s bits.


def ba_cg_start_plain(r, minv):
    """Plain twin of ba_cg_start_cuda: z = Minv r -> (p = z (C,D),
    rz = r.z ())."""
    z = torch.einsum("cij,cj->ci", minv, r)
    return z, torch.sum(r * z)


def ba_cg_step_plain(p, ap, x, r, minv, rz):
    """Plain twin of ba_cg_step_cuda: `ops/cg.cg`'s iteration from its
    product ap = S p -> (x, r, p, rz) one iteration on; the step length
    guarded where |p.Ap| < CG_EPS and both lengths frozen to 0 once
    rz <= CG_EPS."""
    eps = CG_EPS
    denom = torch.sum(p * ap)
    alpha = rz / torch.where(torch.abs(denom) < eps,
                             torch.full_like(denom, eps), denom)
    alive = rz > eps
    zero = torch.zeros_like(rz)
    alpha = torch.where(alive, alpha, zero)
    x = x + alpha * p
    r = r - alpha * ap
    z = torch.einsum("cij,cj->ci", minv, r)
    rz_new = torch.sum(r * z)
    beta = rz_new / torch.where(torch.abs(rz) < eps,
                                torch.full_like(rz, eps), rz)
    beta = torch.where(alive, beta, zero)
    return x, r, z + beta * p, rz_new


def ba_cg_launch(c: int, max_cluster: int):
    """(blocks, threads) of csrc/ba_cg.cu's launch over C camera rows:
    one cluster of as many 128-thread blocks as C asks for, up to
    `max_cluster` (the card's, `build().cg_max_cluster`); the threads then
    widened in steps of a warp, up to BA_CG_MAX_THREADS, until each holds
    at most one camera where that is possible."""
    blocks = max(1, min(max_cluster, -(-c // 128)))
    per_block = -(-c // blocks)
    return blocks, min(BA_CG_MAX_THREADS, -(-per_block // 32) * 32)


def _cg_launch(what, r, minv, step=None):
    """One launch of csrc/ba_cg.cu over r (C,D) and minv (C,D,D), D 6 or
    9: the start (step None) or a step from step = (p, ap, x, rz) -> (x,
    r, p, rz) as it writes them (x and r None for the start)."""
    c, d = r.shape[0], r.shape[-1]
    if r.dim() != 2 or d not in WIDTHS:
        raise ValueError(f"{what}: r: expected (C,D) with D in {WIDTHS}, "
                         f"got {tuple(r.shape)}")
    _check(r, "r", torch.float32, (c, d))
    _check(minv, "minv", torch.float32, (c, d, d))
    _check_rows(d, r=r)
    _check_rows(d, 16, minv=minv)
    if c < 1 or c >= 1 << 31:
        raise ValueError(f"{what}: unsupported C={c}")
    p, ap, x, rz = step if step is not None else (None,) * 4
    x_out = r_out = None
    if step is not None:
        for name, t in (("p", p), ("ap", ap), ("x", x)):
            _check(t, name, torch.float32, (c, d))
            _check_rows(d, **{name: t})
        _check(rz, "rz", torch.float32, ())
        x_out, r_out = torch.empty_like(x), torch.empty_like(r)
    for t in (minv, *(step or ())):
        if t.device != r.device:
            raise ValueError(f"{what}: operands on {t.device} and "
                             f"{r.device}")
    p_out = torch.empty_like(r)
    rz_out = torch.empty((), dtype=torch.float32, device=r.device)
    lib = build()
    blocks, threads = ba_cg_launch(c, lib.cg_max_cluster[d])
    stream = torch.cuda.current_stream(r.device).cuda_stream
    _raise_on(lib.slam_ba_cg_update(
        _ptr(p), _ptr(ap), _ptr(x), r.data_ptr(), minv.data_ptr(), _ptr(rz),
        c, d, CG_EPS, blocks, threads, _ptr(x_out), _ptr(r_out),
        p_out.data_ptr(), rz_out.data_ptr(), stream), f"{what} launch")
    ba_cg_step_cuda.launches += 1
    return x_out, r_out, p_out, rz_out


def ba_cg_start_cuda(r, minv):
    """The CG start (z = Minv r, p = z, rz = r.z) in one launch of
    csrc/ba_cg.cu. Same contract as ba_cg_start_plain."""
    return _cg_launch("ba_cg start", r, minv)[2:]


def ba_cg_step_cuda(p, ap, x, r, minv, rz):
    """One CG iteration's vector update in one launch of csrc/ba_cg.cu.
    Same contract as ba_cg_step_plain; the two dot products sum in
    float64 in the kernel's fixed order, rounded once."""
    return _cg_launch("ba_cg step", r, minv, (p, ap, x, rz))


# Launches of the start and the step.
ba_cg_step_cuda.launches = 0


_COUNTED = {"fast_score": fast_score_cuda, "hamming_top2": hamming_top2_cuda,
            "hamming_top2_batched": hamming_top2_batched_cuda,
            "chain_prepare": chain_prepare_cuda,
            "chain_sweep": chain_sweep_cuda,
            "ba_schur": ba_schur_landmarks_cuda,
            "ba_obs": ba_obs_cameras_cuda,
            "ba_cg": ba_cg_step_cuda,
            "bal_obs": bal_obs_cameras_cuda}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in _COUNTED.items()}


def reset_launch_counts():
    for fn in _COUNTED.values():
        fn.launches = 0
