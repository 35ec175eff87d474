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
           "ba_schur.cu")
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


class _Kernels:
    """The C entry points of the four libraries, argtypes declared."""

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
        self.slam_ba_schur_landmarks.argtypes = [p, p, p, p, p, p, p, i, p, p]
        self.slam_ba_schur_cameras = schur.slam_ba_schur_cameras
        self.slam_ba_schur_cameras.argtypes = [p, p, p, p, p, p, p, p, i, p,
                                               p]
        for fn in (self.slam_fast_score, self.slam_fast_score_levels,
                   self.slam_hamming_top2,
                   self.slam_hamming_top2_batched, self.slam_chain_prepare,
                   self.slam_chain_sweep, self.slam_ba_schur_landmarks,
                   self.slam_ba_schur_cameras):
            fn.restype = i
        if chain.slam_chain_levels() != CHAIN_LEVELS:
            raise RuntimeError("csrc/chain_sweep.cu and CHAIN_LEVELS disagree")
        # Most rows (F) whose offsets one chain_sweep launch holds in
        # shared memory; a larger F keeps them in a device scratch buffer.
        self.chain_max_live = chain.slam_chain_sweep_max_live()


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
# half out = h - sum_o W_o v_{l_o} (see csrc/ba_schur.cu). The plain
# twins are the einsums and float64 segment sums `models/ba.py` wrote
# before the kernels, operation for operation.


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
                kernels: bool, W=None) -> SchurOrder:
    """The SchurOrder of observations (cam_idx, lm_idx) over n_cams
    cameras and n_lms landmarks; the kernels' orderings only where
    `kernels` (made once per reduced system, read by every product).

    Given the blocks W (O,6,3), the kernels' orderings leave out every
    observation whose block is all zero (a bucket's padding, an
    observation the outlier cut or its weight removed): it adds a zero
    to each sum, and a problem's padding all points at one landmark,
    whose thread in the landmark half would walk every padded row."""
    ci, li = cam_idx.long(), lm_idx.long()
    if not kernels:
        return SchurOrder(ci, li)
    if ci.shape[0] >= 1 << 31:
        raise ValueError(f"schur_order: {ci.shape[0]} observations do not "
                         f"fit int32 rows")
    lm_key, cam_key = li, ci
    if W is not None:
        zero = ~(W != 0).flatten(1).any(1)
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
    """Plain twin of ba_schur_cameras_cuda: out (C,6) = Hcc_d x - y
    (hcc and x given: the product; row 0, the gauge, x_0) or b - y (b
    given: the right side; row 0 zero), y = seg_sum_c(W v[l])."""
    y = torch.einsum("oij,oj->oi", W, v[order.lm_idx])             # (O,6)
    if hcc is not None:
        out = torch.einsum("cij,cj->ci", hcc, x) - seg_sum(
            hcc.shape[0], order.cam_idx, y)
        out[0] = x[0]
    else:
        out = b - seg_sum(b.shape[0], order.cam_idx, y)
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


def ba_schur_landmarks_cuda(W, hll_inv, order, x=None, a=None):
    """The landmark half in one launch of csrc/ba_schur.cu. Same
    contract as ba_schur_landmarks_plain; `order` holds the kernels'
    orderings (schur_order with kernels=True)."""
    o = W.shape[0]
    _check(W, "W", torch.float32, (o, 6, 3))
    n_cams, n_lms = _check_order(order, o)
    _check(hll_inv, "hll_inv", torch.float32, (n_lms, 3, 3))
    if x is None and a is None:
        raise ValueError("ba_schur_landmarks_cuda: give x, a or both")
    if x is not None:
        _check(x, "x", torch.float32, (n_cams, 6))
        _check_aligned(8, x=x)
    if a is not None:
        _check(a, "a", torch.float32, (n_lms, 3))
    _check_aligned(8, W=W)
    v = torch.empty((n_lms, 3), dtype=torch.float32, device=W.device)
    if n_lms == 0:
        return v
    lib = build()
    stream = torch.cuda.current_stream(W.device).cuda_stream
    _raise_on(lib.slam_ba_schur_landmarks(
        W.data_ptr(), order.lm_rows.data_ptr(), order.lm_cams.data_ptr(),
        order.lm_off.data_ptr(), _ptr(x), _ptr(a), hll_inv.data_ptr(), n_lms,
        v.data_ptr(), stream), "ba_schur landmarks launch")
    ba_schur_landmarks_cuda.launches += 1
    return v


# Launches of both halves.
ba_schur_landmarks_cuda.launches = 0


def ba_schur_cameras_cuda(W, v, order, hcc=None, x=None, b=None):
    """The camera half in one launch of csrc/ba_schur.cu. Same contract
    as ba_schur_cameras_plain; `order` as for ba_schur_landmarks_cuda."""
    o = W.shape[0]
    _check(W, "W", torch.float32, (o, 6, 3))
    n_cams, n_lms = _check_order(order, o)
    _check(v, "v", torch.float32, (n_lms, 3))
    if (hcc is None) != (x is None) or (hcc is None) == (b is None):
        raise ValueError("ba_schur_cameras_cuda: give hcc and x, or b")
    if hcc is not None:
        _check(hcc, "hcc", torch.float32, (n_cams, 6, 6))
        _check(x, "x", torch.float32, (n_cams, 6))
    else:
        _check(b, "b", torch.float32, (n_cams, 6))
    _check_aligned(8, W=W)
    out = torch.empty((n_cams, 6), dtype=torch.float32, device=W.device)
    if n_cams == 0:
        return out
    lib = build()
    stream = torch.cuda.current_stream(W.device).cuda_stream
    _raise_on(lib.slam_ba_schur_cameras(
        W.data_ptr(), order.cam_rows.data_ptr(), order.cam_lms.data_ptr(),
        order.cam_off.data_ptr(), v.data_ptr(), _ptr(hcc), _ptr(x), _ptr(b),
        n_cams, out.data_ptr(), stream), "ba_schur cameras launch")
    ba_schur_landmarks_cuda.launches += 1
    return out


_COUNTED = {"fast_score": fast_score_cuda, "hamming_top2": hamming_top2_cuda,
            "hamming_top2_batched": hamming_top2_batched_cuda,
            "chain_prepare": chain_prepare_cuda,
            "chain_sweep": chain_sweep_cuda,
            "ba_schur": ba_schur_landmarks_cuda}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in _COUNTED.items()}


def reset_launch_counts():
    for fn in _COUNTED.values():
        fn.launches = 0
