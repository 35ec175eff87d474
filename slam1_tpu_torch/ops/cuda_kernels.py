"""The hand-written Hopper kernels, their build, and their plain twins.

CUDA C++ kernels for sm_90a live in `slam1_tpu_torch/csrc/`:

  - `fast_score.cu`   — FAST-9 score map; replaces the TPU kernel
    `slam1_tpu/ops/pallas_kernels.py:fast_score`.
  - `hamming_top2.cu` — fused Hamming top-2 + column argmin with an
    optional geometric gate; replaces
    `slam1_tpu/ops/pallas_kernels.py:hamming_top2`. Its batched entry
    runs a whole loop-verification slate (the vmapped Pallas call of
    `verify_loop_slate`) in one launch.
  - `chain_sweep.cu`  — the two sequential sweeps of the pose graph's
    square-root chain preconditioner (an XLA scan in the reference,
    `slam1_tpu/models/posegraph.py:_chain_sqrt_solve`).

They are compiled with nvcc into one shared library with a plain C
interface at first use (from the repo's sources only, into
`slam1_tpu_torch/build/`, keyed by a hash of the sources) and called
through ctypes on PyTorch's current stream. Each launch returns
`cudaGetLastError()`; the wrapper raises when it is not 0. Wrappers
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

import torch

from slam1_tpu_torch.ops.brief import unpack_bits

BIG = 1 << 20
_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")
SOURCES = ("fast_score.cu", "hamming_top2.cu", "chain_sweep.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")

_lib = None
build_seconds = None  # wall time of the nvcc build in this process


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


def library_path() -> str:
    h = hashlib.sha256()
    for name in SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"libslam1_kernels_{h.hexdigest()[:16]}.so")


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (if needed) and load the kernel library."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    path = library_path()
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
               *[os.path.join(CSRC, s) for s in SOURCES]]
        if verbose:
            cmd.insert(1, "-Xptxas=-v")
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        build_seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        if verbose:
            print(proc.stdout + proc.stderr)
        os.replace(tmp, path)
    lib = ctypes.CDLL(path)
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.slam_fast_score.argtypes = [p, p, i, i, i, f, i, p]
    lib.slam_fast_score.restype = i
    lib.slam_hamming_top2.argtypes = [p, p, p, p, p, p, i, i, i, f, f, f,
                                      i, p, p, p, p, p, p, p]
    lib.slam_hamming_top2.restype = i
    lib.slam_hamming_top2_batched.argtypes = [p, p, p, p, i, i, i, i, p, p,
                                              p, p, p, p, p]
    lib.slam_hamming_top2_batched.restype = i
    lib.slam_chain_sweep.argtypes = [p, p, p, p, i, i, p, p]
    lib.slam_chain_sweep.restype = i
    _lib = lib
    return lib


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

def fast_score_cuda(img: torch.Tensor, threshold: float,
                    arc: int = 9) -> torch.Tensor:
    """FAST score of a (B,H,W) or (H,W) float32 CUDA tensor via the
    kernel in csrc/fast_score.cu. Same contract as ops.fast.fast_score."""
    squeeze = img.dim() == 2
    x = img[None] if squeeze else img
    _check(x, "img", torch.float32)
    if x.dim() != 3:
        raise ValueError(f"img: expected (B,H,W) or (H,W), got {img.shape}")
    if not 1 <= arc <= 16:
        raise ValueError(f"arc must be in [1, 16], got {arc}")
    b, h, w = x.shape
    out = torch.empty_like(x)
    lib = build()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    _raise_on(lib.slam_fast_score(x.data_ptr(), out.data_ptr(), b, h, w,
                                  float(threshold), int(arc), stream),
              "fast_score launch")
    fast_score_cuda.launches += 1
    return out[0] if squeeze else out


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
    if m < 2 or n < 1 or n >= (1 << 23):
        raise ValueError(f"hamming_top2_cuda: unsupported N={n}, M={m}")
    for t, name in ((desc_a, "desc_a"), (desc_b, "desc_b")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: expected 16-byte alignment")
    gated = uv_a is not None
    if gated:
        _check(uv_a, "uv_a", torch.float32, (n, 2))
        _check(uv_b, "uv_b", torch.float32, (m, 2))
    dev = desc_a.device
    splits = _splits(n, m, 1)
    part = torch.empty((3 * splits * n,), dtype=torch.int32, device=dev)
    colkey = torch.empty((m,), dtype=torch.int32, device=dev)
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
        splits, part.data_ptr(), colkey.data_ptr(), d1.data_ptr(),
        d2.data_ptr(), idx.data_ptr(), col_best.data_ptr(), stream)
    _raise_on(err, "hamming_top2 launch")
    hamming_top2_cuda.launches += 1
    return d1, d2, idx, col_best


hamming_top2_cuda.launches = 0


def _splits(n, m, problems):
    """Column splits so that ~1.3 blocks per SM are in flight."""
    tiles = -(-m // 128)
    row_blocks = -(-n // 128) * problems
    return max(1, min(tiles, -(-170 // row_blocks)))


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
    if m < 2 or n < 1 or n >= (1 << 23) or b < 1 or b > 65535:
        raise ValueError(f"hamming_top2_batched_cuda: unsupported B={b}, "
                         f"N={n}, M={m}")
    for t, name in ((desc_a, "desc_a"), (desc_b, "desc_b")):
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: expected 16-byte alignment")
    dev = desc_a.device
    splits = _splits(n, m, b)
    part = torch.empty((b * 3 * splits * n,), dtype=torch.int32, device=dev)
    colkey = torch.empty((b * m,), dtype=torch.int32, device=dev)
    d1 = torch.empty((b, n), dtype=torch.int32, device=dev)
    d2 = torch.empty_like(d1)
    idx = torch.empty_like(d1)
    col_best = torch.empty((b, m), dtype=torch.int32, device=dev)
    lib = build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = lib.slam_hamming_top2_batched(
        desc_a.data_ptr(), desc_b.data_ptr(), mask_a.data_ptr(),
        mask_b.data_ptr(), b, n, m, splits, part.data_ptr(),
        colkey.data_ptr(), d1.data_ptr(), d2.data_ptr(), idx.data_ptr(),
        col_best.data_ptr(), stream)
    _raise_on(err, "hamming_top2_batched launch")
    hamming_top2_batched_cuda.launches += 1
    return d1, d2, idx, col_best


hamming_top2_batched_cuda.launches = 0


# ---------------------------------------------------------------------------
# Pose-graph chain sweeps
# ---------------------------------------------------------------------------

def chain_sweep_plain(jj_inv, ji, winv, v, n_live: int):
    """Plain twin of chain_sweep_cuda: the two sweeps of the square-root
    chain preconditioner as a loop over rows (see csrc/chain_sweep.cu).
    jj_inv, ji (F,6,6); winv (F,); v (F,6) -> x (F,6), x_0 = 0; rows
    from n_live on are decoupled (x_i = winv_i v_i)."""
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


def chain_sweep_cuda(jj_inv, ji, winv, v, n_live: int):
    """The two chain sweeps in one launch of csrc/chain_sweep.cu. Same
    contract as chain_sweep_plain."""
    f = v.shape[0]
    _check(jj_inv, "jj_inv", torch.float32, (f, 6, 6))
    _check(ji, "ji", torch.float32, (f, 6, 6))
    _check(winv, "winv", torch.float32, (f,))
    _check(v, "v", torch.float32, (f, 6))
    if not 1 <= n_live <= f:
        raise ValueError(f"chain_sweep_cuda: n_live={n_live} not in [1, {f}]")
    x = torch.empty_like(v)
    lib = build()
    stream = torch.cuda.current_stream(v.device).cuda_stream
    _raise_on(lib.slam_chain_sweep(jj_inv.data_ptr(), ji.data_ptr(),
                                   winv.data_ptr(), v.data_ptr(), f,
                                   int(n_live), x.data_ptr(), stream),
              "chain_sweep launch")
    chain_sweep_cuda.launches += 1
    return x


chain_sweep_cuda.launches = 0

_COUNTED = {"fast_score": fast_score_cuda, "hamming_top2": hamming_top2_cuda,
            "hamming_top2_batched": hamming_top2_batched_cuda,
            "chain_sweep": chain_sweep_cuda}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in _COUNTED.items()}


def reset_launch_counts():
    for fn in _COUNTED.values():
        fn.launches = 0
