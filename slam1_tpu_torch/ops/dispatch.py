"""Kernel dispatch (counterpart of `slam1_tpu/ops/dispatch.py`).

The device of the input tensor is the only switch: a CUDA tensor
launches the hand-written kernel (or raises), a CPU tensor takes the
plain PyTorch twin. There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from slam1_tpu_torch.ops import ba_obs, bal_obs, cuda_kernels, fast


def use_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor, False for a CPU tensor; raises otherwise."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain path for device {t.device}")


def fast_score(img, threshold: float, arc: int = 9):
    """FAST-9 score map of (..., H, W) float32 images."""
    if use_cuda(img):
        return cuda_kernels.fast_score_cuda(img.contiguous(), threshold, arc)
    return fast.fast_score(img, threshold, arc)


def fast_score_levels(imgs, threshold: float, arc: int = 9):
    """FAST-9 score maps of a list of (B,H,W) float32 images (the levels
    of a pyramid): one kernel launch for CUDA tensors, the plain twin
    image by image on the CPU."""
    imgs = list(imgs)
    if use_cuda(imgs[0]):
        return cuda_kernels.fast_score_levels_cuda(
            [im.contiguous() for im in imgs], threshold, arc)
    return [fast.fast_score(im, threshold, arc) for im in imgs]


def hamming_top2(desc_a, desc_b, mask_a, mask_b, *, uv_a=None, uv_b=None,
                 dy_tol=None, dx_lo=0.0, dx_hi=0.0):
    """Hamming top-2 over packed descriptors -> (d1, d2, idx, col_best)."""
    fn = (cuda_kernels.hamming_top2_cuda if use_cuda(desc_a)
          else cuda_kernels.hamming_top2_plain)
    if uv_a is not None:
        uv_a, uv_b = uv_a.contiguous(), uv_b.contiguous()
    return fn(desc_a.contiguous(), desc_b.contiguous(), mask_a.contiguous(),
              mask_b.contiguous(), uv_a=uv_a, uv_b=uv_b, dy_tol=dy_tol,
              dx_lo=dx_lo, dx_hi=dx_hi)


def hamming_top2_batched(desc_a, desc_b, mask_a, mask_b):
    """B ungated Hamming top-2 problems -> (d1, d2, idx, col_best)."""
    fn = (cuda_kernels.hamming_top2_batched_cuda if use_cuda(desc_a)
          else cuda_kernels.hamming_top2_batched_plain)
    return fn(desc_a.contiguous(), desc_b.contiguous(), mask_a.contiguous(),
              mask_b.contiguous())


def chain_prepare(jj_inv, ji, n_live):
    """What chain_sweep can reuse for as long as jj_inv and ji hold (one
    Gauss-Newton iteration): the kernel's fused 6x6 blocks on CUDA
    tensors, nothing (None) on the CPU, where the plain twin needs none.
    `n_live`: an int, or a 0-d int32 tensor on the operands' device (what
    a captured graph takes: the kernels read it on the device)."""
    if use_cuda(jj_inv):
        return cuda_kernels.chain_prepare_cuda(jj_inv.contiguous(),
                                               ji.contiguous(), n_live)
    return None


def chain_sweep(jj_inv, ji, winv, v, n_live, prep=None):
    """The square-root chain preconditioner's two sweeps -> x (F,6).
    `prep` is chain_prepare's value for the same jj_inv, ji, n_live."""
    args = (jj_inv.contiguous(), ji.contiguous(), winv.contiguous(),
            v.contiguous(), n_live)
    if use_cuda(v):
        return cuda_kernels.chain_sweep_cuda(*args, prep=prep)
    return cuda_kernels.chain_sweep_plain(*args)


def schur_order(cam_idx, lm_idx, n_cams: int, n_lms: int, w=None):
    """The ordering of BA's observations that the CG path's kernels take
    (`cuda_kernels.SchurOrder`): with the kernels' sorted rows and
    offsets for CUDA tensors (without the observations whose weight in
    w is zero), the indices alone on the CPU."""
    return cuda_kernels.schur_order(cam_idx, lm_idx, n_cams, n_lms,
                                    kernels=use_cuda(cam_idx), w=w)


def ba_obs_cameras(problem, cam, order, cut2, cap, huber_delta: float):
    """BA's observation pass by camera at the problem's poses and points
    -> ba_obs.ObsTerms (W, Hcc, bc, the full and the truncated cost, the
    rows kept): the step's weights cut at the 0-d `cut2` (None: no cut),
    the truncated cost capped at the 0-d `cap` (None: the full cost)."""
    if use_cuda(problem.uv):
        return cuda_kernels.ba_obs_cameras_cuda(problem, cam, order, cut2,
                                                cap, huber_delta)
    return ba_obs.cameras_plain(problem, cam, order, cut2, cap, huber_delta)


def ba_obs_landmarks(problem, cam, order, cut2, huber_delta: float):
    """BA's observation pass by landmark -> (Hll (L,3,3), bl (L,3))."""
    if use_cuda(problem.uv):
        return cuda_kernels.ba_obs_landmarks_cuda(problem, cam, order, cut2,
                                                  huber_delta)
    return ba_obs.landmarks_plain(problem, cam, order, cut2, huber_delta)


def ba_obs_cost(problem, cam, order, cap, huber_delta: float):
    """BA's full and truncated costs at the problem's poses and points,
    as ba_obs_cameras gives them -> (full (), truncated ())."""
    if use_cuda(problem.uv):
        return cuda_kernels.ba_obs_cost_cuda(problem, cam, order, cap,
                                             huber_delta)
    return ba_obs.cost_plain(problem, cam, order, cap, huber_delta)


def bal_obs_cameras(problem, cam, order, cut2, cap, huber_delta: float):
    """BAL's observation pass by camera at the problem's cameras and points
    -> ba_obs.ObsTerms (W (O,9,3), Hcc (C,9,9), bc (C,9), the costs, the
    rows kept), as ba_obs_cameras; `cam` is not read (BAL's intrinsics are
    its cameras')."""
    if use_cuda(problem.uv):
        return cuda_kernels.bal_obs_cameras_cuda(problem, cam, order, cut2,
                                                 cap, huber_delta)
    return bal_obs.cameras_plain(problem, cam, order, cut2, cap, huber_delta)


def bal_obs_landmarks(problem, cam, order, cut2, huber_delta: float):
    """BAL's observation pass by landmark -> (Hll (L,3,3), bl (L,3))."""
    if use_cuda(problem.uv):
        return cuda_kernels.bal_obs_landmarks_cuda(problem, cam, order, cut2,
                                                   huber_delta)
    return bal_obs.landmarks_plain(problem, cam, order, cut2, huber_delta)


def bal_obs_cost(problem, cam, order, cap, huber_delta: float):
    """BAL's full and truncated costs -> (full (), truncated ())."""
    if use_cuda(problem.uv):
        return cuda_kernels.bal_obs_cost_cuda(problem, cam, order, cap,
                                              huber_delta)
    return bal_obs.cost_plain(problem, cam, order, cap, huber_delta)


def _contiguous(t):
    return None if t is None else t.contiguous()


def ba_schur_landmarks(W, hll_inv, order, x=None, a=None):
    """The landmark half of BA's reduced-system product -> v (L,3) =
    Hll_inv (a - s), Hll_inv s or Hll_inv a, s the sums of W^T x by
    landmark."""
    fn = (cuda_kernels.ba_schur_landmarks_cuda if use_cuda(W)
          else cuda_kernels.ba_schur_landmarks_plain)
    return fn(W.contiguous(), hll_inv.contiguous(), order, x=_contiguous(x),
              a=_contiguous(a))


def ba_schur_cameras(W, v, order, hcc=None, x=None, b=None):
    """The camera half of BA's reduced-system product -> (C,D): Hcc x -
    y, or b - y, y the sums of W v by camera; at D = 6 (the stereo rig)
    row 0, the gauge, is x_0, or zero."""
    fn = (cuda_kernels.ba_schur_cameras_cuda if use_cuda(W)
          else cuda_kernels.ba_schur_cameras_plain)
    return fn(W.contiguous(), v.contiguous(), order, hcc=_contiguous(hcc),
              x=_contiguous(x), b=_contiguous(b))


def ba_cg_start(r, minv):
    """The start of BA's block-Jacobi PCG after r = b - S x0 -> (p = Minv
    r (C,D), rz = r.z ())."""
    fn = (cuda_kernels.ba_cg_start_cuda if use_cuda(r)
          else cuda_kernels.ba_cg_start_plain)
    return fn(r.contiguous(), minv.contiguous())


def ba_cg_step(p, ap, x, r, minv, rz):
    """One iteration of BA's block-Jacobi PCG from its product ap = S p ->
    (x, r, p, rz) one iteration on: `ops/cg.cg`'s iteration, in one
    launch for CUDA tensors."""
    fn = (cuda_kernels.ba_cg_step_cuda if use_cuda(r)
          else cuda_kernels.ba_cg_step_plain)
    return fn(p.contiguous(), ap.contiguous(), x.contiguous(),
              r.contiguous(), minv.contiguous(), rz)
