"""Kernel dispatch (counterpart of `slam1_tpu/ops/dispatch.py`).

The device of the input tensor is the only switch: a CUDA tensor
launches the hand-written kernel (or raises), a CPU tensor takes the
plain PyTorch twin. There is no fallback from one to the other.
"""

from __future__ import annotations

import torch

from slam1_tpu_torch.ops import cuda_kernels, fast


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


def schur_order(cam_idx, lm_idx, n_cams: int, n_lms: int, W=None):
    """The ordering of BA's observations that the reduced-system product
    takes (`cuda_kernels.SchurOrder`): with the kernels' sorted rows and
    offsets for CUDA tensors (without the observations whose block in W
    is all zero), the indices alone on the CPU."""
    return cuda_kernels.schur_order(cam_idx, lm_idx, n_cams, n_lms,
                                    kernels=use_cuda(cam_idx), W=W)


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
    """The camera half of BA's reduced-system product -> (C,6): Hcc x -
    y with row 0 x_0, or b - y with row 0 zero, y the sums of W v by
    camera."""
    fn = (cuda_kernels.ba_schur_cameras_cuda if use_cuda(W)
          else cuda_kernels.ba_schur_cameras_plain)
    return fn(W.contiguous(), v.contiguous(), order, hcc=_contiguous(hcc),
              x=_contiguous(x), b=_contiguous(b))
