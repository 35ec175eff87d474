"""The least time one H100 could take for the work of BAL's bundle
adjustment on the CG path (`ba.bundle_adjust` with the camera model
`ba.BAL`): a frozen copy of the formulas `slam1_tpu_torch/utils/bounds.py`
keeps beside the kernels (`bal_*_work`), on `bounds.py`'s published peaks.
Each formula counts the function's own inputs read once and outputs
written once, whatever a kernel's design reads besides.
"""

from __future__ import annotations

from benchmark.yardstick.bounds import PEAK_F32_FLOPS, bound

D = 9                      # a BAL camera's parameters


def schur_work(o, c, l, half: str, x: bool = True, a: bool = False):
    """(bytes, float32 operations) of one launch of a half of the reduced
    system's product at D = 9 (`csrc/ba_schur.cu`) over O observations, C
    cameras and L landmarks:
      - "landmarks": with x, W (108 bytes) and the ordering's row and
        camera (8 bytes) an observation, the offsets, x (C,9) and Hll^-1
        (L,3,3) read, v (L,3) written, 27 multiply-adds an observation
        and 9 a landmark; without x (a alone) Hll^-1 and a read, v
        written; a (L,3) read where given;
      - "cameras": W and the ordering (116 bytes) an observation, the
        offsets, v (L,3) read once, Hcc (C,9,9) and x or b (C,9) read,
        the result (C,9) written, 27 multiply-adds an observation and 81 a
        camera."""
    if half == "landmarks":
        n = l * (36 + 12) + (l * 12 if a else 0)
        ops = 18 * l
        if x:
            n += o * (108 + 8) + (l + 1) * 4 + c * 36
            ops += 54 * o
        return n, ops
    if half == "cameras":
        return (o * (108 + 8) + (c + 1) * 4 + l * 12 + c * (324 + 36 + 36),
                54 * o + 162 * c)
    raise ValueError(f"schur_work: no half {half!r}")


def obs_work(o, c, l, launch: str):
    """(bytes, float32 operations) of one launch of BAL's observation pass
    (`csrc/bal_obs.cu`): every launch reads the cameras (C,9), the points,
    each observation's uv and w (12 bytes) and its ordering's row and
    other index (8 bytes), and works out the projection, the residual,
    its square, the Huber weight and the cut (60 operations: the point
    into the camera 18, the projection and distortion 20, r and r2 6, the
    weight and the cut 8, the costs 8). Besides:
      - "cameras": the Jacobians (A 12, Jl 30, Jc's rotation block 63 and
        the rest 10), W (81), Hcc's upper triangle (135) and bc (27) an
        observation; W (108 bytes) an observation, Hcc (324 bytes) and bc
        (36) a camera written;
      - "landmarks": A, Jl, Hll's upper triangle (18) and bl (9); Hll
        (36 bytes) and bl (12) a landmark written;
      - "cost": two floats written."""
    reads = c * 36 + l * 12 + o * (12 + 8)
    if launch == "cameras":
        return (reads + (c + 1) * 4 + o * 108 + c * (324 + 36),
                o * (60 + 12 + 30 + 63 + 10 + 81 + 135 + 27))
    if launch == "landmarks":
        return (reads + (l + 1) * 4 + l * (36 + 12),
                o * (60 + 12 + 30 + 18 + 9))
    if launch == "cost":
        return reads + (c + 1) * 4 + 8, o * 60
    raise ValueError(f"obs_work: no launch {launch!r}")


def cg_work(c, start: bool = False):
    """(bytes, float32 operations) of one launch of the PCG's vector
    update at D = 9 (`csrc/ba_cg.cu`): a step reads p, Ap, x, r (C,9),
    Minv (C,9,9) and rz and writes x, r, p (C,9) and rz; the start reads
    r and Minv and writes p and rz."""
    if start:
        return c * (36 + 324 + 36) + 4, (162 + 18) * c
    return (c * (4 * 36 + 324 + 3 * 36) + 8,
            (18 + 36 + 162 + 18 + 18) * c)


def lm_iteration_work(o, c, l, cg_iters):
    """(bytes, float32 operations) of one LM iteration (a `bal_lm`
    replay) as the sum of its launches' work: the observation pass's
    cameras, landmarks and cost launches; the right side (the landmark
    half on a alone, the camera half on b); the product from x = 0 and
    cg_iters products (both halves); the back-substitution (the landmark
    half on x and a); the PCG's start and cg_iters steps."""
    def add(*works):
        return (sum(w[0] for w in works), sum(w[1] for w in works))
    product = add(schur_work(o, c, l, "landmarks"),
                  schur_work(o, c, l, "cameras"))
    parts = [obs_work(o, c, l, k) for k in ("cameras", "landmarks", "cost")]
    parts += [schur_work(o, c, l, "landmarks", x=False, a=True),
              schur_work(o, c, l, "cameras"),
              schur_work(o, c, l, "landmarks", x=True, a=True),
              cg_work(c, start=True)]
    parts += [product] * (cg_iters + 1) + [cg_work(c)] * cg_iters
    return add(*parts)


def bound_lm_iteration(o, c, l, cg_iters):
    return bound(*lm_iteration_work(o, c, l, cg_iters), PEAK_F32_FLOPS)


def bound_schur(o, c, l, half, x=True, a=False):
    return bound(*schur_work(o, c, l, half, x, a), PEAK_F32_FLOPS)


def bound_obs(o, c, l, launch):
    return bound(*obs_work(o, c, l, launch), PEAK_F32_FLOPS)
