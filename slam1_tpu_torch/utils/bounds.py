"""The least time one H100 could take for a function's work: the larger
of the bytes it must move (each input read once, each output written
once) over the memory rate, and the operations it must do over the peak
rate for their type. Shared by `chip_smoke.py` and
`tools/port_roofline.py`.

Every formula counts the function's own inputs and outputs, whatever a
kernel's design reads or computes besides.
"""

from __future__ import annotations

# Published peaks of one H100 SXM (NVIDIA's data sheet, dense), at its
# full 700 W: device memory, int8 tensor-core operations (the 1-bit MMA
# is held to the int8 rate), float32 outside the tensor cores.
PEAK_BYTES_S = 3.35e12
PEAK_INT8_OPS = 1979e12
PEAK_F32_FLOPS = 67e12


def bound(n_bytes, ops, peak_ops):
    """(bound in ms, "bytes" or "operations"): the least time the card
    could take to move n_bytes once or to do `ops` at `peak_ops`."""
    t_bytes, t_ops = n_bytes / PEAK_BYTES_S, ops / peak_ops
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def fast_score_work(shapes):
    """(bytes, float32 operations) of the FAST score over images of
    `shapes` (B,H,W): each image read and its score written once (8
    bytes a pixel); per pixel 16 differences, 32 threshold excesses
    (diff - t and -diff - t), 32 clamps at 0, 32 additions into the two
    sums and one maximum (113); the arc test works on predicates and is
    not counted."""
    px = sum(b * h * w for b, h, w in shapes)
    return 8 * px, 113 * px


def bound_fast_score(shapes):
    return bound(*fast_score_work(shapes), PEAK_F32_FLOPS)


def hamming_work(problems, n, m, gated):
    """(bytes, one-bit operations) of `problems` N x M Hamming top-2
    problems: 2 N M 256 one-bit multiply-adds each; descriptors (32 B),
    masks (1 B) and gate coordinates (8 B) read once, three int32 per row
    and one per column written."""
    per_item = 32 + 1 + (8 if gated else 0)
    n_bytes = problems * ((n + m) * per_item + 4 * (3 * n + m))
    return n_bytes, problems * 2 * n * m * 256


def bound_hamming(problems, n, m, gated):
    return bound(*hamming_work(problems, n, m, gated), PEAK_INT8_OPS)


def bound_chain_prepare(f, n_live, levels):
    """JjInv and Ji of the live rows read, the prepared value
    (levels, 2, F, 6, 6) written; two 6x6 products (2 x 36 x 11
    operations) per live row and level."""
    return bound(4 * (2 * 36 * n_live + levels * 72 * f),
                 levels * 2 * 36 * 11 * n_live, PEAK_F32_FLOPS)


def bound_chain_sweep(f, n_live):
    """The function x = M^-1 v as chain_sweep_plain states it: JjInv and
    Ji of the live rows (72 floats a row) read, v and winv read and x
    written for all F rows (13 floats a row); four 6x6 matrix-vector
    products (66 operations each) per live row. What a design reads
    besides (prepared blocks) is its own cost, not part of the bound."""
    return bound(4 * (72 * n_live + 13 * f), 4 * 66 * n_live,
                 PEAK_F32_FLOPS)


def ba_matvec_work(o, c, l, e):
    """(bytes, float32 operations) of one product of BA's reduced camera
    system with x (C,6): the coupling blocks W (O,6,3) and both index
    vectors read once, Hll^-1 (L,3,3), Hcc (C,6,6) and x read and the
    result written once, the priors' two Jacobians (E,6,6), weights and
    indices read once; 72 operations per observation (two 6x3 products),
    18 per landmark, 72 per camera, 288 per prior edge."""
    n_bytes = (o * (18 * 4 + 2 * 8) + l * 36 + c * (36 + 6 + 6) * 4
               + e * (2 * 36 * 4 + 4 + 2 * 8))
    return n_bytes, 72 * o + 18 * l + 72 * c + 288 * e


def bound_ba_matvec(o, c, l, e):
    return bound(*ba_matvec_work(o, c, l, e), PEAK_F32_FLOPS)


def ba_cost_work(o, c, l, index_bytes=8):
    """(bytes, float32 operations) of BA's Huber cost (`ba._cost`) over
    O observations of C poses (4x4) and L points: poses, points, both
    index vectors, uv, w, ur and wr read once, the residuals (O,3) and
    Huber weights (O,) written; per observation 47 operations (the point
    into the camera 18, the stereo projection and residuals 12, its
    square 5, the Huber weight 5, the weighted sum 3, the depth clamp and
    mask 4)."""
    n_bytes = (c * 64 + l * 12 + o * (2 * index_bytes + 4 * 5)
               + o * 16)
    return n_bytes, 47 * o


def bound_ba_cost(o, c, l, index_bytes=8):
    return bound(*ba_cost_work(o, c, l, index_bytes), PEAK_F32_FLOPS)


def ba_obs_work(o, c, l, launch: str):
    """(bytes, float32 operations) of one launch of BA's observation pass
    (`csrc/ba_obs.cu`) over O observations of C poses (4x4) and L points,
    every observation kept; each input read once, each output written
    once. Every launch reads the poses, the points, each observation's
    uv, ur, wr and w (20 bytes) and its ordering's row and other index
    (int32, 8 bytes), and works out the residual, its square, the Huber
    weight and the cut (45 operations an observation: the point into the
    camera 18, the stereo projection and residuals 14, r2 5, the weight
    and the cut 8). Besides:
      - "cameras": the camera offsets; the two costs and the kept count
        (6), the Jacobians Jp (17), Jc's [Jp hat(Xc)] and Jl (45 each),
        W (108), Hcc's upper triangle (126) and bc (33) an observation;
        W (72 bytes an observation), Hcc (144 bytes) and bc (24 bytes) a
        camera written;
      - "landmarks": the landmark offsets; Jp, Jl, Hll's upper triangle
        (36) and bl (18); Hll (36 bytes) and bl (12 bytes) a landmark
        written;
      - "cost": the camera offsets; the two costs (6); two floats
        written.
    The float64 sums are counted with the float32 operations."""
    reads = c * 64 + l * 12 + o * (20 + 8)
    if launch == "cameras":
        return (reads + (c + 1) * 4 + o * 72 + c * (144 + 24),
                o * (45 + 6 + 17 + 45 + 45 + 108 + 126 + 33))
    if launch == "landmarks":
        return (reads + (l + 1) * 4 + l * (36 + 12),
                o * (45 + 17 + 45 + 36 + 18))
    if launch == "cost":
        return reads + (c + 1) * 4 + 8, o * (45 + 6)
    raise ValueError(f"ba_obs_work: no launch {launch!r}")


def bound_ba_obs(o, c, l, launch: str):
    return bound(*ba_obs_work(o, c, l, launch), PEAK_F32_FLOPS)


def ba_cg_work(c, start: bool = False):
    """(bytes, float32 operations) of one launch of BA's PCG vector
    update (`csrc/ba_cg.cu`) over C camera rows, each input read once and
    each output written once. A step reads p, Ap, x, r (C,6) and Minv
    (C,6,6) and rz, and writes x, r, p (C,6) and rz: 312 bytes a camera;
    12 operations a camera for p.Ap, 24 for the x and r updates, 66 for
    z = Minv r, 12 for r.z and 12 for p. The start reads r and Minv and
    writes p and rz (192 bytes a camera; z and r.z, 78 operations). The
    float64 sums are counted with the float32 operations."""
    if start:
        return c * (24 + 144 + 24) + 4, 78 * c
    return c * (4 * 24 + 144 + 3 * 24) + 8, (12 + 24 + 66 + 12 + 12) * c


def bound_ba_cg(c, start: bool = False):
    return bound(*ba_cg_work(c, start), PEAK_F32_FLOPS)


# BAL's camera model on the CG path (`ba.BAL`, D = 9): the same kernels'
# work at 9-parameter cameras and the three launches of csrc/bal_obs.cu.
# `benchmark/yardstick/bal_bounds.py` keeps a frozen copy.

def bal_schur_work(o, c, l, half: str, x: bool = True, a: bool = False):
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
    raise ValueError(f"bal_schur_work: no half {half!r}")


def bal_obs_work(o, c, l, launch: str):
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
    raise ValueError(f"bal_obs_work: no launch {launch!r}")


def bal_cg_work(c, start: bool = False):
    """(bytes, float32 operations) of one launch of the PCG's vector
    update at D = 9 (`csrc/ba_cg.cu`): a step reads p, Ap, x, r (C,9),
    Minv (C,9,9) and rz and writes x, r, p (C,9) and rz; the start reads
    r and Minv and writes p and rz."""
    if start:
        return c * (36 + 324 + 36) + 4, (162 + 18) * c
    return (c * (4 * 36 + 324 + 3 * 36) + 8,
            (18 + 36 + 162 + 18 + 18) * c)


def bal_lm_iteration_work(o, c, l, cg_iters):
    """(bytes, float32 operations) of one LM iteration (a `bal_lm`
    replay) as the sum of its launches' work: the observation pass's
    cameras, landmarks and cost launches; the right side (the landmark
    half on a alone, the camera half on b); the product from x = 0 and
    cg_iters products (both halves); the back-substitution (the landmark
    half on x and a); the PCG's start and cg_iters steps."""
    def add(*works):
        return (sum(w[0] for w in works), sum(w[1] for w in works))
    product = add(bal_schur_work(o, c, l, "landmarks"),
                  bal_schur_work(o, c, l, "cameras"))
    parts = [bal_obs_work(o, c, l, k) for k in ("cameras", "landmarks", "cost")]
    parts += [bal_schur_work(o, c, l, "landmarks", x=False, a=True),
              bal_schur_work(o, c, l, "cameras"),
              bal_schur_work(o, c, l, "landmarks", x=True, a=True),
              bal_cg_work(c, start=True)]
    parts += [product] * (cg_iters + 1) + [bal_cg_work(c)] * cg_iters
    return add(*parts)


def bound_bal_lm_iteration(o, c, l, cg_iters):
    return bound(*bal_lm_iteration_work(o, c, l, cg_iters), PEAK_F32_FLOPS)


def bound_bal_schur(o, c, l, half, x=True, a=False):
    return bound(*bal_schur_work(o, c, l, half, x, a), PEAK_F32_FLOPS)


def bound_bal_obs(o, c, l, launch):
    return bound(*bal_obs_work(o, c, l, launch), PEAK_F32_FLOPS)
