"""The least time one H100 could take for a function's work: a frozen
copy of the published peaks and work formulas of
`slam1_tpu_torch/utils/bounds.py`, with the work of one LM iteration of
BA added. The larger of the bytes the function must move (each input
read once, each output written once) over the memory rate, and the
operations it must do over the peak rate for their type.

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


def ba_lm_iteration_work(o, c, l, e, cg_iters):
    """(bytes, float32 operations) of one LM iteration of BA's CG path
    (`ba.lm_step` with C > 16), as the sum of the functions it is made
    of: the build, which reads the problem once (`ba_cost_work`'s
    bytes) and writes the coupling blocks W (O,6,3) and the Hessian
    blocks Hcc (C,6,6), Hll (L,3,3) once (with their 36 + 9 + 18
    multiply-adds of each observation's Jacobian products, 2 operations
    each); cg_iters + 1 products of the reduced camera system
    (`ba_matvec_work`, each of which reads W, since the product is a
    function of it); and two cost evaluations (`ba_cost_work`), before
    and after the step. A lower bound of the iteration as long as each
    product reads W from device memory, which at 72 bytes an observation
    is more than the L2 cache holds past ~700 k observations; below that
    the share may read high and says so in PERF.md."""
    cost_b, cost_ops = ba_cost_work(o, c, l)
    mv_b, mv_ops = ba_matvec_work(o, c, l, e)
    build_b = cost_b + o * 18 * 4 + c * 36 * 4 + l * 9 * 4
    build_ops = o * 2 * (36 + 9 + 18)
    return (build_b + (cg_iters + 1) * mv_b + 2 * cost_b,
            build_ops + (cg_iters + 1) * mv_ops + 2 * cost_ops)


def bound_ba_lm_iteration(o, c, l, e, cg_iters):
    return bound(*ba_lm_iteration_work(o, c, l, e, cg_iters), PEAK_F32_FLOPS)
