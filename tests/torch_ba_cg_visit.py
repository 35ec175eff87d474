"""What csrc/ba_cg.cu computes, in PyTorch (not collected): the launch's
arithmetic in its own order, its operands and the tolerance it is held
to against the plain twins. Shared by `test_torch_ba_cg.py` (the CPU)
and `test_torch_kernels_cuda.py` (the card, where the kernel gives these
bits).

  - `kernel_sum`: the launch's float64 sum of per-camera products: a
    thread t of the cluster takes cameras t, t + S, ... (S = blocks x
    threads), each camera's six products in order; a warp's 32 partials
    by the xor shuffle tree (lane 0's sum), a block's warps in order, and
    the blocks' sums in block order;
  - `kernel_start`, `kernel_step`: the launch's outputs, the vector
    updates and z = Minv r in float32 in the kernel's order (a multiply
    and an add each, z_i summed from j = 0), the two dot products through
    `kernel_sum`, rounded once to float32;
  - `cg_inputs`: a CG state of a block-diagonal SPD system;
  - `CG_TOL` and `within_tol`: kernel (or its arithmetic) against the
    twins.
"""

import torch

from slam1_tpu_torch.ops.cuda_kernels import CG_EPS

# The kernel against the twins, per element, as a share of the terms'
# magnitude (float64 on absolute values, `magnitudes`): the twins sum the
# two dot products of 6C float32 products in float32 (pairwise: ~log2(6C)
# roundings of 2^-24, ~1e-6 of the sum of |terms| at C = 8192), the
# kernel in float64 rounded once; the difference reaches x, r and p
# through the step lengths, and z through r. Per element the updates and
# z are the same float32 operations, but the twins' einsum may sum z's
# six products in another order (a few roundings of 2^-24 of |Minv||r|).
# 1e-5 leaves about ten times the sums' error on these systems, whose
# products with the direction are positive camera by camera.
CG_TOL = 1e-5


def kernel_sum(terms, blocks: int, threads: int):
    """The launch's float64 sum of terms (C,6) float64 -> 0-d float64."""
    c = terms.shape[0]
    s = blocks * threads
    k = -(-c // s)
    pad = torch.zeros((k * s, 6), dtype=torch.float64, device=terms.device)
    pad[:c] = terms
    pad = pad.reshape(k, s, 6)
    part = torch.zeros(s, dtype=torch.float64, device=terms.device)
    for j in range(k):
        for i in range(6):
            part = part + pad[j, :, i]
    lanes = torch.arange(32, device=terms.device)

    def tree(v):
        for d in (16, 8, 4, 2, 1):
            v = v + v[..., lanes ^ d]
        return v[..., 0]
    warps = tree(part.reshape(s // 32, 32)).reshape(blocks, threads // 32)
    block = warps[:, 0]
    for w in range(1, threads // 32):
        block = block + warps[:, w]
    total = block[0]
    for b in range(1, blocks):
        total = total + block[b]
    return total


def _precond(minv, r):
    z = []
    for i in range(6):
        acc = minv[:, i, 0] * r[:, 0]
        for j in range(1, 6):
            acc = acc + minv[:, i, j] * r[:, j]
        z.append(acc)
    return torch.stack(z, -1)


def _dot(u, v, blocks, threads):
    return kernel_sum(u.double() * v.double(), blocks, threads).float()


def kernel_start(r, minv, blocks: int, threads: int):
    """The start launch -> (p = Minv r, rz = r.z)."""
    z = _precond(minv, r)
    return z, _dot(r, z, blocks, threads)


def kernel_step(p, ap, x, r, minv, rz, blocks: int, threads: int):
    """A step launch -> (x, r, p, rz) one iteration on."""
    eps = torch.tensor(CG_EPS, dtype=torch.float32)
    denom = _dot(p, ap, blocks, threads)
    alpha = rz / torch.where(denom.abs() < eps, eps, denom)
    alive = rz > eps
    alpha = torch.where(alive, alpha, torch.zeros_like(alpha))
    x = x + alpha * p
    r = r - alpha * ap
    z = _precond(minv, r)
    rz_new = _dot(r, z, blocks, threads)
    beta = rz_new / torch.where(rz.abs() < eps, eps, rz)
    beta = torch.where(alive, beta, torch.zeros_like(beta))
    return x, r, z + beta * p, rz_new


def cg_inputs(c: int, seed: int, device="cpu", live=None):
    """A CG state over C camera rows, of which the first `live` (all by
    default) are observed, as global BA's system has them: H_c = A A^T +
    I SPD (1e-6 I, the damping alone, on unobserved rows), Minv = H^-1,
    r and x random (r = 0 on unobserved rows), p = Minv r and Ap = H p
    (the blocks' own product: p.Ap > 0 camera by camera) -> dict of
    float32 tensors p, ap, x, r, minv and rz = r.p (0-d)."""
    g = torch.Generator().manual_seed(seed)
    live = c if live is None else live
    a = torch.randn((c, 6, 6), generator=g, dtype=torch.float64)
    h = a @ a.transpose(1, 2) + torch.eye(6, dtype=torch.float64)
    h[live:] = 1e-6 * torch.eye(6, dtype=torch.float64)
    r = torch.randn((c, 6), generator=g, dtype=torch.float64)
    r[live:] = 0.0
    minv = torch.linalg.inv(h)
    p = torch.einsum("cij,cj->ci", minv, r)
    out = dict(p=p, ap=torch.einsum("cij,cj->ci", h, p),
               x=torch.randn((c, 6), generator=g, dtype=torch.float64),
               r=r, minv=minv, rz=torch.sum(r * p))
    return {k: v.float().contiguous().to(device) for k, v in out.items()}


def magnitudes(t, alpha, beta):
    """The magnitudes of a step's terms (float64 on absolute values): x,
    r, p (C,6) and rz (), given the step's alpha and beta."""
    a, b = abs(float(alpha)), abs(float(beta))
    p, ap, x, r, minv = [t[k].double().abs() for k in
                         ("p", "ap", "x", "r", "minv")]
    m_x = x + a * p
    m_r = r + a * ap
    m_z = torch.einsum("cij,cj->ci", minv, m_r)
    return m_x, m_r, m_z + b * p, torch.sum(m_r * m_z)


def within_tol(got, want, mag) -> bool:
    """|got - want| <= CG_TOL x mag, element by element."""
    return bool(((got.double() - want.double()).abs()
                 <= CG_TOL * mag + 1e-30).all())
