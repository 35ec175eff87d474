"""Bag-of-visual-words place recognition (counterpart of
`slam1_tpu/models/bow.py`).

A vocabulary trained online from a reservoir of sampled descriptors,
one L1-normalised word histogram per keyframe, and a chi^2 scan of the
whole frame DB with greedy non-maximum suppression.

The tables are updated in place (the reference donates its state to
each step); a caller that needs the old state clones it first. A write
the reference masks by sending it out of bounds (`mode="drop"`) is a
`where(gate, new, old)` rewrite of its one target row here, so no step
reads a value back to the host. Random draws are (N,) uniforms in
[1e-9, 1) passed in by the caller.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from slam1_tpu_torch.config import BowConfig
from slam1_tpu_torch.ops.brief import unpack_bits_pm1
from slam1_tpu_torch.ops.kmeans import assign_words, gumbel_top, kmeans_pm1
from slam1_tpu_torch.models.mapping import scalar
from slam1_tpu_torch.runtime import default_device


class BowState(NamedTuple):
    vocab: torch.Tensor       # (K,D) float32 centroids in +-1 space
    trained: torch.Tensor     # () bool
    db: torch.Tensor          # (F,K) float32 L1-normalised histograms
    db_mask: torch.Tensor     # (F,) bool — frame has a histogram
    reservoir: torch.Tensor   # (R,D) float32 descriptor sample buffer
    res_mask: torch.Tensor    # (R,) bool
    res_cursor: torch.Tensor  # () int32
    frame_desc: torch.Tensor  # (F,S,Db) uint8 per-frame descriptor sample
    frame_mask: torch.Tensor  # (F,S) bool


def init_bow(cfg: BowConfig, max_frames: int, desc_bits: int = 256,
             reservoir: int = 8192, device=None) -> BowState:
    device = default_device(device)

    def z(*shape, dtype=torch.float32):
        return torch.zeros(shape, dtype=dtype, device=device)

    s = cfg.backfill_desc_per_frame
    return BowState(
        vocab=z(cfg.num_words, desc_bits),
        trained=z(dtype=torch.bool),
        db=z(max_frames, cfg.num_words),
        db_mask=z(max_frames, dtype=torch.bool),
        reservoir=z(reservoir, desc_bits),
        res_mask=z(reservoir, dtype=torch.bool),
        res_cursor=z(dtype=torch.int32),
        frame_desc=z(max_frames, s, desc_bits // 8, dtype=torch.uint8),
        frame_mask=z(max_frames, s, dtype=torch.bool),
    )


def accumulate(state: BowState, u, desc, mask,
               n_sample: int = 128) -> BowState:
    """Push a random sample of this frame's descriptors into the
    reservoir ring (u: (N,) draws)."""
    pick = gumbel_top(u, mask, n_sample)
    picked = unpack_bits_pm1(desc[pick]).to(torch.float32)
    picked_ok = mask[pick]
    r = state.reservoir.shape[0]
    rows = ((state.res_cursor.long()
             + torch.arange(n_sample, device=desc.device)) % r)
    old = state.reservoir[rows]
    state.reservoir[rows] = torch.where(picked_ok[:, None], picked, old)
    state.res_mask[rows] = state.res_mask[rows] | picked_ok
    return state._replace(res_cursor=state.res_cursor + n_sample)


def train(state: BowState, u, cfg: BowConfig) -> BowState:
    """Train the vocabulary on the reservoir (u: (R,) draws)."""
    vocab, _ = kmeans_pm1(state.reservoir, state.res_mask, cfg.num_words,
                          cfg.train_iters, u=u)
    return state._replace(vocab=vocab,
                          trained=torch.ones_like(state.trained))


def histogram(desc, mask, vocab):
    """(..., N, 32) packed descriptors -> (..., K) L1-normalised word
    histogram of the valid rows."""
    x = unpack_bits_pm1(desc).to(torch.float32)
    words = assign_words(x, vocab).long()
    k = vocab.shape[0]
    h = torch.zeros(desc.shape[:-2] + (k,), dtype=torch.float32,
                    device=desc.device)
    # Adds of 1.0 are exact in any order.
    h.scatter_add_(-1, words, mask.to(torch.float32))
    return h / torch.clamp(torch.sum(h, dim=-1, keepdim=True), min=1.0)


def _set_row(table, row, gate, value):
    """table[row] = value where the 0-d bool `gate` holds, else kept;
    `row` is a (1,) index tensor."""
    table.index_copy_(0, row, torch.where(gate, value[None],
                                          table.index_select(0, row)))


def add_frame(state: BowState, u, frame_idx, desc, mask,
              is_kf=True) -> BowState:
    """Insert this frame's histogram + descriptor sample into DB row
    `frame_idx` (an int or 0-d tensor, clamped into the table on the
    device), gated on keyframe status (u: (N,) draws)."""
    dev = desc.device
    ok = scalar(is_kf, torch.bool, dev)
    row = torch.clamp(scalar(frame_idx, torch.int64, dev), 0,
                      state.db.shape[0] - 1).reshape(1)
    s = state.frame_desc.shape[1]
    n = mask.shape[0]
    pick = gumbel_top(u, mask, min(s, n))
    picked = desc[pick]
    picked_ok = mask[pick]
    if n < s:
        picked = torch.cat([picked, torch.zeros(
            (s - n,) + picked.shape[1:], dtype=picked.dtype, device=dev)])
        picked_ok = torch.cat([picked_ok, torch.zeros(
            s - n, dtype=torch.bool, device=dev)])
    # The DB row comes from the same fixed-size sample as backfilled
    # rows, so every row carries the same sampling-noise floor.
    h = histogram(picked, picked_ok, state.vocab)
    _set_row(state.db, row, ok, h)
    _set_row(state.db_mask, row, ok, state.trained)
    _set_row(state.frame_desc, row, ok, picked)
    _set_row(state.frame_mask, row, ok, picked_ok)
    return state


def backfill_chunk(state: BowState, start: int, chunk: int) -> BowState:
    """Give rows [start, start+chunk) that have a descriptor sample but
    no histogram yet (frames seen before the vocabulary trained) their
    DB row."""
    f_cap = state.db.shape[0]
    lo, hi = int(start), min(int(start) + chunk, f_cap)
    if lo >= hi:
        return state
    h = histogram(state.frame_desc[lo:hi], state.frame_mask[lo:hi],
                  state.vocab)
    ok = (state.trained & ~state.db_mask[lo:hi]
          & torch.any(state.frame_mask[lo:hi], dim=1))
    state.db[lo:hi] = torch.where(ok[:, None], h, state.db[lo:hi])
    state.db_mask[lo:hi] |= ok
    return state


def query_topk(state: BowState, frame_idx, desc, mask,
               cfg: BowConfig, k: int = 3, min_sep: int = 8
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chi^2 scan against all frames at least `query_exclude` older,
    returning the k best candidates separated by more than `min_sep`
    frames, best first: (frames (k,) int32, -1 where nothing is
    eligible; dists (k,) float32, -1 there). `frame_idx` is an int or a
    0-d tensor."""
    h = histogram(desc, mask, state.vocab)
    diff2 = (state.db - h[None, :]) ** 2
    denom = state.db + h[None, :] + 1e-10
    chi2 = torch.sum(diff2 / denom, dim=1)                  # (F,)
    f_cap = state.db.shape[0]
    ar = torch.arange(f_cap, device=desc.device)
    eligible = state.db_mask & (ar <= frame_idx - cfg.query_exclude) \
        & state.trained
    c = torch.where(eligible, chi2, torch.full_like(chi2, float("inf")))
    idx, vals = [], []
    for _ in range(k):
        v, b = torch.min(c, dim=0)          # first index on ties
        idx.append(b)
        vals.append(v)
        c = torch.where(torch.abs(ar - b) <= min_sep,
                        torch.full_like(c, float("inf")), c)
    idx, vals = torch.stack(idx), torch.stack(vals)
    found = torch.isfinite(vals)
    return (torch.where(found, idx, -1).to(torch.int32),
            torch.where(found, vals, -1.0).to(torch.float32))


def query(state: BowState, frame_idx, desc, mask,
          cfg: BowConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """Best-match variant of query_topk."""
    frames, dists = query_topk(state, frame_idx, desc, mask, cfg, k=1)
    return frames[0], dists[0]
