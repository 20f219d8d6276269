"""Float64-capable references for the port's kernels (copied from
``repro/kernels/ref.py``, same names and arithmetic; the banked scatter's is
the port's own).

``pair_scatter_ref`` (the contract entry, also the estimator's
``scatter='numpy'`` backend) and ``pair_scatter_banked_ref`` (the banked
entry) are the tests' oracles for ``kernels.telemetry``; ``attention_ref``
is the oracle for ``kernels.flash_attention``, ``rwkv6_ref`` for
``kernels.rwkv6_scan`` and ``mamba_ref`` for ``kernels.mamba_scan``.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def attention_ref(q, k, v, *, causal=True, q_offset=0, dtype=torch.float32):
    """q [N, Sq, dh]; k, v [N, Skv, dh] -> [N, Sq, dh] in q's dtype.

    Softmax attention computed in ``dtype`` (float32, as the JAX reference,
    or float64), with -1e30 on the scores a causal mask hides
    (q_offset + i < j)."""
    N, Sq, dh = q.shape
    Skv = k.shape[1]
    s = torch.einsum("nqd,ntd->nqt", q.to(dtype), k.to(dtype)) / math.sqrt(dh)
    if causal:
        qp = q_offset + torch.arange(Sq, device=q.device)[:, None]
        kp = torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(qp >= kp, s, torch.full_like(s, -1e30))
    w = torch.softmax(s, dim=-1)
    return torch.einsum("nqt,ntd->nqd", w, v.to(dtype)).to(q.dtype)


def rwkv6_ref(r, k, v, wlog, u, s0):
    """Sequential WKV6 recurrence (the definition). All [N, S, dh] + u [N, dh],
    s0 [N, dh, dh] (key dim first). Returns (y [N, S, dh], sT), computed in
    the dtype of the inputs (float64 makes it the tests' oracle)."""
    N, S, dh = r.shape

    def step(s, t):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], wlog[:, t]
        # y_t[j] = sum_i r[i] * (s[i,j] + u[i] k[i] v[j])
        y = torch.einsum("ni,nij->nj", rt, s) + torch.einsum("ni,ni,ni,nj->nj", rt, u, kt, vt)
        s = torch.exp(wt)[:, :, None] * s + kt[:, :, None] * vt[:, None, :]
        return s, y

    s = s0
    ys = []
    for t in range(S):  # python loop: this is an oracle, clarity over speed
        s, y = step(s, t)
        ys.append(y)
    return torch.stack(ys, dim=1), s


def mamba_ref(da, dbu, c, h0=None):
    """Sequential selective-scan recurrence (the definition). da, dbu
    [B, S, E, N]; c [B, S, N]; h0 [B, E, N] or None for a zero state (the
    JAX reference always starts from zero). Returns (y [B, S, E], hT
    [B, E, N]), computed in the dtype of the inputs (float64 makes it the
    tests' oracle)."""
    B, S, E, N = da.shape
    h = torch.zeros((B, E, N), dtype=da.dtype, device=da.device) if h0 is None else h0
    ys = []
    for t in range(S):  # python loop: this is an oracle, clarity over speed
        h = da[:, t] * h + dbu[:, t]
        ys.append(torch.einsum("ben,bn->be", h, c[:, t]))
    return torch.stack(ys, dim=1), h


def pair_scatter_ref(types, cbar, vals):
    """Pair-statistic scatter accumulation (telemetry estimator), float64.

    types i32[B]; cbar [B, T]; vals [B] or [K, B] (K stacked statistics).
    Returns (pair [T, T], base [T]) for 1-D vals, (pair [K, T, T], base
    [K, T]) for stacked, with per statistic k
      pair[k, u, t] = sum_b cbar[b, u] * vals[k, b] * 1{types[b] == t}
      base[k, t]    = sum_b             vals[k, b] * 1{types[b] == t}.
    Out-of-range types (padding, masked-invalid rows) contribute nothing.
    """
    cbar = np.asarray(cbar, np.float64)
    vals = np.asarray(vals, np.float64)
    types = np.asarray(types)
    squeeze = vals.ndim == 1
    vals = np.atleast_2d(vals)  # [K, B]
    K = vals.shape[0]
    B, T = cbar.shape
    pair = np.zeros((K, T, T))
    base = np.zeros((K, T))
    for b in range(B):
        t = int(types[b])
        if not 0 <= t < T:
            continue
        for k in range(K):
            pair[k, :, t] += cbar[b] * vals[k, b]
            base[k, t] += vals[k, b]
    return (pair[0], base[0]) if squeeze else (pair, base)


def pair_scatter_banked_ref(keys, co, vals, n_rows):
    """The banked scatter over the combined (bank row, type) key space,
    float64: keys i32[B] (in-range keys lie in [0, n_rows)), co [B, T],
    vals [K, B]. Returns (rows [K, B, T], slot_keys i64[B]) in the kernel's
    layout: slot j holds, for the j-th distinct in-range key r in ascending
    order, rows[k, j] = sum_b co[b] * vals[k, b] * 1{keys[b] == r}; slots
    past the last key hold zeros and the key ``n_rows``."""
    keys = np.asarray(keys).astype(np.int64)
    co = np.asarray(co, np.float64)
    vals = np.asarray(vals, np.float64)
    B, T = co.shape
    K = vals.shape[0]
    uniq = np.unique(keys[(keys >= 0) & (keys < n_rows)])
    slot = {int(r): j for j, r in enumerate(uniq)}
    rows = np.zeros((K, B, T))
    for b in range(B):
        j = slot.get(int(keys[b]))
        if j is None:
            continue
        for k in range(K):
            rows[k, j] += co[b] * vals[k, b]
    slot_keys = np.full(B, n_rows, np.int64)
    slot_keys[:len(uniq)] = uniq
    return rows, slot_keys
