"""Float64-capable references for the port's kernels (copied from
``repro/kernels/ref.py``, same names and arithmetic).

``pair_scatter_ref`` is the tests' oracle for ``kernels.telemetry`` and the
estimator's ``scatter='numpy'`` backend; ``attention_ref`` is the oracle
for ``kernels.flash_attention``, ``rwkv6_ref`` for ``kernels.rwkv6_scan``
and ``mamba_ref`` for ``kernels.mamba_scan``.
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
