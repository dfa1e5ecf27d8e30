"""Plain twin of the flash-attention kernel: the reference's chunked
online-softmax attention (``flash_attention_ref`` of the model layer),
in torch.

It is the function the kernel computes, so it is what the CPU path runs
and what the kernel is held against on the card.  Its conventions are
the reference oracle's, not the TPU kernel's:

* the causal diagonal is aligned at the *end* — query i sees keys
  ≤ i + (Skv − Sq) — where the TPU kernel aligns it at the start (the two
  agree only for Sq == Skv);
* keys at or past Skv never count, whatever the chunking pads (the TPU
  kernel's wrapper pads K/V and forgets the true length);
* an optional valid-key length, (B,) per batch row or (B, Sq) per query,
  masks keys ≥ the length.

A row with no valid key at all comes out as the mean of the masked rows
of V here (every masked score is the same −1e30) and as zeros from the
kernels; no caller makes such a row (a cached query always sees itself).

:func:`split_partials` and :func:`combine_partials` are the plain
version of the card's split-KV path: per key range, the base-2 online
softmax state (m, l, acc) of the packed query rows that share a KV head,
then one combine in a fixed order.  Composed, they compute the twin's
function (zeros for a row with no valid key, as the kernels).

:func:`flash_attention_bwd_ref` is the plain twin of the backward
kernel: the reference's custom VJP of its flash attention
(``_flash_attn_bwd``), chunk pair for chunk pair.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _pad_to(x: torch.Tensor, n: int, axis: int) -> torch.Tensor:
    pad = n - x.shape[axis]
    if pad == 0:
        return x
    widths = [0, 0] * (x.ndim - axis - 1) + [0, pad]
    return F.pad(x, widths)


def flash_attention_ref(q, k, v, *, causal: bool, q_chunk: int = 512,
                        kv_chunk: int = 512, bias_mask_len=None,
                        scale: float | None = None,
                        return_lse: bool = False):
    """Chunked online-softmax attention.

    q: (B, Sq, H, Dk); k: (B, Skv, KV, Dk); v: (B, Skv, KV, Dv), H a
    multiple of KV (GQA).  Scores, (m, l, acc) and the division are
    fp32; returns (B, Sq, H, Dv) in q's dtype.  Chunk pairs run in the
    reference's order (q chunk major), above-diagonal pairs skipped.
    With ``return_lse`` also the log-sum-exp of each row's scaled
    scores, m + ln l, fp32 (B, Sq, KV, H/KV): the backward's residual.
    """
    b, sq, h, dk = q.shape
    _, skv, kv, dv = v.shape
    g = h // kv
    scale = dk ** -0.5 if scale is None else scale
    qc = min(q_chunk, sq)
    kc = min(kv_chunk, skv)
    nq = -(-sq // qc)
    nk = -(-skv // kc)
    sq_p, skv_p = nq * qc, nk * kc
    offset = skv - sq  # causal diagonal offset
    f32 = torch.float32
    qp = _pad_to(q, sq_p, 1).reshape(b, nq, qc, kv, g, dk).to(f32)
    kp = _pad_to(k, skv_p, 1).reshape(b, nk, kc, kv, dk).to(f32)
    vp = _pad_to(v, skv_p, 1).reshape(b, nk, kc, kv, dv).to(f32)
    dev = q.device
    q_pos = torch.arange(qc, device=dev)
    k_pos = torch.arange(kc, device=dev)
    mask2d = None
    if bias_mask_len is not None and bias_mask_len.ndim == 2:
        mask2d = _pad_to(bias_mask_len, sq_p, 1).reshape(b, nq, qc)
    neg = torch.tensor(NEG_INF, dtype=f32, device=dev)

    outs, lses = [], []
    for i in range(nq):
        acc = torch.zeros((b, qc, kv, g, dv), dtype=f32, device=dev)
        m = torch.full((b, qc, kv, g), NEG_INF, dtype=f32, device=dev)
        l = torch.zeros((b, qc, kv, g), dtype=f32, device=dev)
        for j in range(nk):
            if causal and not j * kc <= i * qc + offset + qc - 1:
                continue
            s = torch.einsum("bqkgd,bskd->bqkgs", qp[:, i], kp[:, j]) * scale
            kabs = (j * kc + k_pos)[None, None, None, None, :]
            if causal:
                qabs = (i * qc + q_pos + offset)[None, :, None, None, None]
                s = torch.where(kabs <= qabs, s, neg)
            s = torch.where(kabs < skv, s, neg)
            if bias_mask_len is not None:
                if mask2d is None:
                    ml = bias_mask_len[:, None, None, None, None]
                else:
                    ml = mask2d[:, i][:, :, None, None, None]
                s = torch.where(kabs < ml, s, neg)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bqkgs,bskd->bqkgd", p, vp[:, j])
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
    out = torch.stack(outs, 1).reshape(b, sq_p, h, dv)[:, :sq].to(q.dtype)
    if return_lse:
        return out, torch.stack(lses, 1).reshape(b, sq_p, kv, g)[:, :sq]
    return out


def flash_attention_bwd_ref(q, k, v, out, lse, dout, *, causal: bool,
                            q_chunk: int = 512, kv_chunk: int = 512,
                            scale: float | None = None):
    """The flash backward: (dq, dk, dv) in the inputs' dtypes.

    ``out`` and ``lse`` are the forward's (``return_lse``), ``dout`` the
    output's gradient.  As the reference's ``_flash_attn_bwd``: D =
    rowsum(dout ⊙ out), then for each chunk pair (q chunk major, the
    causal pairs only) P recomputed from the lse, dV += Pᵀ dO, dP =
    dO Vᵀ, dS = P ⊙ (dP − D) · scale, dQ += dS K, dK += dSᵀ Q, all fp32.
    No length mask: the reference differentiates its masked paths
    through the plain forward.
    """
    b, sq, h, dk = q.shape
    _, skv, kv, dv = v.shape
    g = h // kv
    scale = dk ** -0.5 if scale is None else scale
    qc = min(q_chunk, sq)
    kc = min(kv_chunk, skv)
    nq = -(-sq // qc)
    nk = -(-skv // kc)
    sq_p, skv_p = nq * qc, nk * kc
    offset = skv - sq
    f32 = torch.float32
    qp = _pad_to(q, sq_p, 1).reshape(b, nq, qc, kv, g, dk).to(f32)
    kp = _pad_to(k, skv_p, 1).reshape(b, nk, kc, kv, dk).to(f32)
    vp = _pad_to(v, skv_p, 1).reshape(b, nk, kc, kv, dv).to(f32)
    dop = _pad_to(dout, sq_p, 1).reshape(b, nq, qc, kv, g, dv).to(f32)
    op = _pad_to(out, sq_p, 1).reshape(b, nq, qc, kv, g, dv).to(f32)
    lsep = _pad_to(lse, sq_p, 1).reshape(b, nq, qc, kv, g).to(f32)
    dmat = (dop * op).sum(-1)                        # (b, nq, qc, kv, g)
    dev = q.device
    q_pos = torch.arange(qc, device=dev)
    k_pos = torch.arange(kc, device=dev)
    neg = torch.tensor(NEG_INF, dtype=f32, device=dev)
    dq = torch.zeros_like(qp)
    dk_ = torch.zeros_like(kp)
    dv_ = torch.zeros_like(vp)
    for i in range(nq):
        for j in range(nk):
            if causal and not j * kc <= i * qc + offset + qc - 1:
                continue
            qi, kj, vj, doi = qp[:, i], kp[:, j], vp[:, j], dop[:, i]
            s = torch.einsum("bqkgd,bskd->bqkgs", qi, kj) * scale
            kabs = (j * kc + k_pos)[None, None, None, None, :]
            if causal:
                qabs = (i * qc + q_pos + offset)[None, :, None, None, None]
                s = torch.where(kabs <= qabs, s, neg)
            s = torch.where(kabs < skv, s, neg)
            p = torch.exp(s - lsep[:, i][..., None])     # (b,q,k,g,s)
            dv_[:, j] += torch.einsum("bqkgs,bqkgd->bskd", p, doi)
            dp = torch.einsum("bqkgd,bskd->bqkgs", doi, vj)
            ds = p * (dp - dmat[:, i][..., None]) * scale
            dq[:, i] += torch.einsum("bqkgs,bskd->bqkgd", ds, kj)
            dk_[:, j] += torch.einsum("bqkgs,bqkgd->bskd", ds, qi)
    return (dq.reshape(b, sq_p, h, dk)[:, :sq].to(q.dtype),
            dk_.reshape(b, skv_p, kv, dk)[:, :skv].to(k.dtype),
            dv_.reshape(b, skv_p, kv, dv)[:, :skv].to(v.dtype))


LOG2E = 1.4426950408889634


def _row_limits(b, sq, skv, causal, mask_len, device):
    """(B, Sq) int64: query t of batch row b counts keys j < lim[b, t]."""
    lim = torch.full((b, sq), skv, dtype=torch.int64, device=device)
    if mask_len is not None:
        ml = mask_len.to(torch.int64)
        lim = torch.minimum(lim, ml[:, None] if ml.ndim == 1 else ml)
    if causal:
        diag = torch.arange(sq, device=device) + (skv - sq + 1)
        lim = torch.minimum(lim, diag[None])
    return lim.clamp(min=0)


def split_partials(q, k, v, *, causal: bool, splits: int, chunk: int,
                   mask_len=None, scale: float | None = None):
    """The split path's first kernel, in plain torch.

    Query rows are packed per KV head: row r = t·G + j holds query t of
    head g·G + j (G = H/KV).  Range s holds keys [s·chunk, (s+1)·chunk).
    Returns fp32 m, l of shape (splits, B, KV, Sq·G) and acc of shape
    (splits, B, KV, Sq·G, Dv): the base-2 running max of the counted
    scores (scale·log2(e) folded in; −inf where the range counts no key),
    Σ 2^(s − m) and Σ 2^(s − m)·v over the range's counted keys."""
    b, sq, h, dk = q.shape
    _, skv, kv, dv = v.shape
    g = h // kv
    scale = dk ** -0.5 if scale is None else scale
    f32 = torch.float32
    qp = q.to(f32).reshape(b, sq, kv, g, dk).permute(0, 2, 1, 3, 4)
    qp = qp.reshape(b, kv, sq * g, dk)
    s = torch.einsum("bkrd,bskd->bkrs", qp, k.to(f32)) * (scale * LOG2E)
    lim = _row_limits(b, sq, skv, causal, mask_len, q.device)
    lim = lim.repeat_interleave(g, dim=1)[:, None, :, None]   # (B,1,R,1)
    keys = torch.arange(skv, device=q.device)
    ms, ls, accs = [], [], []
    for i in range(splits):
        inside = (keys >= i * chunk) & (keys < (i + 1) * chunk)
        counted = (keys < lim) & inside
        si = torch.where(counted, s, torch.tensor(-math.inf, device=q.device))
        m = si.amax(-1)
        m_ref = torch.where(torch.isinf(m), torch.zeros_like(m), m)
        p = torch.exp2(si - m_ref[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkrs,bskd->bkrd", p, v.to(f32)))
    return torch.stack(ms), torch.stack(ls), torch.stack(accs)


def combine_partials(m, l, acc, h: int, dtype=torch.float32):
    """The split path's second kernel: ranges merged in order, each
    weighted by 2^(m_s − max m); returns (B, Sq, H, Dv) in ``dtype``."""
    _, b, kv, rows, dv = acc.shape
    g = h // kv
    top = m.amax(0)
    top = torch.where(torch.isinf(top), torch.zeros_like(top), top)
    w = torch.exp2(m - top)
    den = (l * w).sum(0)
    out = (acc * w[..., None]).sum(0) / torch.clamp(den[..., None],
                                                     min=1e-30)
    out = out.reshape(b, kv, rows // g, g, dv).permute(0, 2, 1, 3, 4)
    return out.reshape(b, rows // g, h, dv).to(dtype)
