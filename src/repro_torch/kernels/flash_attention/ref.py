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
kernel; no caller makes such a row (a cached query always sees itself).
"""

from __future__ import annotations

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
                        scale: float | None = None) -> torch.Tensor:
    """Chunked online-softmax attention.

    q: (B, Sq, H, Dk); k: (B, Skv, KV, Dk); v: (B, Skv, KV, Dv), H a
    multiple of KV (GQA).  Scores, (m, l, acc) and the division are
    fp32; returns (B, Sq, H, Dv) in q's dtype.  Chunk pairs run in the
    reference's order (q chunk major), above-diagonal pairs skipped.
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

    outs = []
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
    out = torch.stack(outs, 1).reshape(b, sq_p, h, dv)[:, :sq]
    return out.to(q.dtype)
