"""Scaled-dot-product attention, materialised or blockwise.

Counterpart of makani_tpu/models/common/attention.py (:30-93), in plain
PyTorch as makani_tpu's is plain XLA. Up to `min_blockwise_tokens` tokens
the softmax is materialised: float32 logits (bf16 operands are widened,
which is exact, as `preferred_element_type` float32), softmax, then P in
the values' type times V. Beyond, the blockwise online-softmax recurrence
over key blocks of `block_size` (default `_DEFAULT_BLOCK_SIZE`, 1024): the
keys and values are zero-padded to a multiple of the block and the padded
keys' logits set to -1e30; the row maximum, the normalizer and the
accumulator are carried in float32, P is cast to the values' type before
P @ V, whose products and sums are float32. Each block step is recomputed in
backward instead of saved (torch.utils.checkpoint, non-reentrant), as
makani_tpu's jax.checkpoint on the scan body: a layer keeps only each
step's carries. Only the last block holds padded keys, so the mask is
applied there alone (elsewhere makani_tpu's jnp.where selects every logit).

The queries may be fewer than the keys (a spatial rank's tokens against
every token, models/networks/vit.py): the path and the key blocks follow the
keys' count, so each query row is computed as the serial run computes it.

This is not F.scaled_dot_product_attention: that is another function
(rounding and summation order) and a library kernel, which the port does
not run.
"""

import torch

from makani_tpu_torch.models.common.layers import remat

_DEFAULT_BLOCK_SIZE = 1024
_NEG = -1e30


def set_attention_block_size(n):
    """The default key-block size of the blockwise recurrence."""
    global _DEFAULT_BLOCK_SIZE
    _DEFAULT_BLOCK_SIZE = int(n)


def _logits(q, k, scale):
    """float32 (B, H, N, M) logits q k^T * scale."""
    return (q.float() @ k.float().transpose(-1, -2)) * scale


def _pv(p, v):
    """P @ V with P cast to V's type, products and sums in float32."""
    return p.to(v.dtype).float() @ v.float()


def _block_step(acc, m, l, q, kblk, vblk, scale, n_valid):
    s = _logits(q, kblk, scale)
    if n_valid < kblk.shape[-2]:
        valid = torch.arange(kblk.shape[-2], device=s.device) < n_valid
        s = torch.where(valid, s, torch.full((), _NEG, device=s.device))
    m_new = torch.maximum(m, s.amax(-1, keepdim=True))
    p = torch.exp(s - m_new)
    corr = torch.exp(m - m_new)
    return acc * corr + _pv(p, vblk), m_new, l * corr + p.sum(-1, keepdim=True)


def scaled_dot_product_attention(q, k, v, scale=None, block_size=None,
                                 min_blockwise_tokens=2048):
    """Attention of q (B, H, N, D) over k, v (B, H, M, D); returns (B, H, N,
    D) in q's type."""
    b, h, n, d = q.shape
    m_keys = k.shape[-2]
    if scale is None:
        scale = d ** -0.5
    if block_size is None:
        block_size = _DEFAULT_BLOCK_SIZE

    if m_keys <= min_blockwise_tokens:
        p = torch.softmax(_logits(q, k, scale), dim=-1)
        return _pv(p, v).to(v.dtype)

    nb = -(-m_keys // block_size)
    pad = nb * block_size - m_keys
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
    acc = torch.zeros((b, h, n, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, n, 1), _NEG, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, n, 1), dtype=torch.float32, device=q.device)
    for i in range(nb):
        blk = slice(i * block_size, (i + 1) * block_size)
        n_valid = min(block_size, m_keys - i * block_size)
        acc, m, l = remat(_block_step, acc, m, l, q, k[..., blk, :], v[..., blk, :], scale,
                          n_valid)
    return (acc / l).to(q.dtype)
