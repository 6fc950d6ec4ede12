"""Plain PyTorch oracles for the port's kernels (the allclose ground truth).

Counterpart of `repro.kernels.ref`: the model-level forms the kernels
replace (the naive attention, the layer's RMSNorm, the sequential mLSTM
recurrence) and the CNN and update oracles.
"""
from __future__ import annotations

import torch.nn.functional as F

from repro_torch.kernels.batched_conv import same_geometry
from repro_torch.kernels.clip_sgd import clip_sgd_plain as clip_sgd_ref  # noqa: F401
from repro_torch.kernels.clip_sgd import clip_sgd_ext_plain as clip_sgd_ext_ref  # noqa: F401
# the sequential mLSTM recurrence and the layer's RMSNorm
from repro_torch.kernels.mlstm_scan import mlstm_scan_plain as mlstm_scan_ref  # noqa: F401
from repro_torch.kernels.rmsnorm import rmsnorm_plain as rmsnorm_ref  # noqa: F401


def batched_conv_ref(x, w, b, *, stride: int = 1):
    """Per-client stacked SAME conv as one grouped ``F.conv2d``.

    x: [N, B, H, W, Cin]; w: [N, kh, kw, Cin, Cout]; b: [N, Cout].  The
    client axis becomes the conv's group axis; SAME padding is applied
    explicitly with ``lo = pad // 2`` (the reference's ``lax.conv``
    geometry), since ``F.conv2d``'s symmetric padding differs on stride 2.
    """
    n, bsz, h, wd, cin = x.shape
    kh, kw, cout = w.shape[1], w.shape[2], w.shape[4]
    ho, wo, plo_h, phi_h, plo_w, phi_w = same_geometry(h, wd, kh, kw, stride)
    xg = x.permute(1, 0, 4, 2, 3).reshape(bsz, n * cin, h, wd)
    xg = F.pad(xg, (plo_w, phi_w, plo_h, phi_h))
    wg = w.permute(0, 4, 3, 1, 2).reshape(n * cout, cin, kh, kw)
    y = F.conv2d(xg, wg, stride=stride, groups=n)
    y = y.reshape(bsz, n, cout, ho, wo).permute(1, 0, 3, 4, 2)
    return y + b[:, None, None, None, :]


def flash_attention_ref(q, k, v, *, causal: bool = True, window: int = 0):
    """q: [B, Sq, Hq, hd]; k, v: [B, Sk, Hkv, hd] -> [B, Sq, Hq, hd]."""
    from repro_torch.models.attention import naive_attention
    return naive_attention(q, k, v, causal=causal, window=window)
