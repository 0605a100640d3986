"""Image quality metrics, channel-first ([C, H, W] or [N, C, H, W])
(port of gsvc_tpu/metrics/image.py).

PSNR matches utils/metric_utils.py:11-14; SSIM the 11x11 gaussian-window
implementation of utils/loss_utils.py:28-72; MS-SSIM the 5-scale
pytorch_msssim algorithm.  Blurs are separable shift-and-add passes in
float32 — no convolution, so no TF32 rounding on the card.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

_MS_WEIGHTS = (0.0448, 0.2856, 0.3001, 0.2363, 0.1333)


def psnr(img1, img2, data_range: float = 1.0):
    err = torch.mean((img1 - img2) ** 2)
    return 10.0 * torch.log10((data_range ** 2) / err)


def _gaussian_1d(window_size: int, sigma: float) -> np.ndarray:
    x = np.arange(window_size) - window_size // 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return (g / g.sum()).astype(np.float32)


def _ensure_nchw(img):
    return img[None] if img.dim() == 3 else img


def _blur1d(x, g, dim: int, pad: bool):
    """1D gaussian blur along ``dim`` (3 = W, 2 = H): SAME with zero
    padding, or VALID."""
    k = g.shape[0]
    if pad:
        half = k // 2
        x = F.pad(x, (half, half) if dim == 3 else (0, 0, half, half))
    n = x.shape[dim] - k + 1
    out = None
    for i in range(k):
        term = float(g[i]) * x.narrow(dim, i, n)
        out = term if out is None else out + term
    return out


def _blur(img, window_size, sigma, pad: bool):
    g = _gaussian_1d(window_size, sigma)
    return _blur1d(_blur1d(img, g, 3, pad), g, 2, pad)


def _ssim_maps(img1, img2, window_size, sigma, pad, c1=0.01 ** 2,
               c2=0.03 ** 2):
    mu1 = _blur(img1, window_size, sigma, pad)
    mu2 = _blur(img2, window_size, sigma, pad)
    mu1_sq, mu2_sq, mu1_mu2 = mu1 * mu1, mu2 * mu2, mu1 * mu2
    s1 = _blur(img1 * img1, window_size, sigma, pad) - mu1_sq
    s2 = _blur(img2 * img2, window_size, sigma, pad) - mu2_sq
    s12 = _blur(img1 * img2, window_size, sigma, pad) - mu1_mu2
    cs_map = (2 * s12 + c2) / (s1 + s2 + c2)
    return (2 * mu1_mu2 + c1) / (mu1_sq + mu2_sq + c1) * cs_map, cs_map


def ssim(img1, img2, window_size: int = 11, sigma: float = 1.5):
    ssim_map, _ = _ssim_maps(_ensure_nchw(img1), _ensure_nchw(img2),
                             window_size, sigma, pad=True)
    return torch.mean(ssim_map)


def _avg_pool2_padded(img):
    """2x2/stride-2 average pool, odd sides zero-padded and the pad
    counted in the divisor (pytorch_msssim's downsampling)."""
    ph, pw = img.shape[2] % 2, img.shape[3] % 2
    return F.avg_pool2d(img, 2, padding=(ph, pw), count_include_pad=True)


def ms_ssim(img1, img2, window_size: int = 11, sigma: float = 1.5):
    """5-scale MS-SSIM (VALID gaussian filtering, relu-clamped cs,
    odd-padded average pooling).  Inputs >= 176 px per side."""
    img1, img2 = _ensure_nchw(img1), _ensure_nchw(img2)
    mcs = []
    for i in range(len(_MS_WEIGHTS)):
        ssim_map, cs_map = _ssim_maps(img1, img2, window_size, sigma,
                                      pad=False)
        if i < len(_MS_WEIGHTS) - 1:
            mcs.append(torch.clamp(torch.mean(cs_map), min=0.0))
            img1 = _avg_pool2_padded(img1)
            img2 = _avg_pool2_padded(img2)
    result = torch.clamp(torch.mean(ssim_map), min=0.0) ** _MS_WEIGHTS[-1]
    for w, cs in zip(_MS_WEIGHTS[:-1], mcs):
        result = result * cs ** w
    return result
