"""LPIPS perceptual metric on a VGG16 backbone (port of
gsvc_tpu/metrics/lpips.py: ``proxy_lpips_weights``,
``load_lpips_weights``, ``lpips``).

Weights are a dict of tensors under the exporter's keys
(scripts/export_lpips_weights.py): ``features.{i}.weight`` [out, in, 3, 3]
and ``features.{i}.bias`` for the VGG16 convolutions, ``lin{k}.weight``
[1, C, 1, 1] for the five linear heads.  No pretrained weights ship with
the repo: ``load_lpips_weights`` reads an exported npz, or gives the
deterministic reduced-width proxy for the path ``"proxy"``.

The convolutions are ``F.conv2d`` (padding 1: the JAX package's "SAME"
for 3x3) and the pooling ``F.max_pool2d(2, 2)`` (floor: "VALID").  They
run in float32 on every device: cuDNN's TF32 switch is turned off inside
``lpips`` only, and the process-wide flag is left as the caller set it.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

# VGG16 feature config (torchvision): conv indices and slice boundaries
_VGG_CONVS = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
_SLICES = [2, 4, 7, 10, 13]      # convs per LPIPS slice (cumulative idx)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

_PROXY_CHANNELS = (16, 16, 32, 32, 64, 64, 64, 128, 128, 128,
                   128, 128, 128)   # VGG16 widths / 4


def proxy_lpips_weights(seed: int = 0,
                        device="cpu") -> Dict[str, torch.Tensor]:
    """Deterministic reduced-width (VGG16/4) random-feature LPIPS weights:
    He-initialised convolutions and uniform positive linear heads drawn
    from numpy's PCG64 in the JAX package's order (every convolution, then
    the heads), so a seed gives its weights bit for bit.  Values are
    labelled ``lpips_kind: proxy-vgg16w4`` and do not compare with
    published (pretrained-VGG) LPIPS."""
    rng = np.random.default_rng(seed)
    out: Dict[str, torch.Tensor] = {}
    in_ch = 3
    for ci, conv_idx in enumerate(_VGG_CONVS):
        oc = _PROXY_CHANNELS[ci]
        fan_in = in_ch * 9
        w = rng.normal(0.0, np.sqrt(2.0 / fan_in),
                       (oc, in_ch, 3, 3)).astype(np.float32)
        out[f"features.{conv_idx}.weight"] = torch.from_numpy(w).to(device)
        out[f"features.{conv_idx}.bias"] = torch.zeros(
            oc, dtype=torch.float32, device=device)
        in_ch = oc
    for k, upto in enumerate(_SLICES):
        c = _PROXY_CHANNELS[upto - 1]
        lin = rng.uniform(0.5, 1.5, (1, c, 1, 1)).astype(np.float32) / c
        out[f"lin{k}.weight"] = torch.from_numpy(lin).to(device)
    return out


def load_lpips_weights(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    """Weights from an exported npz, or the proxy for ``path == "proxy"``."""
    if path == "proxy":
        return proxy_lpips_weights(device=device)
    data = np.load(path)
    return {k: torch.from_numpy(np.array(data[k])).to(device)
            for k in data.files}


def _vgg_slices(weights, x):
    """The five slice outputs of the VGG16 trunk on NCHW ``x``."""
    feats = []
    ci = 0
    for s, upto in enumerate(_SLICES):
        while ci < upto:
            conv_idx = _VGG_CONVS[ci]
            x = F.relu(F.conv2d(x, weights[f"features.{conv_idx}.weight"],
                                weights[f"features.{conv_idx}.bias"],
                                padding=1))
            ci += 1
        feats.append(x)
        if s < len(_SLICES) - 1:
            x = F.max_pool2d(x, 2, 2)
    return feats


def lpips(weights: Optional[Dict], img1, img2) -> torch.Tensor:
    """LPIPS distance (a 0-dim tensor) between [H, W, 3] images in [0, 1]
    (numpy arrays or tensors), on the device of the weights.

    Raises without weights: none ship with the repo."""
    if weights is None:
        raise RuntimeError(
            "LPIPS needs pretrained VGG16+linear weights; none are "
            "available in this environment. Export them once with "
            "scripts from the lpips project and pass the npz path.")
    dev = weights["lin0.weight"].device
    shift = torch.from_numpy(_SHIFT).to(dev)
    scale = torch.from_numpy(_SCALE).to(dev)

    def prep(im):
        im = torch.as_tensor(im, dtype=torch.float32, device=dev)
        im = (im[None] * 2.0 - 1.0 - shift) / scale      # HWC, as JAX
        return im.permute(0, 3, 1, 2).contiguous()

    cudnn = torch.backends.cudnn
    with torch.no_grad(), cudnn.flags(
            enabled=cudnn.enabled, benchmark=cudnn.benchmark,
            deterministic=cudnn.deterministic, allow_tf32=False):
        f1 = _vgg_slices(weights, prep(img1))
        f2 = _vgg_slices(weights, prep(img2))
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for k, (a, b) in enumerate(zip(f1, f2)):
            a = a / a.norm(dim=1, keepdim=True).clamp_min(1e-10)
            b = b / b.norm(dim=1, keepdim=True).clamp_min(1e-10)
            d = (a - b) ** 2
            total = total + (d * weights[f"lin{k}.weight"]).sum(1).mean()
    return total
