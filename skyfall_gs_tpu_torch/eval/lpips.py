"""LPIPS perceptual distance as a frozen PyTorch module (weight-gated).

Port of ``skyfall_gs_tpu/eval/lpips.py`` (the reference's vendored
``lpipsPyTorch`` AlexNet / VGG16 backbones with the learned linear heads):
run both images through a frozen torchvision-layout feature stack,
channel-normalize each tap's activations, weight the squared differences
with the 1x1 "lin" heads, average over space and sum over the taps.

The weights are pretrained artifacts and nothing is downloaded, so
construction takes local state dicts (numpy arrays or tensors, the dicts
the JAX class takes):
  * ``backbone_state``: torchvision ``alexnet().features`` /
    ``vgg16().features`` keys (``"0.weight"``, ``"0.bias"``, ...);
  * ``lin_state``: the lpips v0.1 heads (``lin{i}.model.1.weight``).
``lpips_from_torch_files`` loads both from disk.  The convolutions run
NCHW through ``F.conv2d`` (cuDNN on the card).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

# torchvision feature-stack layouts: the conv indices of each tap block.
_ALEX_TAPS = ((0,), (3,), (6,), (8,), (10,))
_VGG_TAPS = ((0, 2), (5, 7), (10, 12, 14), (17, 19, 21), (24, 26, 28))
_ALEX_META = {  # layer index -> (stride, padding)
    0: (4, 2), 3: (1, 2), 6: (1, 1), 8: (1, 1), 10: (1, 1),
}

_SHIFT = (-0.030, -0.088, -0.188)
_SCALE = (0.458, 0.448, 0.450)


def _tensor(x) -> torch.Tensor:
    """A numpy array or tensor as a float32 CPU tensor of its own."""
    return torch.as_tensor(x, dtype=torch.float32).detach().cpu().clone()


class LPIPS(nn.Module):
    """LPIPS scorer over torchvision-layout backbone and lpips head weights.

    ``score(a, b)`` maps two (B, H, W, 3) tensors in [-1, 1] to the (B,)
    distances and keeps autograd to its inputs (the weights are buffers,
    never trained); calling the module on two (H, W, 3) images in [0, 1]
    returns the distance as a float.
    """

    def __init__(self, net: str = "alex", backbone_state: Optional[Dict] = None,
                 lin_state: Optional[Dict] = None, device="cuda"):
        super().__init__()
        if backbone_state is None or lin_state is None:
            raise RuntimeError(
                "LPIPS requires pretrained backbone + linear-head weights; none are "
                "available locally (no download). Provide backbone_state/lin_state "
                "state dicts or use lpips_from_torch_files(...).")
        if net not in ("alex", "vgg"):
            raise ValueError(f"net must be 'alex' or 'vgg', got {net!r}")
        self.net = net
        self.taps = _ALEX_TAPS if net == "alex" else _VGG_TAPS
        for block in self.taps:
            for i in block:
                self.register_buffer(f"w{i}", _tensor(backbone_state[f"{i}.weight"]))
                self.register_buffer(f"b{i}", _tensor(backbone_state[f"{i}.bias"]))
        for t in range(len(self.taps)):
            self.register_buffer(f"lin{t}", _tensor(lin_state[f"lin{t}.model.1.weight"]))
        self.register_buffer("shift", torch.tensor(_SHIFT).view(1, 3, 1, 1))
        self.register_buffer("scale", torch.tensor(_SCALE).view(1, 3, 1, 1))
        self.to(device)

    @property
    def device(self) -> torch.device:
        return self.shift.device

    def features(self, x: torch.Tensor):
        """(B, 3, H, W) in [-1, 1] -> the five tap activations (NCHW)."""
        h = (x - self.shift) / self.scale
        feats = []
        for bi, block in enumerate(self.taps):
            for li, i in enumerate(block):
                if self.net == "alex":
                    stride, pad = _ALEX_META[i]
                    # torchvision's alexnet pools only after blocks 0 and 1
                    if bi in (1, 2) and li == 0:
                        h = F.max_pool2d(h, 3, 2)
                else:
                    stride, pad = 1, 1
                    if bi > 0 and li == 0:
                        h = F.max_pool2d(h, 2, 2)
                h = F.relu(F.conv2d(h, getattr(self, f"w{i}"), getattr(self, f"b{i}"),
                                    stride, pad))
            feats.append(h)
        return feats

    def score(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) images in [-1, 1] -> (B,) LPIPS distances."""
        fa = self.features(a.permute(0, 3, 1, 2))
        fb = self.features(b.permute(0, 3, 1, 2))
        total = 0.0
        for t, (xa, xb) in enumerate(zip(fa, fb)):
            na = xa / (torch.linalg.vector_norm(xa, dim=1, keepdim=True) + 1e-10)
            nb = xb / (torch.linalg.vector_norm(xb, dim=1, keepdim=True) + 1e-10)
            d = F.conv2d((na - nb) ** 2, getattr(self, f"lin{t}"))
            total = total + d.mean(dim=(1, 2, 3))
        return total

    @torch.no_grad()
    def forward(self, img0, img1) -> float:
        """(H, W, 3) images in [0, 1] (arrays or tensors) -> LPIPS distance."""
        a = torch.as_tensor(img0, dtype=torch.float32, device=self.device)[None]
        b = torch.as_tensor(img1, dtype=torch.float32, device=self.device)[None]
        return float(self.score(a * 2.0 - 1.0, b * 2.0 - 1.0)[0])


def lpips_from_torch_files(backbone_path: str, lin_path: str, net: str = "alex",
                           device="cuda") -> LPIPS:
    """An ``LPIPS`` from a torchvision features state dict and an lpips
    head state dict saved with ``torch.save``."""
    backbone = torch.load(backbone_path, map_location="cpu", weights_only=True)
    lin = torch.load(lin_path, map_location="cpu", weights_only=True)
    return LPIPS(net=net, backbone_state=backbone, lin_state=lin, device=device)


def lpips_from_local_packages(net: str = "alex", device="cuda") -> LPIPS:
    """Build from the torchvision weights in torch hub's cache and the
    heads shipped inside the ``lpips`` package, where both exist on this
    machine; raises ``RuntimeError`` otherwise.  Nothing is downloaded:
    the backbone is read from the cache file, never through torchvision's
    downloader."""
    try:
        import torchvision.models as tvm

        weights = (tvm.AlexNet_Weights if net == "alex" else tvm.VGG16_Weights).IMAGENET1K_V1
        cached = os.path.join(torch.hub.get_dir(), "checkpoints",
                              os.path.basename(weights.url))
        sd = torch.load(cached, map_location="cpu", weights_only=True)
        backbone = {k[len("features."):]: v for k, v in sd.items()
                    if k.startswith("features.")}
    except (ImportError, OSError) as e:
        raise RuntimeError(f"torchvision backbone unavailable locally: {e}") from e
    try:
        import lpips as lpips_pkg

        base = os.path.join(os.path.dirname(lpips_pkg.__file__), "weights", "v0.1",
                            f"{net}.pth")
        lin = torch.load(base, map_location="cpu", weights_only=True)
    except (ImportError, OSError) as e:
        raise RuntimeError(f"lpips linear heads unavailable locally: {e}") from e
    return LPIPS(net=net, backbone_state=backbone, lin_state=lin, device=device)
