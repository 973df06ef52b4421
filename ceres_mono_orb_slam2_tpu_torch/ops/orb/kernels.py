"""ORB front-end kernels: pyramid, FAST-9/16 score map, NMS, blur, patches.

Port of `ceres_mono_orb_slam2_tpu/ops/orb/kernels.py`. Each of the JAX
package's two Pallas kernels has a wrapper here that launches a hand-written
CUDA kernel (`csrc/fast_nms.cu`, `csrc/gather_patches.cu`) on a CUDA tensor
and runs the plain PyTorch version on a CPU tensor:

  - `fast_nms`       <- `fast_nms_pallas`      (plain: nms3(fast_score_map))
  - `gather_patches` <- `gather_patches_pallas` (plain: gather_patches_plain)

Each wrapper counts its kernel launches in `launch_counts`.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle of radius 3 used by FAST-9/16, in (dy, dx), clockwise
# starting straight up (the circle OpenCV's FAST uses).
FAST_CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

HALF_PATCH = 15  # IC-angle circular patch radius
EDGE = 19  # keypoint border margin (EDGE_THRESHOLD)
DESC_R = 19  # descriptor sample max radius after rotation (ceil(13*sqrt(2)))

# kernel launches per wrapper; only the wrappers below increment these
launch_counts = {"fast_nms": 0, "gather_patches": 0}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


def _as_planes(img: torch.Tensor):
    """(..., H, W) -> ((P, H, W) view, leading shape)."""
    lead = img.shape[:-2]
    return img.reshape((-1,) + img.shape[-2:]), lead


def fast_score_map(img: torch.Tensor) -> torch.Tensor:
    """Dense FAST-9/16 max-threshold corner score of every pixel.

    img: (..., H, W) float32 in [0, 255], edge-padded. Thresholding the map
    at iniThFAST/minThFAST reproduces the two-threshold FAST scheme.
    """
    planes, lead = _as_planes(img)
    H, W = planes.shape[-2:]
    pad = 3
    padded = F.pad(planes[:, None], (pad, pad, pad, pad), mode="replicate")[:, 0]
    d = torch.stack([padded[:, pad + dy:pad + dy + H, pad + dx:pad + dx + W]
                     for dy, dx in FAST_CIRCLE.tolist()]) - planes[None]
    d2 = torch.cat([d, d[:8]], dim=0)  # wraparound (24, P, H, W)

    def arc_min(x):
        m = x[0:16]
        for i in range(1, 9):
            m = torch.minimum(m, x[i:i + 16])
        return m

    score = torch.maximum(arc_min(d2).amax(0), arc_min(-d2).amax(0))
    return score.clamp_min(0.0).reshape(lead + (H, W))


def nms3(score: torch.Tensor) -> torch.Tensor:
    """3x3 non-max suppression with plateau tie-break (zero padded): a pixel
    survives if it is > its 4 raster-preceding neighbours and >= its 4
    following ones, so a constant plateau keeps exactly one pixel."""
    planes, lead = _as_planes(score)
    H, W = planes.shape[-2:]
    p = F.pad(planes, (1, 1, 1, 1))

    def shift(dy, dx):
        return p[:, 1 + dy:1 + dy + H, 1 + dx:1 + dx + W]

    before = [(-1, -1), (-1, 0), (-1, 1), (0, -1)]
    after = [(0, 1), (1, -1), (1, 0), (1, 1)]
    mb = shift(*before[0])
    for dy, dx in before[1:]:
        mb = torch.maximum(mb, shift(dy, dx))
    ma = shift(*after[0])
    for dy, dx in after[1:]:
        ma = torch.maximum(ma, shift(dy, dx))
    keep = (planes > mb) & (planes >= ma)
    return torch.where(keep, planes, torch.zeros_like(planes)).reshape(lead + (H, W))


def fast_nms(img: torch.Tensor) -> torch.Tensor:
    """Fused FAST score + 3x3 NMS: (B, H, W) float32 -> (B, H, W) float32.

    CPU tensor: the plain `nms3(fast_score_map(img))`. CUDA tensor: the
    `csrc/fast_nms.cu` kernel (bit-exact to the plain version)."""
    if img.device.type == "cpu":
        return nms3(fast_score_map(img))
    if img.device.type != "cuda":
        raise ValueError(f"fast_nms: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.dim() != 3 or not img.is_contiguous():
        raise ValueError(f"fast_nms: need contiguous (B, H, W) float32, got "
                         f"{img.dtype} {tuple(img.shape)}")
    from ceres_mono_orb_slam2_tpu_torch.utils import cuda_build

    lib = cuda_build.load()
    B, H, W = img.shape
    out = torch.empty_like(img)
    if out.numel() == 0:
        return out
    with torch.cuda.device(img.device):
        rc = lib.fast_nms_launch(img.data_ptr(), out.data_ptr(), B, H, W,
                                 torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"fast_nms kernel launch failed: cudaError {rc}")
    launch_counts["fast_nms"] += 1
    return out


def gaussian_blur7(img: torch.Tensor, sigma: float = 2.0) -> torch.Tensor:
    """Separable 7x7 Gaussian blur, edge padded (GaussianBlur(7,7,2,2))."""
    r = 3
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x ** 2) / (2 * sigma ** 2))
    k /= k.sum()
    k32 = [float(np.float32(v)) for v in k]
    planes, lead = _as_planes(img)
    H, W = planes.shape[-2:]
    p = F.pad(planes[:, None], (r, r, r, r), mode="replicate")[:, 0]
    v = None
    for i in range(2 * r + 1):
        term = p[:, i:i + H, :] * k32[i]
        v = term if v is None else v + term
    out = None
    for i in range(2 * r + 1):
        term = v[:, :, i:i + W] * k32[i]
        out = term if out is None else out + term
    return out.reshape(lead + (H, W))


def resize_bilinear(img: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Antialiased bilinear resize (pyramid construction). Matches
    `jax.image.resize(..., "linear")`, which antialiases when downsampling,
    to within ~1e-2; a resize without antialiasing differs by up to ~80."""
    planes, lead = _as_planes(img)
    out = F.interpolate(planes[:, None], size=(out_h, out_w), mode="bilinear",
                        align_corners=False, antialias=True)[:, 0]
    return out.reshape(lead + (out_h, out_w))


def ic_angle_mask() -> tuple[np.ndarray, np.ndarray]:
    """(31, 31) x/y moment masks over the circular IC-angle patch (the
    reference's u_max table with its symmetry fix-up)."""
    hp = HALF_PATCH
    umax = np.zeros(hp + 2, dtype=np.int32)
    vmax = int(np.floor(hp * np.sqrt(2.0) / 2 + 1))
    vmin = int(np.ceil(hp * np.sqrt(2.0) / 2))
    for v in range(vmax + 1):
        umax[v] = int(round(np.sqrt(hp * hp - v * v)))
    v0 = 0
    for v in range(hp, vmin - 1, -1):
        while umax[v0] == umax[v0 + 1]:
            v0 += 1
        umax[v] = v0
        v0 += 1
    ys, xs = np.mgrid[-hp: hp + 1, -hp: hp + 1]
    inc = np.abs(xs) <= umax[np.abs(ys)]
    return (xs * inc).astype(np.float32), (ys * inc).astype(np.float32)


def gather_patches_plain(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                         radius: int) -> torch.Tensor:
    """Plain version of `gather_patches`: img (B, H, W), ys/xs (B, n) ->
    (B, n, S, S) float32 of bf16-rounded pixels (coordinates clamped)."""
    B, H, W = img.shape
    off = torch.arange(-radius, radius + 1, device=img.device)
    rows = (ys.long()[..., None] + off).clamp(0, H - 1)  # (B, n, S)
    cols = (xs.long()[..., None] + off).clamp(0, W - 1)
    src = img.to(torch.bfloat16).float()
    bidx = torch.arange(B, device=img.device)[:, None, None, None]
    return src[bidx, rows[:, :, :, None], cols[:, :, None, :]]


def gather_patches(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                   radius: int) -> torch.Tensor:
    """(2r+1)^2 patches around integer centres: img (B, H, W) float32, ys/xs
    (B, n) int32 -> (B, n, S, S) float32, values rounded through bf16.

    CPU tensor: `gather_patches_plain`. CUDA tensor: the
    `csrc/gather_patches.cu` kernel (bit-exact to the plain version)."""
    if img.device.type == "cpu":
        return gather_patches_plain(img, ys, xs, radius)
    if img.device.type != "cuda":
        raise ValueError(f"gather_patches: unsupported device {img.device}")
    if img.dtype != torch.float32 or img.dim() != 3 or not img.is_contiguous():
        raise ValueError(f"gather_patches: need contiguous (B, H, W) float32 image, "
                         f"got {img.dtype} {tuple(img.shape)}")
    B, H, W = img.shape
    for name, a in (("ys", ys), ("xs", xs)):
        if (a.dtype != torch.int32 or a.shape != ys.shape or a.dim() != 2
                or a.shape[0] != B or not a.is_contiguous() or a.device != img.device):
            raise ValueError(f"gather_patches: {name} must be contiguous (B, n) int32 "
                             f"on {img.device}, got {a.dtype} {tuple(a.shape)}")
    from ceres_mono_orb_slam2_tpu_torch.utils import cuda_build

    lib = cuda_build.load()
    n = ys.shape[1]
    S = 2 * radius + 1
    out = torch.empty((B, n, S, S), dtype=torch.float32, device=img.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(img.device):
        rc = lib.gather_patches_launch(img.data_ptr(), ys.data_ptr(), xs.data_ptr(),
                                       out.data_ptr(), B, H, W, n, radius,
                                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"gather_patches kernel launch failed: cudaError {rc}")
    launch_counts["gather_patches"] += 1
    return out
