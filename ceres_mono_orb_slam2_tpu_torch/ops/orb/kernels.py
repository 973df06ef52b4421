"""ORB front-end kernels: pyramid, FAST-9/16 score map, NMS, blur, patches.

Port of `ceres_mono_orb_slam2_tpu/ops/orb/kernels.py`. Each of the JAX
package's two Pallas kernels has a wrapper here that launches a hand-written
CUDA kernel (`csrc/fast_nms.cu`, `csrc/gather_patches.cu`) on a CUDA tensor
and runs the plain PyTorch version on a CPU tensor:

  - `fast_nms_pyramid`        <- `fast_nms_pallas`
        plain: `fast_nms_pyramid_plain` (nms3(fast_score_map) per level)
  - `gather_pyramid_patches`  <- `gather_patches_pallas`
        plain: `gather_pyramid_patches_plain` (gather_patches_plain per level)

Both kernels take a whole packed pyramid (`PyramidLayout`) and run once per
frame batch. The one-level `fast_nms(img)` and `gather_patches(img, ys, xs,
r)` are one-level calls of the same kernels. Each wrapper counts its kernel
launches in `launch_counts`.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ceres_mono_orb_slam2_tpu_torch.utils import cuda_build

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

MAX_LEVELS = 16  # size of the kernels' level tables (csrc/*.cu)

# kernel launches per wrapper; only the wrappers below increment these
launch_counts = {"fast_nms": 0, "gather_patches": 0}


def reset_launch_counts():
    for k in launch_counts:
        launch_counts[k] = 0


class PyramidLayout(NamedTuple):
    """Where the levels of a packed pyramid lie in its (B, total) float32
    buffer: level l is the (H_l, W_l) block at `offsets[l]` of each row,
    with row pitch W_l. An unpadded pitch keeps every level a contiguous
    (H_l, W_l) plane, so the eager per-level ops (resize, blur, keypoint
    selection) run on plain views; the KITTI widths are not multiples of 4,
    so a 16-byte pitch would make those views strided for no kernel gain
    (both kernels stage or gather single values)."""

    shapes: tuple  # ((H_0, W_0), (H_1, W_1), ...)
    offsets: tuple
    total: int

    @classmethod
    def of(cls, shapes: Sequence[tuple[int, int]]) -> "PyramidLayout":
        shapes = tuple((int(h), int(w)) for h, w in shapes)
        sizes = [h * w for h, w in shapes]
        offsets = tuple(int(o) for o in np.cumsum([0] + sizes[:-1]))
        return cls(shapes, offsets, int(sum(sizes)))

    def views(self, buf: torch.Tensor) -> list:
        """The (B, H_l, W_l) level views of a (B, total) buffer."""
        return [buf[:, o:o + h * w].view(buf.shape[0], h, w)
                for o, (h, w) in zip(self.offsets, self.shapes)]


@functools.lru_cache(maxsize=64)
def _level_table(layout: PyramidLayout) -> np.ndarray:
    """(offset, H, W) per level, flat int32: the kernels' level table."""
    return np.array([(o, h, w) for o, (h, w) in zip(layout.offsets, layout.shapes)],
                    np.int32).reshape(-1)


@functools.lru_cache(maxsize=64)
def _int32_array(values: tuple) -> np.ndarray:
    return np.array(values, np.int32)


def _check_pyramid(name: str, pyr: torch.Tensor, layout: PyramidLayout):
    """Raise unless pyr is a (B, layout.total) float32 buffer that the
    wrapper can hand to its kernel (CUDA, current device) or plain version."""
    if pyr.dtype != torch.float32 or pyr.dim() != 2 or pyr.shape[1] != layout.total:
        raise ValueError(f"{name}: need a (B, {layout.total}) float32 pyramid, got "
                         f"{pyr.dtype} {tuple(pyr.shape)}")
    if not 1 <= len(layout.shapes) <= MAX_LEVELS:
        raise ValueError(f"{name}: 1 to {MAX_LEVELS} levels, got {len(layout.shapes)}")
    if pyr.device.type == "cpu":
        return
    if pyr.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {pyr.device}")
    if not pyr.is_contiguous() or pyr.get_device() != torch.cuda.current_device():
        raise ValueError(f"{name}: the pyramid must be contiguous on the current CUDA device")


def _raise_on_launch_error(name: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")


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


def zero_margin(score: torch.Tensor, edge: int) -> torch.Tensor:
    """score (..., H, W) with every pixel less than `edge` px from the
    border set to 0 (the keypoint margin EDGE; edge=0 leaves it as it is)."""
    if edge <= 0:
        return score
    H, W = score.shape[-2:]
    ry = torch.arange(H, device=score.device)
    rx = torch.arange(W, device=score.device)
    inner = (((ry >= edge) & (ry < H - edge))[:, None]
             & ((rx >= edge) & (rx < W - edge))[None, :])
    return torch.where(inner, score, torch.zeros_like(score))


def fast_nms_pyramid_plain(pyr: torch.Tensor, layout: PyramidLayout,
                           edge: int = 0) -> torch.Tensor:
    """Plain version of `fast_nms_pyramid`: per level,
    zero_margin(nms3(fast_score_map(level)), edge)."""
    out = torch.empty_like(pyr)
    for src, dst in zip(layout.views(pyr), layout.views(out)):
        dst.copy_(zero_margin(nms3(fast_score_map(src)), edge))
    return out


def fast_nms_pyramid(pyr: torch.Tensor, layout: PyramidLayout, edge: int = 0) -> torch.Tensor:
    """FAST score + 3x3 NMS of every level of a packed pyramid, each level's
    `edge`-px margin zeroed: (B, total) float32 -> (B, total) float32.

    CPU tensor: `fast_nms_pyramid_plain`. CUDA tensor: one launch of the
    `csrc/fast_nms.cu` kernel for all levels and frames (bit-exact to the
    plain version)."""
    _check_pyramid("fast_nms", pyr, layout)
    if pyr.device.type == "cpu":
        return fast_nms_pyramid_plain(pyr, layout, edge)
    out = torch.empty_like(pyr)
    if out.numel() == 0:
        return out
    rc = cuda_build.load().fast_nms_launch(
        pyr.data_ptr(), out.data_ptr(), pyr.shape[0], layout.total,
        _level_table(layout).ctypes.data, len(layout.shapes), int(edge),
        torch.cuda.current_stream().cuda_stream)
    _raise_on_launch_error("fast_nms", rc)
    launch_counts["fast_nms"] += 1
    return out


def fast_nms(img: torch.Tensor) -> torch.Tensor:
    """Fused FAST score + 3x3 NMS of one image plane: (B, H, W) float32 ->
    (B, H, W) float32, the one-level call of `fast_nms_pyramid` (plain:
    nms3(fast_score_map(img)))."""
    if img.dim() != 3:
        raise ValueError(f"fast_nms: need (B, H, W), got {tuple(img.shape)}")
    B, H, W = img.shape
    layout = PyramidLayout.of([(H, W)])
    return fast_nms_pyramid(img.reshape(B, H * W), layout).view(B, H, W)


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


def to_u8(patches: torch.Tensor) -> torch.Tensor:
    """The 8-bit value rBRIEF compares: round half up, clamp to [0, 255]."""
    return (patches + 0.5).clamp(0.0, 255.0).to(torch.uint8)


def gather_pyramid_patches_plain(raw: torch.Tensor, blurred: torch.Tensor, layout: PyramidLayout,
                                 ys: torch.Tensor, xs: torch.Tensor, counts: Sequence[int]):
    """Plain version of `gather_pyramid_patches`: per level, the
    `gather_patches_plain` of its keypoints at radius HALF_PATCH from the
    raw pyramid and at radius DESC_R from the blurred one (to_u8)."""
    p31, p39 = [], []
    start = 0
    for raw_l, blur_l, n in zip(layout.views(raw), layout.views(blurred), counts):
        y, x = ys[:, start:start + n], xs[:, start:start + n]
        p31.append(gather_patches_plain(raw_l, y, x, HALF_PATCH))
        p39.append(to_u8(gather_patches_plain(blur_l, y, x, DESC_R)))
        start += n
    return torch.cat(p31, 1), torch.cat(p39, 1)


def _check_keypoints(name: str, ys: torch.Tensor, xs: torch.Tensor, like: torch.Tensor):
    for a in (ys, xs):
        if (a.dtype != torch.int32 or a.dim() != 2 or a.shape != ys.shape
                or a.shape[0] != like.shape[0] or a.device != like.device
                or not a.is_contiguous()):
            raise ValueError(f"{name}: ys/xs must be contiguous (B, n) int32 on {like.device}, "
                             f"got {a.dtype} {tuple(a.shape)} on {a.device}")


def _launch_gather(sets, layout: PyramidLayout, ys: torch.Tensor, xs: torch.Tensor,
                   counts: Sequence[int]):
    """One launch of the gather kernel; sets: (source pyramid, output,
    radius) for one or two patch sets (uint8 outputs get to_u8 values)."""
    (s0, *rest) = sets
    s1 = rest[0] if rest else s0
    B, n = ys.shape
    rc = cuda_build.load().gather_patches_launch(
        s0[0].data_ptr(), s0[1].data_ptr(), s0[2], int(s0[1].dtype == torch.uint8),
        s1[0].data_ptr(), s1[1].data_ptr(), s1[2], int(s1[1].dtype == torch.uint8),
        len(sets), ys.data_ptr(), xs.data_ptr(), B, n, layout.total,
        _level_table(layout).ctypes.data, _int32_array(tuple(counts)).ctypes.data,
        len(layout.shapes), torch.cuda.current_stream().cuda_stream)
    _raise_on_launch_error("gather_patches", rc)
    launch_counts["gather_patches"] += 1


def gather_pyramid_patches(raw: torch.Tensor, blurred: torch.Tensor, layout: PyramidLayout,
                           ys: torch.Tensor, xs: torch.Tensor, counts: Sequence[int]):
    """Both patch sets of a frame batch's keypoints in one call.

    raw, blurred: (B, total) float32 packed pyramids of one layout; ys, xs:
    (B, N) int32 level-local centres in level-major order, counts[l] of them
    at level l (sum(counts) = N). Returns the (B, N, 31, 31) float32 raw
    patches (values rounded through bf16, for the IC angle) and the
    (B, N, 39, 39) uint8 blurred patches (to_u8 of the bf16-rounded values,
    for rBRIEF); coordinates are clamped to each level.

    CPU tensors: `gather_pyramid_patches_plain`. CUDA tensors: one launch of
    the `csrc/gather_patches.cu` kernel (bit-exact to the plain version)."""
    _check_pyramid("gather_patches", raw, layout)
    _check_pyramid("gather_patches", blurred, layout)
    _check_keypoints("gather_patches", ys, xs, raw)
    if blurred.shape != raw.shape or blurred.device != raw.device:
        raise ValueError("gather_patches: raw and blurred pyramids differ in shape or device")
    counts = tuple(int(c) for c in counts)
    if len(counts) != len(layout.shapes) or sum(counts) != ys.shape[1]:
        raise ValueError(f"gather_patches: counts {counts} do not split {ys.shape[1]} keypoints "
                         f"over {len(layout.shapes)} levels")
    if raw.device.type == "cpu":
        return gather_pyramid_patches_plain(raw, blurred, layout, ys, xs, counts)
    B, n = ys.shape
    s31, s39 = 2 * HALF_PATCH + 1, 2 * DESC_R + 1
    p31 = torch.empty((B, n, s31, s31), dtype=torch.float32, device=raw.device)
    p39 = torch.empty((B, n, s39, s39), dtype=torch.uint8, device=raw.device)
    if B * n:
        _launch_gather([(raw, p31, HALF_PATCH), (blurred, p39, DESC_R)], layout, ys, xs, counts)
    return p31, p39


def gather_patches(img: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                   radius: int) -> torch.Tensor:
    """(2r+1)^2 patches around integer centres: img (B, H, W) float32, ys/xs
    (B, n) int32 -> (B, n, S, S) float32, values rounded through bf16.

    The one-level, one-set call of the `gather_pyramid_patches` kernel.
    CPU tensor: `gather_patches_plain`."""
    if img.dim() != 3:
        raise ValueError(f"gather_patches: need a (B, H, W) image, got {tuple(img.shape)}")
    B, H, W = img.shape
    layout = PyramidLayout.of([(H, W)])
    pyr = img.reshape(B, H * W)
    _check_pyramid("gather_patches", pyr, layout)
    _check_keypoints("gather_patches", ys, xs, img)
    if img.device.type == "cpu":
        return gather_patches_plain(img, ys, xs, radius)
    n = ys.shape[1]
    S = 2 * radius + 1
    out = torch.empty((B, n, S, S), dtype=torch.float32, device=img.device)
    if out.numel():
        _launch_gather([(pyr, out, int(radius))], layout, ys, xs, (n,))
    return out
