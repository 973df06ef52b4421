"""Port parity: the ORB kernels of ops/orb/kernels.py against the JAX
package, including both Pallas kernels run in interpret mode.

On the CPU the port's wrappers (`fast_nms_pyramid`, `gather_pyramid_patches`
and their one-level calls `fast_nms`, `gather_patches`) run their plain
versions; the CUDA kernels are held bit-exact to those on the GPU by
chip_smoke.py. The packed-pyramid cases use 4 levels whose widths are odd
and not multiples of 4, so no level starts or ends on a 16-byte boundary."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from ceres_mono_orb_slam2_tpu.ops.orb import extractor as jext, kernels as jk
from ceres_mono_orb_slam2_tpu_torch.ops.orb import extractor as text, kernels as tk

torch.set_num_threads(2)


def _image(rng, h, w, integer=True):
    img = rng.uniform(40, 90, (h, w))
    for _ in range(h * w // 250):
        y, x, s = rng.integers(0, h - 8), rng.integers(0, w - 8), rng.integers(3, 9)
        img[y:y + s, x:x + s] = rng.uniform(120, 250)
    img = np.clip(img + rng.normal(0, 3, (h, w)), 0, 255)
    return (np.round(img) if integer else img).astype(np.float32)


@pytest.mark.parametrize("integer", [True, False])
def test_fast_score_and_nms_bit_exact(rng, integer):
    # min/max/subtract of f32 values are exact: bit-exact on any input
    img = np.stack([_image(rng, 90, 150, integer), _image(rng, 90, 150, integer)])
    score_j = np.asarray(jk.fast_score_map(jnp.asarray(img)))
    score_t = tk.fast_score_map(torch.as_tensor(img)).numpy()
    np.testing.assert_array_equal(score_t, score_j)
    np.testing.assert_array_equal(tk.nms3(torch.as_tensor(score_t)).numpy(),
                                  np.asarray(jk.nms3(jnp.asarray(score_j))))
    fused_t = tk.fast_nms(torch.as_tensor(img)).numpy()
    np.testing.assert_array_equal(fused_t, np.asarray(jk.nms3(jnp.asarray(score_j))))
    # the Pallas kernel clamps its NMS border instead of zero padding; the
    # extractor's EDGE margin hides that, so compare pixels >= 4 px inside
    pallas = np.asarray(jk.fast_nms_pallas(jnp.asarray(img), interpret=True))
    inner = (slice(None), slice(4, -4), slice(4, -4))
    np.testing.assert_array_equal(fused_t[inner], pallas[inner])
    assert (fused_t[inner] > 0).sum() > 20


@pytest.mark.parametrize("radius", [15, 19])
def test_gather_patches_bit_exact(rng, radius):
    B, H, W, n = 2, 100, 280, 24
    img = rng.uniform(0, 255, (B, H, W)).astype(np.float32)  # non-integer: bf16 rounds
    ys = rng.integers(radius, H - radius, (B, n)).astype(np.int32)
    xs = rng.integers(radius, W - radius, (B, n)).astype(np.int32)
    ref = np.asarray(jax.vmap(lambda im, yy, xx: jk.gather_patches(im, yy, xx, radius))(
        jnp.asarray(img), jnp.asarray(ys), jnp.asarray(xs)))
    pallas = np.asarray(jk.gather_patches_pallas(jnp.asarray(img), jnp.asarray(ys),
                                                 jnp.asarray(xs), radius, kpb=8, interpret=True))
    new = tk.gather_patches(torch.as_tensor(img), torch.as_tensor(ys), torch.as_tensor(xs),
                            radius).numpy()
    np.testing.assert_array_equal(new, ref)
    np.testing.assert_array_equal(new, pallas)


def test_blur_and_resize(rng):
    img = np.stack([_image(rng, 120, 170, integer=False)])
    # the same f32 taps summed in the same order: within 1e-4 before rounding
    np.testing.assert_allclose(tk.gaussian_blur7(torch.as_tensor(img)).numpy(),
                               np.asarray(jk.gaussian_blur7(jnp.asarray(img))), rtol=0, atol=1e-4)
    # jax.image.resize "linear" and torch's antialiased bilinear compute the
    # same triangle-filter weights in different arithmetic: 1e-2 is the
    # measured worst case (a resize without antialiasing differs by ~80)
    for out_h, out_w in [(100, 142), (83, 118)]:
        np.testing.assert_allclose(
            tk.resize_bilinear(torch.as_tensor(img), out_h, out_w).numpy(),
            np.asarray(jk.resize_bilinear(jnp.asarray(img), out_h, out_w)), rtol=0, atol=1e-2)


def test_ic_mask_and_tap_table():
    for a, b in zip(tk.ic_angle_mask(), jk.ic_angle_mask()):
        np.testing.assert_array_equal(a, b)
    from ceres_mono_orb_slam2_tpu.utils.config import ORBConfig

    np.testing.assert_array_equal(text.bin_tap_table(),
                                  jext.ORBExtractor(ORBConfig())._bin_tap_table)
    ex = text.ORBExtractor(ORBConfig(), device="cpu")
    mx, my = tk.ic_angle_mask()
    np.testing.assert_array_equal(ex.moment_masks.numpy(),
                                  np.stack([mx.reshape(-1), my.reshape(-1)], 1))


SHAPES = [(83, 141), (69, 117), (58, 99), (48, 83)]


def _packed(rng, integer, B=2):
    """A packed (B, total) pyramid of independent random levels."""
    layout = tk.PyramidLayout.of(SHAPES)
    planes = [np.stack([_image(rng, h, w, integer) for _ in range(B)]) for h, w in SHAPES]
    return layout, planes, np.concatenate([p.reshape(B, -1) for p in planes], 1)


def test_pyramid_layout():
    layout = tk.PyramidLayout.of(SHAPES)
    assert layout.offsets == (0, 83 * 141, 83 * 141 + 69 * 117, 83 * 141 + 69 * 117 + 58 * 99)
    assert layout.total == sum(h * w for h, w in SHAPES)
    buf = torch.arange(2 * layout.total, dtype=torch.float32).reshape(2, -1)
    views = layout.views(buf)
    assert [tuple(v.shape) for v in views] == [(2, h, w) for h, w in SHAPES]
    assert all(v[:1].is_contiguous() for v in views)  # each frame's level is one plane
    assert float(views[2][1, 0, 0]) == layout.total + layout.offsets[2]


@pytest.mark.parametrize("edge", [0, tk.EDGE])
@pytest.mark.parametrize("integer", [True, False])
def test_fast_nms_pyramid_matches_jax(rng, integer, edge):
    """The plain pyramid version (the wrapper on the CPU) against the JAX
    package's per-level nms3(fast_score_map), with the EDGE margin zeroed
    as the JAX extractor zeroes it. Tolerance 0."""
    layout, planes, buf = _packed(rng, integer)
    out = tk.fast_nms_pyramid(torch.as_tensor(buf), layout, edge=edge)
    np.testing.assert_array_equal(
        out.numpy(), tk.fast_nms_pyramid_plain(torch.as_tensor(buf), layout, edge).numpy())
    for got, plane, (h, w) in zip(layout.views(out), planes, SHAPES):
        ref = np.asarray(jk.nms3(jk.fast_score_map(jnp.asarray(plane))))
        border = np.zeros((h, w), np.float32)
        border[edge:h - edge, edge:w - edge] = 1.0
        np.testing.assert_array_equal(got.numpy(), ref * border)
        one_level = tk.zero_margin(tk.fast_nms(torch.as_tensor(plane)), edge).numpy()
        np.testing.assert_array_equal(one_level, got.numpy())
        assert (got.numpy() > 0).sum() > 10


def _level_keypoints(rng, counts, lo, hi_y, hi_x, B=2):
    """(B, N) int32 level-major centres: per level the 4 corners of the
    allowed box [lo, hi_y(h)] x [lo, hi_x(w)], then random ones inside."""
    ys, xs = [], []
    for n, (h, w) in zip(counts, SHAPES):
        y = rng.integers(lo, hi_y(h) + 1, (B, n))
        x = rng.integers(lo, hi_x(w) + 1, (B, n))
        y[:, :4] = [lo, lo, hi_y(h), hi_y(h)]
        x[:, :4] = [lo, hi_x(w), lo, hi_x(w)]
        ys.append(y)
        xs.append(x)
    return np.concatenate(ys, 1).astype(np.int32), np.concatenate(xs, 1).astype(np.int32)


@pytest.mark.parametrize("integer", [True, False])
def test_gather_pyramid_patches_matches_jax(rng, integer):
    """Both patch sets of a packed pyramid against the JAX package's
    jax.vmap(gather_patches) per level (radius 15 from the raw pyramid,
    radius 19 from the blurred one, to_u8), with keypoints at the corners
    of the in-bounds box (JAX's gather does not clamp). Tolerance 0."""
    counts = [13, 9, 7, 5]
    layout, raw_planes, raw = _packed(rng, integer)
    _, blur_planes, blur = _packed(rng, integer)
    r = tk.DESC_R
    ys, xs = _level_keypoints(rng, counts, r, lambda h: h - r - 1, lambda w: w - r - 1)
    T = torch.as_tensor
    p31, p39 = tk.gather_pyramid_patches(T(raw), T(blur), layout, T(ys), T(xs), counts)
    assert p31.dtype == torch.float32 and p39.dtype == torch.uint8
    assert p31.shape == (2, sum(counts), 31, 31) and p39.shape == (2, sum(counts), 39, 39)
    start = 0
    vgather = jax.vmap(jk.gather_patches, in_axes=(0, 0, 0, None))
    for n, rp, bp in zip(counts, raw_planes, blur_planes):
        y, x = jnp.asarray(ys[:, start:start + n]), jnp.asarray(xs[:, start:start + n])
        ref31 = np.asarray(vgather(jnp.asarray(rp), y, x, tk.HALF_PATCH))
        ref39 = np.asarray(vgather(jnp.asarray(bp), y, x, r))
        np.testing.assert_array_equal(p31[:, start:start + n].numpy(), ref31)
        np.testing.assert_array_equal(p39[:, start:start + n].numpy(),
                                      np.clip(ref39 + np.float32(0.5), 0, 255).astype(np.uint8))
        start += n


def test_gather_pyramid_patches_clamp_at_level_edges(rng):
    """Keypoints on and next to each level's border: every patch coordinate
    is clamped to the level, against a numpy gather of clamped indices."""
    counts = [6, 5, 5, 4]
    layout, raw_planes, raw = _packed(rng, False)
    _, blur_planes, blur = _packed(rng, True)
    ys, xs = _level_keypoints(rng, counts, 0, lambda h: h - 1, lambda w: w - 1)
    T = torch.as_tensor
    p31, p39 = tk.gather_pyramid_patches(T(raw), T(blur), layout, T(ys), T(xs), counts)

    def ref(plane, y, x, radius):
        off = np.arange(-radius, radius + 1)
        rows = np.clip(y[..., None] + off, 0, plane.shape[1] - 1)
        cols = np.clip(x[..., None] + off, 0, plane.shape[2] - 1)
        b = np.arange(plane.shape[0])[:, None, None, None]
        vals = plane[b, rows[:, :, :, None], cols[:, :, None, :]]
        return np.asarray(jnp.asarray(vals).astype(jnp.bfloat16).astype(jnp.float32))

    start = 0
    for n, rp, bp in zip(counts, raw_planes, blur_planes):
        y, x = ys[:, start:start + n], xs[:, start:start + n]
        np.testing.assert_array_equal(p31[:, start:start + n].numpy(), ref(rp, y, x, tk.HALF_PATCH))
        np.testing.assert_array_equal(
            p39[:, start:start + n].numpy(),
            np.clip(ref(bp, y, x, tk.DESC_R) + np.float32(0.5), 0, 255).astype(np.uint8))
        np.testing.assert_array_equal(
            tk.gather_patches(T(rp), T(np.ascontiguousarray(y)), T(np.ascontiguousarray(x)),
                              tk.HALF_PATCH).numpy(), ref(rp, y, x, tk.HALF_PATCH))
        start += n
