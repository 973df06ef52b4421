"""Port parity: the ORB kernels of ops/orb/kernels.py against the JAX
package, including both Pallas kernels run in interpret mode.

On the CPU the port's wrappers `fast_nms` and `gather_patches` run their
plain versions (the CUDA kernels are held bit-exact to those on the GPU by
chip_smoke.py)."""

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
    ex = text.ORBExtractor(ORBConfig())
    mx, my = tk.ic_angle_mask()
    np.testing.assert_array_equal(ex.moment_masks.numpy(),
                                  np.stack([mx.reshape(-1), my.reshape(-1)], 1))
