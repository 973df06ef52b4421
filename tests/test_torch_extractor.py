"""Port parity: the ORB extractor (ops/orb/extractor.py) against the JAX
package on the same 8-bit images, at 480x640 and at a small KITTI-aspect
size (188x620).

Level 0 never passes through the resize, so its keypoints are bit-exact.
Pyramid levels >= 1 are float images that differ by up to ~1e-2 between the
frameworks' antialiased resizes, which can flip FAST/NMS/top-N decisions at
near ties: there >= 99% of keypoints must be identical, and shared keypoints
must have bit-exact descriptors on >= 99% and angles within 0.5 deg (the bar
of tests/test_orb_oracle.py)."""

import numpy as np
import jax
import pytest
import torch

from ceres_mono_orb_slam2_tpu.ops.orb.extractor import ORBExtractor as JaxExtractor
from ceres_mono_orb_slam2_tpu.utils.config import ORBConfig
from ceres_mono_orb_slam2_tpu_torch.ops.orb.extractor import ORBExtractor, _select_level_keypoints

torch.set_num_threads(2)


def _image(rng, h, w):
    img = rng.uniform(40, 90, (h, w))
    for _ in range(h * w // 300):
        y, x, s = rng.integers(0, h - 9), rng.integers(0, w - 9), rng.integers(3, 9)
        img[y:y + s, x:x + s] = rng.uniform(120, 250)
    return np.clip(img + rng.normal(0, 2, (h, w)), 0, 255).astype(np.float32)


@pytest.mark.parametrize("hw", [(480, 640), (188, 620)])
def test_extractor_parity(rng, hw):
    img = _image(rng, *hw)
    cfg = ORBConfig(n_features=1000)
    fj = jax.tree_util.tree_map(lambda a: np.asarray(a)[0], JaxExtractor(cfg).extract(img))
    ft = [a[0].numpy() for a in ORBExtractor(cfg, device="cpu").extract(img)]
    xy_j, xy_t = fj.xy, ft[0]
    np.testing.assert_array_equal(ft[3], fj.octave)  # static per-level slots
    np.testing.assert_array_equal(ft[5], fj.valid)

    lvl0 = fj.octave == 0
    np.testing.assert_array_equal(xy_t[lvl0], xy_j[lvl0])
    np.testing.assert_array_equal(ft[4][lvl0], fj.desc[lvl0])

    valid = fj.valid & ft[5]
    same = valid & (xy_t == xy_j).all(-1)
    assert same.sum() >= 0.99 * valid.sum(), (same.sum(), valid.sum())
    desc_eq = (ft[4] == fj.desc).all(-1)[same]
    assert desc_eq.mean() >= 0.99, desc_eq.mean()
    dang = np.angle(np.exp(1j * (ft[2] - fj.angle)))[same]
    assert np.degrees(np.abs(dang)).max() < 0.5


def test_select_level_keypoints_ties(rng):
    """Equal keys (equal scores) resolve in index order like lax.top_k."""
    from ceres_mono_orb_slam2_tpu.ops.orb.extractor import _select_level_keypoints as jsel

    score = np.zeros((1, 96, 128), np.float32)
    ys, xs = rng.integers(0, 96, 300), rng.integers(0, 128, 300)
    score[0, ys, xs] = rng.choice([25.0, 30.0, 10.0], 300)  # many exact ties
    out_j = [np.asarray(a) for a in jsel(jax.numpy.asarray(score), 40, 20.0, 7.0)]
    out_t = [a.numpy() for a in _select_level_keypoints(torch.as_tensor(score), 40, 20.0, 7.0)]
    for a, b in zip(out_j, out_t):
        np.testing.assert_array_equal(b, a)
