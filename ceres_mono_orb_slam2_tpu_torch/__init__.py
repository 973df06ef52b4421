"""PyTorch/CUDA port of the monocular ORB-SLAM framework.

The JAX package `ceres_mono_orb_slam2_tpu` is the reference this package is
checked against, module for module (same `ops/`, `models/`, `utils/` layout
and names). This package imports `torch` and never `jax`. Every public entry
point runs on the card unless the caller passes `device="cpu"`; on a CUDA
device the ORB front end runs the hand-written Hopper kernels in `csrc/`, on
the CPU their plain PyTorch versions.
"""

__version__ = "0.1.0"

import torch as _torch

# SLAM geometry (pose math, Jacobians, Schur solves) needs true float32
# products; TF32 keeps ~3 decimal digits and breaks optimizer convergence
# (the JAX package forces "highest" matmul precision for the same reason).
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False

from ceres_mono_orb_slam2_tpu_torch.utils.config import SlamConfig, load_config  # noqa: E402,F401

# Lazy top-level exports (PEP 562): the system facade pulls in the whole
# model stack, so `import ceres_mono_orb_slam2_tpu_torch` stays light.
_LAZY = {
    "MonoSLAM": ("ceres_mono_orb_slam2_tpu_torch.models.system", "MonoSLAM"),
    "Map": ("ceres_mono_orb_slam2_tpu_torch.models.map", "Map"),
    "Tracking": ("ceres_mono_orb_slam2_tpu_torch.models.tracking", "Tracking"),
    "ORBExtractor": ("ceres_mono_orb_slam2_tpu_torch.ops.orb.extractor", "ORBExtractor"),
}


def __getattr__(name):
    target = _LAZY.get(name)
    if target is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    value = getattr(importlib.import_module(target[0]), target[1])
    globals()[name] = value
    return value
