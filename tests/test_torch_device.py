"""The port's entry points run on the card by default: built with no
`device`, each one lands on CUDA where there is a card and raises where there
is none, instead of running on the CPU."""

import pytest
import torch

from ceres_mono_orb_slam2_tpu_torch.models.device_map import DeviceMapPool
from ceres_mono_orb_slam2_tpu_torch.models.fused_track import FusedStep
from ceres_mono_orb_slam2_tpu_torch.models.keyframe_database import KeyFrameDatabase
from ceres_mono_orb_slam2_tpu_torch.models.loopclosing import LoopClosing
from ceres_mono_orb_slam2_tpu_torch.models.localmapping import LocalMapping
from ceres_mono_orb_slam2_tpu_torch.models.map import Map
from ceres_mono_orb_slam2_tpu_torch.models.optimization import (
    global_bundle_adjustment, run_global_ba)
from ceres_mono_orb_slam2_tpu_torch.models.system import MonoSLAM
from ceres_mono_orb_slam2_tpu_torch.models.tracking import Tracking
from ceres_mono_orb_slam2_tpu_torch.ops import bow
from ceres_mono_orb_slam2_tpu_torch.ops.orb import ORBExtractor
from ceres_mono_orb_slam2_tpu_torch.utils.config import SlamConfig

torch.set_num_threads(2)
VOC = bow.synth_vocabulary(k=3, levels=2, seed=0)

ENTRY_POINTS = {
    "MonoSLAM with a vocabulary": lambda cfg, **kw: MonoSLAM(cfg, vocabulary=VOC, **kw),
    "KeyFrameDatabase": lambda cfg, **kw: KeyFrameDatabase(VOC, Map(), **kw),
    "LoopClosing": lambda cfg, **kw: LoopClosing(cfg, Map(), None, **kw),
    "make_transform_fn": lambda cfg, **kw: bow.make_transform_fn(VOC, **kw),
    "run_global_ba": lambda cfg, **kw: run_global_ba(Map(), cfg, 0, **kw),
    "MonoSLAM": lambda cfg, **kw: MonoSLAM(cfg, **kw),
    "ORBExtractor": lambda cfg, **kw: ORBExtractor(cfg.orb, **kw),
    "Tracking": lambda cfg, **kw: Tracking(cfg, Map(), None, **kw),
    "LocalMapping": lambda cfg, **kw: LocalMapping(cfg, Map(), **kw),
    "DeviceMapPool": lambda cfg, **kw: DeviceMapPool(Map(), cap=16, **kw),
    "FusedStep": lambda cfg, **kw: FusedStep(cfg, **kw),
    "global_bundle_adjustment": lambda cfg, **kw: global_bundle_adjustment(Map(), cfg, **kw),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_default_device_is_the_card(name):
    make = ENTRY_POINTS[name]
    if torch.cuda.is_available():
        make(SlamConfig())
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make(SlamConfig())
    make(SlamConfig(), device="cpu")  # the CPU only on request


def test_monoslam_default_is_cuda_or_refuses():
    if torch.cuda.is_available():
        assert MonoSLAM(SlamConfig()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            MonoSLAM(SlamConfig())
