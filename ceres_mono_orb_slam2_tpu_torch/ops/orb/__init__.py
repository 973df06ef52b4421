from ceres_mono_orb_slam2_tpu_torch.ops.orb.extractor import FrameFeatures, ORBExtractor  # noqa: F401
from ceres_mono_orb_slam2_tpu_torch.ops.orb.pattern import BIT_PATTERN_31  # noqa: F401
