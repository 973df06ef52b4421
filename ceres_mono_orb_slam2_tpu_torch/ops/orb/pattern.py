"""rBRIEF sampling pattern (bit_pattern_31), the standard learned 256-pair
pattern used by OpenCV ORB and ORB-SLAM2 (reference: src/ORBextractor.cc:150-408).

This is a *data constant* (256 learned point pairs in a 31x31 patch), required
for descriptor compatibility with standard ORB vocabularies/datasets. Stored as
a base64 int8 blob; decoded once at import into a (256, 4) array of
(x0, y0, x1, y1) sample offsets.
"""
import base64
import numpy as np

_B64 = (
    "CP0JBQQCB/T1CfgCB/QM8wLzAgwB+QEG/vb+/PPz9fjz/fT3CgQLCfP4+Pf1B/cMBwcMBvz7/QDz"
    "AvT99wD5BQz6DP/9Bv4M+vP8+AvzDPgEBwUBBf0K/QP5Bgz4+fr+/gv/9vMM+Ar5A/v9/AL9B/b0"
    "+gsF9Ab5BfoH/wEABPsJCwvzBAcEDAL/BAT89P4H+Pv59gQLCQwA+AHz8/74Av3+/gP6Cfz3CAwK"
    "BwAJAQMH+wv28/r1AAoHDAH6/foMCvcM/PMI+PTzAPj8AwMHCAUHCvn/BwH0A/YFBgL8A/bzAPMF"
    "8/n0DPMD9Qj5DPwHBvYMCPf/+fr++wAM9AX5BQP2CPP5+fwF/f7/+QIJBfX18/vz/wYA/wX9BQL8"
    "8/wM9/r3BvT2+PwKAgz9BwwMDPnz+gX8Cf0EB/8MAvkG+wHzC/QF/Qf++gf4DPnz+fX0Af0MDAL6"
    "AwD8A/7z//MBCQcBCPoB/wMMCQEMBv/3/wPz8/YFBwcKDAz7DAkGAwcLBfMGCgL0AgMDCAT6AgYM"
    "8wn0CgP4BPkJ9Qz8+gEMAvgG9wf8AgMD/gYDCwAD/Qj4BwgJA/X7+vz2C/sK+/j9DPYF9wAI/wz6"
    "BPoG9fYM+AcE/gYH/gD+DPv4+wIH+goM9/P4+Pvz+/4I+Anz9/X3AAH4Af4H/AkB/gH//Av6DPX0"
    "9/oEAwcHDAUFCggA/AII9wz78wAHAgz/AgEHBQsH9wMFBvjz/PgJ+wn9/fz5/fQGBQgA+Qb6DPMG"
    "+/4B9gMKBAEI/P7+AvMC9AwM/vMA+gQBCQP69v37/fP/AQcFDPUE/gX58wn3+wcBCAYH+AcG+fz5"
    "AfgL+fjzBvT4AgQDCQr7DAP6+/oHCP0J+AL0Agj1/vYD9PP59/UA9vsF/QsI/vP/DP/4AAnz9fT7"
    "9v72C/0J/vMC/QMC9/P8APwG/fb8DP75+vX8CQb9BgvzC/sFCwsMBgf7DP7/DAAH/Pj9/vkB+gfz"
    "9Pjz+f76+PgF+vf7//wF8wf4CgEFBfMBAArzCQwK/wX4Cvf/CwHz9/36Av/2AQzzAfj2CPUK+gLz"
    "A/oH8wz39vb7+fb4+PME+ggFAwwI8/wC/f0F8wr0BPMF//cJ/AMAAwP39AH6AQMCBPj29vYJCPMM"
    "DPj0+vsCAgMHCgYL+AYICPT5CvoF/ff9Cf/z/wX9+f0E+P74AwQCDAwC+wMLBvcL8wP/BwwL/wwE"
    "/QD9BgT1BAwC/AIB9vr4AfMH9QHzDPXzBgAL8wD/AQTzA/f+9wj6/fP6+P4F9wgKAgcD9//6//8J"
    "BQv+C/0M+AMAAwX/BAAKA/oEBfMA9gUFCAwLCAkJ+gf8CPT2BPYJBwMMBAn5Cv4HAAz+//oA9Q=="
)

# (256, 4) int8: columns are x0, y0, x1, y1 offsets within the 31x31 patch.
BIT_PATTERN_31 = np.frombuffer(base64.b64decode(_B64), dtype=np.int8).reshape(256, 4).astype(np.int32)
BIT_PATTERN_31.setflags(write=False)
