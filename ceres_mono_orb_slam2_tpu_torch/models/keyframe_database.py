"""BoW keyframe database: inverted index + loop/relocalization queries.

Equivalent of the reference KeyFrameDatabase (src/KeyFrameDatabase.cc):
word-id -> keyframe inverted index (:32-44), loop-candidate detection with
shared-word gating, common-word minimum 0.8*max, accumulated covisible-group
scores and the 0.75*bestAccScore cut (:72-200), and relocalization candidates
without the min-score gate (:202-316). Port of
`ceres_mono_orb_slam2_tpu/models/keyframe_database.py`: the per-frame BoW
transform runs on the device (ops/bow.py); the index itself is sparse host
state, mirroring the reference's std::vector<list<KeyFrame*>>.
"""

from __future__ import annotations

import logging
from typing import Dict, List

import numpy as np

from ceres_mono_orb_slam2_tpu_torch.ops import bow
from ceres_mono_orb_slam2_tpu_torch.utils import graphs
from ceres_mono_orb_slam2_tpu_torch.utils.device import DEFAULT_DEVICE

log = logging.getLogger(__name__)


class KeyFrameDatabase:
    def __init__(self, vocabulary: bow.Vocabulary, map_, device=DEFAULT_DEVICE):
        self.voc = vocabulary
        self.map = map_
        self.transform = bow.make_transform_fn(vocabulary, device=device)
        self.inverted: Dict[int, set] = {}

    # ------------------------------------------------------------- transforms

    def compute_bow(self, desc_u8: np.ndarray, valid: np.ndarray) -> Dict[int, float]:
        wids, _ = self.transform(desc_u8, valid)
        return bow.bow_vector(graphs.fetch(wids)[0], self.voc.word_weight, self.voc.n_words)

    def kf_bow(self, kf) -> Dict[int, float]:
        if kf.bow_vec is None:
            kf.bow_vec = self.compute_bow(kf.desc, kf.kp_valid)
        return kf.bow_vec

    # ------------------------------------------------------------------ index

    def add(self, kf):
        v = self.kf_bow(kf)
        for w in v:
            self.inverted.setdefault(w, set()).add(kf.id)

    def erase(self, kf_id: int, bow_vec=None):
        if bow_vec is None:
            for s in self.inverted.values():
                s.discard(kf_id)
        else:
            for w in bow_vec:
                s = self.inverted.get(w)
                if s is not None:
                    s.discard(kf_id)

    def clear(self):
        self.inverted.clear()

    # ------------------------------------------------------------- candidates

    def _sharing_counts(self, v: Dict[int, float], exclude: set) -> Dict[int, int]:
        counts: Dict[int, int] = {}
        for w in v:
            for kf_id in self.inverted.get(w, ()):
                if kf_id not in exclude:
                    counts[kf_id] = counts.get(kf_id, 0) + 1
        return counts

    def detect_loop_candidates(self, kf, min_score: float) -> List[int]:
        """Reference DetectLoopCandidates (KeyFrameDatabase.cc:72-200)."""
        m = self.map
        connected = set(kf.covisible) | {kf.id}
        v = self.kf_bow(kf)
        counts = self._sharing_counts(v, connected)
        if not counts:
            return []
        max_common = max(counts.values())
        min_common = 0.8 * max_common
        if log.isEnabledFor(logging.DEBUG):
            _top = sorted(counts.values(), reverse=True)[:6]
            log.debug("loop_cand kf=%d sharers=%d max_common=%d top=%s "
                      "min_score=%.3f", kf.id, len(counts), max_common, _top,
                      min_score)
        # score keyframes passing the common-word and min-score gates
        scored = []
        for kf_id, c in counts.items():
            if c <= min_common:
                continue
            okf = m.keyframes.get(kf_id)
            if okf is None or okf.bad:
                continue
            s = bow.l1_score(v, self.kf_bow(okf))
            if s >= min_score:
                scored.append((kf_id, s))
        if not scored:
            return []
        score_map = dict(scored)
        # accumulate over top-10 covisible groups (reference :141-189)
        best_acc = 0.0
        acc_list = []
        for kf_id, s in scored:
            okf = m.keyframes.get(kf_id)
            group = [kf_id] + okf.best_covisible(10)
            acc = 0.0
            best_in_group = (s, kf_id)
            for gid in group:
                gs = score_map.get(gid)
                if gs is not None:
                    acc += gs
                    if gs > best_in_group[0]:
                        best_in_group = (gs, gid)
            acc_list.append((acc, best_in_group[1]))
            best_acc = max(best_acc, acc)
        th = 0.75 * best_acc
        out = []
        seen = set()
        for acc, kf_id in acc_list:
            if acc > th and kf_id not in seen:
                seen.add(kf_id)
                out.append(kf_id)
        return out

    def detect_relocalization_candidates(self, frame) -> List[int]:
        """Reference DetectRelocalizationCandidates (KeyFrameDatabase.cc:
        202-316): same scheme without the min-score gate."""
        m = self.map
        v = self.compute_bow(frame.desc, frame.kp_valid)
        counts = self._sharing_counts(v, set())
        if not counts:
            return []
        max_common = max(counts.values())
        min_common = 0.8 * max_common
        scored = []
        for kf_id, c in counts.items():
            if c <= min_common:
                continue
            okf = m.keyframes.get(kf_id)
            if okf is None or okf.bad:
                continue
            scored.append((kf_id, bow.l1_score(v, self.kf_bow(okf))))
        if not scored:
            return []
        score_map = dict(scored)
        best_acc = 0.0
        acc_list = []
        for kf_id, s in scored:
            okf = m.keyframes.get(kf_id)
            group = [kf_id] + okf.best_covisible(10)
            acc = 0.0
            best_in_group = (s, kf_id)
            for gid in group:
                gs = score_map.get(gid)
                if gs is not None:
                    acc += gs
                    if gs > best_in_group[0]:
                        best_in_group = (gs, gid)
            acc_list.append((acc, best_in_group[1]))
            best_acc = max(best_acc, acc)
        th = 0.75 * best_acc
        out = []
        seen = set()
        for acc, kf_id in sorted(acc_list, reverse=True):
            if acc > th and kf_id not in seen:
                seen.add(kf_id)
                out.append(kf_id)
        return out
