"""Port parity of the BoW layer (ops/bow.py, models/keyframe_database.py).

The functions that construct a vocabulary are numpy and copied: the same seed must give the
same tree, field by field, bit for bit. The tree descent runs in PyTorch:
word ids and node paths must equal the JAX transform's exactly (Hamming
distances are integers and both argmins take the first minimum).
`bow_vector` and `l1_score` agree to 1e-6. The keyframe database's loop and
relocalization candidates are equal as lists on a converted map."""

import dataclasses

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from ceres_mono_orb_slam2_tpu.models.keyframe_database import KeyFrameDatabase as JaxDB
from ceres_mono_orb_slam2_tpu.models.map import Map as JaxMap
from ceres_mono_orb_slam2_tpu.ops import bow as jbow
from ceres_mono_orb_slam2_tpu.ops import matcher as jmatcher
from ceres_mono_orb_slam2_tpu_torch.ops import bow as tbow
from ceres_mono_orb_slam2_tpu_torch.ops import matcher as tmatcher
from ceres_mono_orb_slam2_tpu_torch.utils import convert

torch.set_num_threads(2)


def assert_same_tree(tv, jv):
    for f in dataclasses.fields(tbow.Vocabulary):
        a, b = getattr(tv, f.name), getattr(jv, f.name)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape, f.name
            np.testing.assert_array_equal(a, b, err_msg=f.name)
        else:
            assert a == b, f.name


def descriptors(n, seed):
    """Clustered binary descriptors: 12 centres with ~10% of the bits flipped."""
    rng = np.random.default_rng(seed)
    centres = rng.integers(0, 256, (12, 32), dtype=np.uint8)
    flips = np.packbits(rng.random((n, 256)) < 0.1, axis=-1)
    return centres[rng.integers(0, 12, n)] ^ flips


def test_hamming_pairwise_matches():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 256, (50, 7, 32), dtype=np.uint8)
    b = rng.integers(0, 256, (50, 7, 32), dtype=np.uint8)
    want = np.asarray(jmatcher.hamming_pairwise(jnp.asarray(a), jnp.asarray(b)))
    got = tmatcher.hamming_pairwise(torch.from_numpy(a), torch.from_numpy(b))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("with_docs", [False, True])
def test_train_vocabulary_same_tree(with_docs):
    d = descriptors(1500, 1)
    docs = [d[i::5] for i in range(5)] if with_docs else None
    tv = tbow.train_vocabulary(d, k=6, levels=3, seed=3, docs=docs, device="cpu")
    jv = jbow.train_vocabulary(d, k=6, levels=3, seed=3, docs=docs)
    assert_same_tree(tv, jv)
    assert tv.n_words > 20


def test_synth_and_seeded_vocabulary_same_tree(capsys):
    assert_same_tree(tbow.synth_vocabulary(k=4, levels=3, seed=2),
                     jbow.synth_vocabulary(k=4, levels=3, seed=2))
    d = descriptors(600, 4)
    capsys.readouterr()
    tv = tbow.seeded_vocabulary(d, k=4, levels=3, seed=5, docs=[d[:300], d[300:]], device="cpu")
    assert capsys.readouterr().out == ""  # no stdout heartbeat in the port
    assert_same_tree(tv, jbow.seeded_vocabulary(d, k=4, levels=3, seed=5, docs=[d[:300], d[300:]]))
    assert_same_tree(convert.vocabulary_from_reference(
        jbow.synth_vocabulary(k=4, levels=3, seed=2)), tbow.synth_vocabulary(k=4, levels=3, seed=2))


@pytest.mark.parametrize("kind", ["trained", "synth"])
def test_transform_word_ids_and_paths_equal(kind):
    d = descriptors(900, 6)
    voc = (tbow.train_vocabulary(d[:600], k=5, levels=4, seed=0, device="cpu") if kind == "trained"
           else tbow.synth_vocabulary(k=5, levels=4, seed=0))
    q = d[600:]
    valid = np.ones(len(q), bool)
    valid[::7] = False
    tw, tp = tbow.make_transform_fn(voc, device="cpu")(q, valid)
    jw, jp = jbow.make_transform_fn(voc)(jnp.asarray(q), jnp.asarray(valid))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    assert (tw.numpy()[::7] == -1).all() and (tw.numpy()[valid] >= 0).all()


def test_bow_vector_and_l1_score():
    d = descriptors(800, 8)
    voc = tbow.train_vocabulary(d, k=5, levels=3, seed=0, docs=[d[:400], d[400:]], device="cpu")
    tr = tbow.make_transform_fn(voc, device="cpu")
    ones = np.ones(200, bool)
    w1, w2 = tr(d[:200], ones)[0].numpy(), tr(d[150:350], ones)[0].numpy()
    tv1, tv2 = (tbow.bow_vector(w, voc.word_weight, voc.n_words) for w in (w1, w2))
    jv1, jv2 = (jbow.bow_vector(w, voc.word_weight, voc.n_words) for w in (w1, w2))
    assert tv1.keys() == jv1.keys()
    assert max(abs(tv1[k] - jv1[k]) for k in tv1) < 1e-6
    assert abs(sum(tv1.values()) - 1.0) < 1e-6
    assert abs(tbow.l1_score(tv1, tv2) - jbow.l1_score(jv1, jv2)) < 1e-6
    assert abs(tbow.l1_score(tv1, tv1) - 1.0) < 1e-6
    assert 0.0 < tbow.l1_score(tv1, tv2) < 1.0


def test_orbvoc_text_round_trip(tmp_path):
    d = descriptors(700, 9)
    voc = tbow.train_vocabulary(d, k=4, levels=3, seed=1, docs=[d[:350], d[350:]], device="cpu")
    path = str(tmp_path / "voc.txt")
    tbow.dump_orbvoc_text(voc, path)
    back = tbow.parse_orbvoc_text(path)
    jback = jbow.parse_orbvoc_text(path)  # the JAX package reads the port's file alike
    assert_same_tree(back, jback)
    assert back.n_words == voc.n_words and back.k == voc.k
    # pre-order renumbering moves node ids; what a descriptor quantizes to must not move
    q, ones = d[:300], np.ones(300, bool)
    w0 = tbow.make_transform_fn(voc, device="cpu")(q, ones)[0].numpy()
    w1 = tbow.make_transform_fn(back, device="cpu")(q, ones)[0].numpy()
    np.testing.assert_allclose(back.word_weight[w1], voc.word_weight[w0], rtol=1e-6)
    leaf0 = voc.node_desc[np.nonzero(voc.is_leaf)[0][w0]]
    leaf1 = back.node_desc[np.nonzero(back.is_leaf)[0][w1]]
    np.testing.assert_array_equal(leaf0, leaf1)


class _KF:
    """A keyframe as the database sees it."""

    def __init__(self, kf_id, desc, covisible):
        self.id = self.frame_id = kf_id
        self.timestamp = float(kf_id)
        n = len(desc)
        self.Rcw, self.tcw = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
        self.kp_xy = self.kp_und = np.zeros((n, 2), np.float32)
        self.kp_octave = np.zeros(n, np.int32)
        self.kp_angle = self.kp_response = np.zeros(n, np.float32)
        self.desc, self.kp_valid = desc, np.ones(n, bool)
        self.mp_ids = np.full(n, -1, np.int64)
        self.covisible = dict(covisible)
        self.ordered_neighbors = sorted(covisible, key=covisible.get, reverse=True)
        self.parent, self.children, self.loop_edges = None, set(), set()
        self.bad = self.not_erase = self.to_be_erased = False
        self.bow_vec, self.Tcw_gba, self.gba_for_kf = None, None, -1

    def best_covisible(self, n):
        return self.ordered_neighbors[:n]


def test_keyframe_database_candidates_equal():
    """16 keyframes around a ring of places; keyframe 15 revisits place 0.
    Both databases index keyframes 0..14 and answer the same queries."""
    rng = np.random.default_rng(10)
    places = [descriptors(120, 100 + p) for p in range(8)]
    voc = tbow.train_vocabulary(np.concatenate(places), k=6, levels=3, seed=0, device="cpu")
    jm = JaxMap()
    for k in range(16):
        p = k // 2 if k < 15 else 0
        desc = places[p][rng.permutation(120)[:100]] ^ np.packbits(rng.random((100, 256)) < 0.02, -1)
        cov = {n: 50 for n in (k - 1, k + 1) if 0 <= n < 16}
        jm.keyframes[k] = _KF(k, desc, cov)
    jm.next_kf_id = 16
    jdb = JaxDB(voc, jm)
    for k in range(15):
        jdb.add(jm.keyframes[k])
    tm = convert.map_from_reference(jm)
    tdb = convert.database_from_reference(jdb, voc, tm, device="cpu")
    assert tdb.inverted == jdb.inverted and tdb.inverted
    for k in range(15):  # converted BoW vectors, and recomputed ones, agree
        jv, tv = jm.keyframes[k].bow_vec, tdb.compute_bow(tm.keyframes[k].desc, tm.keyframes[k].kp_valid)
        assert jv.keys() == tv.keys() and max(abs(jv[w] - tv[w]) for w in jv) < 1e-6
    for min_score in (0.0, 0.05, 0.3):
        jl = jdb.detect_loop_candidates(jm.keyframes[15], min_score)
        tl = tdb.detect_loop_candidates(tm.keyframes[15], min_score)
        assert tl == jl
    assert 0 in tdb.detect_loop_candidates(tm.keyframes[15], 0.0) or \
        1 in tdb.detect_loop_candidates(tm.keyframes[15], 0.0)
    for k in (15, 7):
        assert tdb.detect_relocalization_candidates(tm.keyframes[k]) == \
            jdb.detect_relocalization_candidates(jm.keyframes[k])
    # erase and clear behave alike
    tdb.erase(3, tm.keyframes[3].bow_vec)
    jdb.erase(3, jm.keyframes[3].bow_vec)
    assert tdb.inverted == jdb.inverted
    tdb.clear()
    assert not tdb.inverted
