"""Bag-of-visual-words layer: vocabulary tree, batched transform, L1 scoring.

Port of `ceres_mono_orb_slam2_tpu/ops/bow.py`, the equivalent of the vendored
DBoW2 (TemplatedVocabulary.h): the vocabulary is dense tensors (packed node
descriptors (N, 32) uint8, children table (N, K) int32) resident on the
device, and `make_transform_fn` descends the tree for all descriptors of a
frame at once: per level one gather of the K children's packed descriptors,
XOR and population count, argmin, descend.

Vocabulary sources, all numpy on the host and seed-for-seed identical to the
JAX package's:
- `parse_orbvoc_text` / `dump_orbvoc_text` read and write the standard
  ORBvoc.txt format (TemplatedVocabulary::loadFromTextFile), in pure Python;
- `train_vocabulary` builds a k-medians binary tree from sample descriptors
  (TemplatedVocabulary::create);
- `seeded_vocabulary` / `synth_vocabulary` build full k^levels trees at the
  ORBvoc shape (k=10, levels=6: 1,111,111 nodes, 10^6 words).

Scoring is DBoW2 L1 (ScoringObject.cpp): s = 1 - 0.5 |v1/|v1| - v2/|v2||_1.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np
import torch

from ceres_mono_orb_slam2_tpu_torch.ops import matcher
from ceres_mono_orb_slam2_tpu_torch.utils import graphs
from ceres_mono_orb_slam2_tpu_torch.utils.device import DEFAULT_DEVICE, resolve_device


@dataclass
class Vocabulary:
    k: int  # branching factor
    levels: int
    node_desc: np.ndarray  # (N, 32) uint8
    children: np.ndarray  # (N, k) int32, -1 padded
    is_leaf: np.ndarray  # (N,) bool
    word_id: np.ndarray  # (N,) int32, -1 for non-leaves
    word_weight: np.ndarray  # (W,) float32 idf weights
    node_level: np.ndarray  # (N,) int32

    @property
    def n_words(self) -> int:
        return len(self.word_weight)


def _document_frequency(voc: Vocabulary, docs, device) -> np.ndarray:
    """Number of documents (per-image descriptor arrays) containing each word."""
    transform = make_transform_fn(voc, device=device)
    df = np.zeros(voc.n_words, np.int64)
    for d in docs:
        d = np.asarray(d, np.uint8)
        if len(d) == 0:
            continue
        w, _ = transform(d, np.ones(len(d), bool))
        w = w.cpu().numpy()
        df[np.unique(w[w >= 0])] += 1
    return df


def _kmedians_binary(descs: np.ndarray, k: int, rng, iters: int = 8):
    """Binary k-medians: centers are bitwise majority vote of members."""
    n = len(descs)
    k = min(k, n)
    centers = descs[rng.choice(n, k, replace=False)].copy()
    bits = np.unpackbits(descs, axis=-1).astype(np.int32)  # (n, 256)
    for _ in range(iters):
        cbits = np.unpackbits(centers, axis=-1).astype(np.int32)
        d = np.abs(bits[:, None, :] - cbits[None, :, :]).sum(-1)
        assign = d.argmin(-1)
        for j in range(k):
            sel = bits[assign == j]
            if len(sel):
                maj = (sel.mean(0) >= 0.5).astype(np.uint8)
                centers[j] = np.packbits(maj)
    cbits = np.unpackbits(centers, axis=-1).astype(np.int32)
    assign = np.abs(bits[:, None, :] - cbits[None, :, :]).sum(-1).argmin(-1)
    return centers, assign


def train_vocabulary(descs: np.ndarray, k: int = 10, levels: int = 3, seed: int = 0,
                     docs=None, device=DEFAULT_DEVICE) -> Vocabulary:
    """Hierarchical binary k-medians vocabulary (DBoW2 create equivalent).
    descs: (N, 32) uint8 sample descriptors.

    `docs`: optional list of per-image (Ni, 32) descriptor arrays — the
    training corpus as DBoW2 sees it. When given, leaf weights are TF-IDF:
    idf_i = ln(N_docs / n_docs_containing_word_i), words absent from the
    corpus get weight 0 (reference TemplatedVocabulary::setNodeWeights,
    TemplatedVocabulary.h:943-990). Without docs, weights stay uniform
    (every training descriptor came from one 'document'). The k-medians runs
    in numpy on the host (same seed, same tree as the JAX package); only the
    document-frequency pass descends the tree on `device`."""
    rng = np.random.default_rng(seed)
    node_desc = [np.zeros(32, np.uint8)]  # root (unused descriptor)
    children: list = [[]]
    is_leaf = [False]
    node_level = [0]

    def build(node, members, level):
        if level == levels or len(members) < k * 2:
            is_leaf[node] = True
            return
        centers, assign = _kmedians_binary(members, k, rng)
        for j in range(len(centers)):
            sub = members[assign == j]
            if len(sub) == 0:
                continue
            nid = len(node_desc)
            node_desc.append(centers[j])
            children.append([])
            is_leaf.append(False)
            node_level.append(level + 1)
            children[node].append(nid)
            build(nid, sub, level + 1)
        if not children[node]:
            is_leaf[node] = True

    build(0, descs, 0)
    n = len(node_desc)
    kmax = max((len(c) for c in children), default=1)
    kmax = max(kmax, 1)
    ch = np.full((n, kmax), -1, np.int32)
    for i, c in enumerate(children):
        ch[i, : len(c)] = c
    leaf_mask = np.array(is_leaf)
    word_id = np.full(n, -1, np.int32)
    wids = np.nonzero(leaf_mask)[0]
    word_id[wids] = np.arange(len(wids), dtype=np.int32)
    weights = np.ones(len(wids), np.float32)
    voc = Vocabulary(
        k=kmax, levels=levels, node_desc=np.stack(node_desc), children=ch,
        is_leaf=leaf_mask, word_id=word_id, word_weight=weights,
        node_level=np.array(node_level, np.int32),
    )
    if docs:
        # TF-IDF: idf = ln(N_docs / Ni) over document frequency
        # (TemplatedVocabulary.h:943-990 setNodeWeights)
        n_docs = len(docs)
        df = _document_frequency(voc, docs, device)
        weights = np.zeros(voc.n_words, np.float32)
        nz = df > 0
        weights[nz] = np.log(n_docs / df[nz].astype(np.float64)).astype(np.float32)
        # words seen in EVERY document get idf 0; keep a small floor so they
        # still contribute (DBoW2 keeps the exact 0 — but its corpora are
        # large enough that this never zeroes a whole vector; tiny synthetic
        # corpora here can, which would make L1 normalization divide by 0)
        weights[nz] = np.maximum(weights[nz], 1e-3)
        voc.word_weight = weights
    return voc


_POPCOUNT8 = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1).astype(np.uint8)


def _hamming_to_centers(descs: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """(n, 32)u8 x (k, 32)u8 -> (n, k) int32 Hamming distances via a byte
    population-count table, without materializing the (n, k, 256) unpacked tensor that
    _kmedians_binary's unpackbits path needs."""
    out = np.empty((len(descs), len(centers)), np.int32)
    for j in range(len(centers)):
        out[:, j] = _POPCOUNT8[descs ^ centers[j]].sum(-1, dtype=np.int32)
    return out


def _kmedians_packed(descs: np.ndarray, k: int, rng, iters: int = 6):
    """Binary k-medians on packed u8 descriptors (majority-vote centers),
    memory-light for 100k+ member sets. Returns (centers (k',32), assign)."""
    n = len(descs)
    k = min(k, n)
    centers = descs[rng.choice(n, k, replace=False)].copy()
    for _ in range(iters):
        assign = _hamming_to_centers(descs, centers).argmin(-1)
        for j in range(k):
            sel = descs[assign == j]
            if len(sel):
                bits = np.unpackbits(sel, axis=-1)
                centers[j] = np.packbits(bits.mean(0) >= 0.5)
    assign = _hamming_to_centers(descs, centers).argmin(-1)
    return centers, assign


def seeded_vocabulary(corpus: np.ndarray, k: int = 10, levels: int = 6,
                      seed: int = 0, docs=None, iters: int = 6,
                      max_corpus: int = 400_000, device=DEFAULT_DEVICE) -> Vocabulary:
    """Full k^levels ORBvoc-SHAPE tree (k=10, L=6 -> 1,111,111 nodes exactly
    like the reference's ORBvoc.txt) whose populated branches are trained on
    REAL descriptors: every node with enough corpus members splits by binary
    k-medians (TemplatedVocabulary::create semantics, HKmeansStep,
    TemplatedVocabulary.h:298-476), and only member-less branches fill with
    structure-generated descriptors so the node count stays at ORBvoc scale.

    Rationale: a purely structure-generated tree quantizes real descriptors into near-random
    words — overlapping views share almost no words and loop
    closure/relocalization never fire. Seeding the tree with a corpus from
    the same detector (different sequence/seed, like the reference training
    ORBvoc on unrelated Bovisa/Malaga imagery) restores trained-tree
    retrieval statistics at the full 1M-word scale.

    `docs`: optional per-image descriptor arrays for TF-IDF weights; without
    them, corpus-populated words get uniform weight 1 and synthetic-only
    words a small floor (they can still be hit by unseen descriptors).
    """
    rng = np.random.default_rng(seed)
    corpus = np.asarray(corpus, np.uint8)
    if len(corpus) > max_corpus:
        corpus = corpus[rng.choice(len(corpus), max_corpus, replace=False)]
    level_sizes = [k ** l for l in range(levels + 1)]
    n = sum(level_sizes)
    offsets = np.cumsum([0] + level_sizes)
    node_desc = np.zeros((n, 32), np.uint8)
    node_level = np.zeros(n, np.int32)
    children = np.full((n, k), -1, np.int32)
    members: Dict[int, np.ndarray] = {0: np.arange(len(corpus))}
    for l in range(levels):
        lo, hi = offsets[l], offsets[l + 1]
        nl = level_sizes[l + 1]
        # bulk: children table + synthetic fill for the WHOLE level (fewer
        # bit flips deeper down, as in synth_vocabulary); populated nodes
        # overwrite their children's centers below
        idx = np.arange(lo, hi, dtype=np.int32)
        base = hi + (idx - lo) * k
        children[lo:hi] = base[:, None] + np.arange(k, dtype=np.int32)[None, :]
        node_level[hi:offsets[l + 2]] = l + 1
        mask = rng.integers(0, 256, (nl, 32), dtype=np.uint8)
        for _ in range(l):
            mask &= rng.integers(0, 256, (nl, 32), dtype=np.uint8)
        node_desc[hi:offsets[l + 2]] = np.repeat(node_desc[lo:hi], k, axis=0) ^ mask
        # data pass: split every populated node's members among its children
        for node in [nd for nd in members if lo <= nd < hi]:
            mem = members.pop(node)
            d = corpus[mem]
            b = children[node, 0]
            if len(mem) >= 2 * k:
                centers, assign = _kmedians_packed(d, k, rng, iters)
            else:
                centers = np.unique(d, axis=0)[:k]
                assign = _hamming_to_centers(d, centers).argmin(-1)
            node_desc[b:b + len(centers)] = centers
            for j in range(len(centers)):
                sub = mem[assign == j]
                if len(sub):
                    members[b + j] = sub
    is_leaf = node_level == levels
    word_id = np.full(n, -1, np.int32)
    wids = np.nonzero(is_leaf)[0]
    word_id[wids] = np.arange(len(wids), dtype=np.int32)
    weights = np.full(len(wids), 0.05, np.float32)  # synthetic-only floor
    populated = np.array([nd for nd in members if is_leaf[nd]], np.int64)
    if len(populated):
        weights[word_id[populated]] = 1.0
    voc = Vocabulary(k=k, levels=levels, node_desc=node_desc,
                     children=children, is_leaf=is_leaf, word_id=word_id,
                     word_weight=weights, node_level=node_level)
    if docs:
        n_docs = len(docs)
        df = _document_frequency(voc, docs, device)
        idf = np.full(voc.n_words, 0.05, np.float32)
        nz = df > 0
        idf[nz] = np.maximum(
            np.log(n_docs / df[nz].astype(np.float64)), 0.05).astype(np.float32)
        voc.word_weight[:] = idf
    return voc


def synth_vocabulary(k: int = 10, levels: int = 6, seed: int = 0) -> Vocabulary:
    """Structure-generate a full k^levels vocabulary tree at ORBvoc scale
    (k=10, L=6 -> 1,111,111 nodes / 1M words, the shape the reference loads
    from ORBvoc.txt — TemplatedVocabulary.h:1338-1423). Each node's
    descriptor is its parent's with a level-decreasing number of random bit
    flips (AND of m random byte masks has an expected 256/2^m set bits), so
    nearby leaves share prefixes exactly like a trained k-medians tree.
    Leaf weights are log-normal idf-like samples."""
    rng = np.random.default_rng(seed)
    level_sizes = [k ** l for l in range(levels + 1)]
    n = sum(level_sizes)
    node_desc = np.zeros((n, 32), np.uint8)
    node_level = np.zeros(n, np.int32)
    offsets = np.cumsum([0] + level_sizes)  # level l occupies [offsets[l], offsets[l+1])
    for l in range(1, levels + 1):
        nl = level_sizes[l]
        parent = node_desc[offsets[l - 1]:offsets[l]]
        mask = rng.integers(0, 256, (nl, 32), dtype=np.uint8)
        for _ in range(l - 1):  # AND more masks -> fewer flips deeper down
            mask &= rng.integers(0, 256, (nl, 32), dtype=np.uint8)
        node_desc[offsets[l]:offsets[l + 1]] = np.repeat(parent, k, axis=0) ^ mask
        node_level[offsets[l]:offsets[l + 1]] = l
    children = np.full((n, k), -1, np.int32)
    for l in range(levels):
        idx = np.arange(offsets[l], offsets[l + 1], dtype=np.int32)
        base = offsets[l + 1] + (idx - offsets[l]) * k
        children[idx] = base[:, None] + np.arange(k, dtype=np.int32)[None, :]
    is_leaf = node_level == levels
    word_id = np.full(n, -1, np.int32)
    wids = np.nonzero(is_leaf)[0]
    word_id[wids] = np.arange(len(wids), dtype=np.int32)
    weights = rng.lognormal(0.0, 0.5, len(wids)).astype(np.float32)
    return Vocabulary(k=k, levels=levels, node_desc=node_desc, children=children,
                      is_leaf=is_leaf, word_id=word_id, word_weight=weights,
                      node_level=node_level)


def dump_orbvoc_text(voc: Vocabulary, path: str):
    """Write the standard ORBvoc.txt format (header 'k L 0 3', one line per
    non-root node: parent is_leaf d0..d31 weight, pre-order), compatible with
    TemplatedVocabulary::loadFromTextFile and `parse_orbvoc_text`. The
    native writer (`utils/native.py`) when its library is built, else this
    Python one."""
    import io

    from ceres_mono_orb_slam2_tpu_torch.utils import native

    if native.available() and native.dump_orbvoc_native(
            path, voc.k, voc.levels, voc.node_desc, voc.children, voc.word_id, voc.word_weight):
        return
    buf = io.StringIO()
    buf.write(f"{voc.k} {voc.levels} 0 3\n")
    remap = {0: 0}
    stack = [0]
    order = []
    while stack:  # iterative pre-order (1M-node trees overflow recursion)
        node = stack.pop()
        kids = [int(c) for c in voc.children[node] if c >= 0]
        for c in kids:
            order.append((node, c))
        stack.extend(reversed(kids))
    for parent, node in order:
        remap[node] = len(remap)
    for parent, node in order:
        d = " ".join(str(int(x)) for x in voc.node_desc[node])
        wid = voc.word_id[node]
        weight = float(voc.word_weight[wid]) if wid >= 0 else 0.0
        buf.write(f"{remap[parent]} {int(voc.is_leaf[node])} {d} {weight}\n")
    with open(path, "w") as f:
        f.write(buf.getvalue())


def parse_orbvoc_text(path: str) -> Vocabulary:
    """Parse the standard ORBvoc.txt (loadFromTextFile): header
    'k L scoring weighting', then one line per node:
    parent_id is_leaf d0..d31 weight. The line scan is the native one
    (`utils/native.py`, as the reference's loader is native: a ~1.1M-line
    file gates startup) when its library is built, else a pure-Python one;
    both feed the vectorized tree assembly of `_vocabulary_from_raw`."""
    from ceres_mono_orb_slam2_tpu_torch.utils import native

    raw = native.parse_orbvoc_raw(path) if native.available() else None
    if raw is not None:
        return _vocabulary_from_raw(*raw)
    with open(path, "r") as f:
        header = f.readline().split()
        k, levels = int(header[0]), int(header[1])
        pl, ll, dl, wl = [], [], [], []
        for line in f:
            parts = line.split()
            if len(parts) < 35:
                continue
            pl.append(int(parts[0]))
            ll.append(bool(int(parts[1])))
            dl.append([int(x) for x in parts[2:34]])
            wl.append(float(parts[34]))
    parents = np.array(pl, np.int32)
    leafs = np.array(ll, bool)
    descs = np.array(dl, np.uint8).reshape(len(pl), 32)
    weights = np.array(wl, np.float32)
    return _vocabulary_from_raw(k, levels, parents, leafs, descs, weights)


def _vocabulary_from_raw(k: int, levels: int, parents: np.ndarray,
                         leafs: np.ndarray, descs: np.ndarray,
                         weights: np.ndarray) -> Vocabulary:
    """Assemble the dense tree tensors from per-line arrays (vectorized —
    the Python dict/list version took seconds at the 1.1M-node scale)."""
    n = len(parents) + 1  # +1 root
    node_desc = np.zeros((n, 32), np.uint8)
    node_desc[1:] = descs
    is_leaf = np.zeros(n, bool)
    is_leaf[1:] = leafs
    # children table: bucket node ids (1..n-1) under their parents
    node_ids = np.arange(1, n, dtype=np.int32)
    order = np.argsort(parents, kind="stable")
    sorted_parents = parents[order].astype(np.int64)
    counts = np.bincount(sorted_parents, minlength=n)
    kmax = int(counts.max()) if n > 1 else 1
    kmax = max(kmax, 1)
    offsets = np.concatenate([[0], np.cumsum(counts)[:-1]])
    pos = np.arange(n - 1) - offsets[sorted_parents]  # rank within parent
    children = np.full((n, kmax), -1, np.int32)
    children[sorted_parents, pos] = node_ids[order]
    word_id = np.full(n, -1, np.int32)
    wids = np.nonzero(is_leaf)[0]
    word_id[wids] = np.arange(len(wids), dtype=np.int32)
    w = weights[wids - 1].astype(np.float32)
    # depth: sweep level[child] = level[parent]+1 to a fixpoint. Parent ids
    # precede children in a well-formed file so ~levels+1 sweeps suffice,
    # but the header's L is untrusted input — iterate until converged with
    # a hard cap rather than silently stopping at L+1.
    level = np.zeros(n, np.int32)
    pidx = parents.astype(np.int64)
    for _ in range(max(int(levels) + 1, 1) + 512):
        new = level[pidx] + 1
        if np.array_equal(new, level[1:]):
            break
        level[1:] = new
    else:
        raise ValueError(
            "vocabulary tree did not converge to a fixed depth "
            f"(header levels={levels}); cyclic or corrupt parent ids")
    return Vocabulary(k=kmax, levels=levels, node_desc=node_desc, children=children,
                      is_leaf=is_leaf, word_id=word_id, word_weight=w, node_level=level)


def make_transform_fn(voc: Vocabulary, device=DEFAULT_DEVICE):
    """Returns fn(desc_u8 (N, 32) uint8, valid (N,) bool) ->
    (word_ids (N,) int32 [-1 where invalid], node_path (N, L + 3) int32),
    tensors on `device`; inputs may be numpy arrays or tensors.

    Tree descent: at each level gather the K children's packed descriptor
    rows, XOR and population count, argmin (the first minimum, as
    `jnp.argmin`), descend. Descriptors reaching a leaf stay there (padded
    children rows point at the node itself). Packed uint8 storage keeps a
    1.1M-node ORBvoc-scale tree at 35.6 MB on the device and the per-level
    gather at K * 32 contiguous bytes per descriptor. The tables are
    written on the current stream and handed over to the mapper stream,
    where loop closing's transforms run (`utils/graphs.share_with`); every
    call waits for them on its own stream."""
    device = resolve_device(device)
    desc_t = torch.as_tensor(np.ascontiguousarray(voc.node_desc)).to(device)
    n_levels = int(voc.levels) + 2
    # padded children point at their own node, so leaves are absorbing
    ch = np.array(voc.children)
    self_col = np.arange(len(ch), dtype=np.int32)[:, None]
    ch_t = torch.as_tensor(np.where(ch < 0, self_col, ch).astype(np.int32)).to(device)
    wid_t = torch.as_tensor(np.asarray(voc.word_id, np.int32)).to(device)
    ready = graphs.share_with("mapper", (desc_t, ch_t, wid_t))

    @torch.no_grad()
    def transform(desc_u8, valid):
        graphs.wait_for(ready)
        desc_u8 = torch.as_tensor(desc_u8).to(device)
        valid = torch.as_tensor(valid).to(device)
        node = torch.zeros(desc_u8.shape[0], dtype=torch.int64, device=device)
        path = [node]
        for _ in range(n_levels):
            cand = ch_t[node].long()  # (N, K)
            d = matcher.hamming_pairwise(desc_u8[:, None, :], desc_t[cand])  # (N, K)
            node = torch.gather(cand, 1, d.argmin(-1, keepdim=True))[:, 0]
            path.append(node)
        wid = torch.where(valid, wid_t[node], torch.full_like(wid_t[node], -1))
        return wid, torch.stack(path, dim=1).to(torch.int32)

    return transform


def bow_vector(word_ids: np.ndarray, weights: np.ndarray, n_words: int) -> Dict[int, float]:
    """Sparse L1-normalized BoW vector (DBoW2 transform output equivalent)."""
    v: Dict[int, float] = {}
    for w in word_ids:
        if w >= 0:
            v[int(w)] = v.get(int(w), 0.0) + float(weights[int(w)])
    s = sum(v.values())
    if s > 0:
        for kk in v:
            v[kk] /= s
    return v


def l1_score(v1: Dict[int, float], v2: Dict[int, float]) -> float:
    """DBoW2 L1 score (ScoringObject.cpp): 1 - 0.5*sum|a - b| over the union
    of words, with both vectors L1-normalized. In [0, 1]."""
    s = 0.0
    for w, a in v1.items():
        b = v2.get(w)
        if b is not None:
            s += abs(a - b) - a - b
    total = 2.0 + s  # = sum|a-b| over union
    return 1.0 - 0.5 * total
