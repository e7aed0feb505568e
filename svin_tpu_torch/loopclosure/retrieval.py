"""Place recognition: batched binary bag-of-words retrieval.

Counterpart of the JAX package's ``loopclosure/retrieval.py``: descriptors
are assigned to binary codebooks by their nearest codeword in Hamming
distance, first index on ties as ``jnp.argmin`` of the JAX package's
distance matrix (the hand-written CUDA kernel ``csrc/hamming_nearest.cu``
on the card, its plain version on the CPU; no distance matrix), pooled
into an idf-weighted L1-normalized BoW vector, and scored against the
database. Two databases: ``KeyframeDatabase`` (a flat 1024-word codebook,
dense host scores) and ``ProductKeyframeDatabase`` (two 256-word codebooks
over the descriptor's 128-bit halves, 65,536 joint words; sparse rows, an
inverted file, and a device mirror scored in one program).

Descriptor words are int32 here, bit-identical to the JAX package's uint32
words; vocabulary files hold uint32, so a file written by either package
loads in the other. The host-side scoring (``query_vector``, ``scores_*``)
is the JAX package's numpy, line for line, so candidate order, ties
included, is the same.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..ops import hamming

VOCAB_SIZE = 1024
DESC_WORDS = 8


def _words(a: np.ndarray) -> torch.Tensor:
    """uint32 words (numpy) → their int32 view as a CPU tensor."""
    a = np.ascontiguousarray(a)
    return torch.from_numpy((a.view(np.int32) if a.dtype == np.uint32 else a.astype(np.int32)).copy())


def as_words(desc, device=None) -> torch.Tensor:
    """Descriptor words as an int32 tensor on ``device``: a tensor as it is,
    numpy uint32 words as their int32 view."""
    if isinstance(desc, torch.Tensor):
        return desc.to(device)
    return _words(np.asarray(desc)).to(device)


def uint32_words(words) -> np.ndarray:
    """int32 words (tensor or array) → uint32 numpy, the file format."""
    a = words.detach().cpu().numpy() if isinstance(words, torch.Tensor) else np.asarray(words)
    return np.ascontiguousarray(a).view(np.uint32) if a.dtype == np.int32 else a.astype(np.uint32)


def make_vocabulary(seed: int = 7, size: int = VOCAB_SIZE, device=None) -> torch.Tensor:
    """Deterministic random binary codebook (size, 8) int32 (numpy seed: the
    JAX package's words)."""
    rng = np.random.RandomState(seed)
    return _words(rng.randint(0, 2**32, size=(size, DESC_WORDS), dtype=np.uint64)
                  .astype(np.uint32)).to(device)


def assign_words(desc: torch.Tensor, vocab: torch.Tensor,
                 nearest: Callable = hamming.nearest_codeword) -> torch.Tensor:
    """(..., K) int64 nearest codeword per descriptor: (..., K, W) against
    (..., V, W) by ``nearest`` (first index on ties)."""
    return nearest(desc, vocab)


def bow_vector(desc: torch.Tensor, valid: torch.Tensor, vocab: torch.Tensor,
               vocab_size: int = VOCAB_SIZE, weights: Optional[torch.Tensor] = None,
               nearest: Callable = hamming.nearest_codeword) -> torch.Tensor:
    """L1-normalized (tf·idf) BoW vector (V,) float32; ``weights=None`` is
    pure tf."""
    word = assign_words(desc, vocab, nearest)
    hist = torch.zeros(vocab_size, dtype=torch.float32, device=desc.device)
    hist.index_add_(0, word, valid.to(torch.float32))
    if weights is not None:
        hist = hist * weights
    return hist / torch.clamp(torch.sum(hist), min=1e-12)


def l1_scores(query: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """DBoW2 L1 score: s = 1 − ½‖v_q − v_d‖₁ ∈ [0, 1]."""
    return 1.0 - 0.5 * torch.sum(torch.abs(db - query[None, :]), dim=-1)


def unpack_bits_pm1(packed: torch.Tensor) -> torch.Tensor:
    """(N, W) int32 words → (N, 32·W) int32 in {−1, +1}, bit k of word w at
    column 32·w + k (the descriptor packing order)."""
    shifts = torch.arange(32, dtype=torch.int32, device=packed.device)
    bits = (packed[:, :, None] >> shifts) & 1
    return (2 * bits - 1).reshape(packed.shape[0], packed.shape[1] * 32)


def _kmedoids(descs: torch.Tensor, centroids: torch.Tensor, iters: int) -> torch.Tensor:
    """Binary k-medoids: assign each descriptor to its nearest centroid,
    then set each centroid to its cluster's bitwise majority (integer
    ``index_add_`` of ±1 bits: exact in any order); empty clusters keep
    theirs."""
    N, W = descs.shape
    V = centroids.shape[0]
    bits = unpack_bits_pm1(descs)
    ones = torch.ones(N, dtype=torch.int32, device=descs.device)
    shifts = torch.arange(32, dtype=torch.int64, device=descs.device)
    for _ in range(iters):
        assign = assign_words(descs, centroids)
        sums = torch.zeros((V, 32 * W), dtype=torch.int32, device=descs.device).index_add_(
            0, assign, bits)
        counts = torch.zeros(V, dtype=torch.int32, device=descs.device).index_add_(0, assign, ones)
        maj = (sums > 0).to(torch.int64).reshape(V, W, 32)
        packed = torch.sum(maj << shifts, dim=-1).to(torch.int32)  # wraps: the uint32 bits
        centroids = torch.where((counts > 0)[:, None], packed, centroids)
    return centroids


def train_vocabulary(descriptors: torch.Tensor, size: int = VOCAB_SIZE, iters: int = 8,
                     seed: int = 7) -> torch.Tensor:
    """k-medoids refinement of a flat codebook over (N, 8) int32 training
    descriptors, seeded by a numpy draw of ``size`` of them (or, with fewer,
    all of them padded by a random codebook)."""
    N = descriptors.shape[0]
    rng = np.random.RandomState(seed)
    if N >= size:
        pick = torch.as_tensor(rng.choice(N, size, replace=False), device=descriptors.device)
        centroids = descriptors[pick]
    else:
        centroids = torch.cat([descriptors, make_vocabulary(seed, size - N, descriptors.device)])
    return _kmedoids(descriptors, centroids, iters)


def _doc_frequency(doc_descs, words_of, n_words: int) -> torch.Tensor:
    present = np.zeros(n_words, np.float64)
    for desc, valid in doc_descs:
        w = words_of(as_words(desc)).cpu().numpy()
        valid = valid.cpu().numpy() if isinstance(valid, torch.Tensor) else np.asarray(valid)
        present[np.unique(w[np.asarray(valid, bool)])] += 1.0
    n_docs = max(len(doc_descs), 1)
    idf = np.log(n_docs / np.maximum(present, 1.0))
    idf[present == 0] = np.log(float(n_docs))  # unseen words keep the max weight
    return torch.as_tensor(np.maximum(idf, 1e-3), dtype=torch.float32)


def compute_idf(doc_descs: list, vocab: torch.Tensor) -> torch.Tensor:
    """Per-word idf ln(N_docs / n_i) over documents [(desc (K, 8), valid
    (K,))], n_i the documents holding word i (DBoW2's TF_IDF); (V,) float32
    on the CPU."""
    return _doc_frequency(
        doc_descs, lambda d: assign_words(d.to(vocab.device), vocab), vocab.shape[0])


def save_vocabulary(path: str, vocab, weights=None) -> None:
    """A codebook as uint32 (``.npy``), or with idf weights (``.npz``)."""
    arr = uint32_words(vocab)
    assert arr.ndim == 2 and arr.shape[1] == DESC_WORDS
    if weights is None:
        np.save(path, arr, allow_pickle=False)
    else:
        w = np.asarray(weights.cpu() if isinstance(weights, torch.Tensor) else weights, np.float32)
        assert w.shape == (arr.shape[0],)
        np.savez(path, vocab=arr, weights=w)


def load_vocabulary(path: str) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(vocab int32, idf float32 or None) from either format (CPU tensors)."""
    arr = np.load(path, allow_pickle=False)
    if hasattr(arr, "files"):
        vocab, weights = arr["vocab"], arr["weights"]
        if vocab.dtype != np.uint32 or vocab.ndim != 2 or vocab.shape[1] != DESC_WORDS:
            raise ValueError(f"not a svin vocabulary: {path}")
        return _words(vocab), torch.as_tensor(np.asarray(weights, np.float32))
    if arr.dtype != np.uint32 or arr.ndim != 2 or arr.shape[1] != DESC_WORDS:
        raise ValueError(f"not a svin vocabulary: {path}")
    return _words(arr), None


def _database_device(device, who: str) -> torch.device:
    """A database's device: ``cuda`` unless another is named; raises where
    no card is present rather than quantizing on the host."""
    dev = torch.device(device if device is not None else "cuda")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"{who}: no CUDA device; pass device='cpu' to run on the host")
    return dev


class KeyframeDatabase:
    """Growable database of flat-codebook BoW vectors: quantization on the
    device (``cuda`` unless another is named), the (N, V) score on the host."""

    def __init__(self, capacity: int = 4096, vocab: Optional[torch.Tensor] = None,
                 weights: Optional[torch.Tensor] = None, device=None,
                 nearest: Callable = hamming.nearest_codeword):
        self.device = _database_device(device, "KeyframeDatabase")
        self.vocab = (vocab if vocab is not None else make_vocabulary()).to(self.device)
        self.weights = None if weights is None else weights.to(self.device, torch.float32)
        self.nearest = nearest
        V = self.vocab.shape[0]
        self.capacity = capacity
        self.vectors = np.zeros((capacity, V), np.float32)
        self.count = 0

    def _bow_np(self, desc, valid) -> np.ndarray:
        d = as_words(desc, self.device)
        v = torch.as_tensor(valid, device=self.device)
        return bow_vector(d, v, self.vocab, self.vocab.shape[0], self.weights,
                          self.nearest).cpu().numpy()

    def add(self, desc, valid) -> int:
        """Add a keyframe; returns its database index."""
        return self.add_vector(self._bow_np(desc, valid))

    def add_vector(self, v: np.ndarray) -> int:
        """Add a keyframe by its BoW vector (``bow``'s output)."""
        if self.count >= self.capacity:
            self.vectors = np.concatenate([self.vectors, np.zeros_like(self.vectors)], axis=0)
            self.capacity *= 2
        idx = self.count
        self.vectors[idx] = v
        self.count += 1
        return idx

    def query(self, desc, valid, top_k: int = 4, exclude_after: int = None):
        """Top-K (indices, scores) over entries with index < exclude_after."""
        if self.count == 0:
            return np.empty(0, np.int64), np.empty(0, np.float32)
        return self.query_vector(self._bow_np(desc, valid), top_k=top_k,
                                 exclude_after=exclude_after)

    def query_vector(self, v: np.ndarray, top_k: int = 4, exclude_after: int = None):
        n = self.count if exclude_after is None else max(0, min(exclude_after, self.count))
        if n == 0:
            return np.empty(0, np.int64), np.empty(0, np.float32)
        s = 1.0 - 0.5 * np.sum(np.abs(self.vectors[:n] - v[None, :]), axis=-1)
        k = min(top_k, n)
        idx = np.argpartition(-s, k - 1)[:k]
        idx = idx[np.argsort(-s[idx])]
        return idx, s[idx]

    def bow(self, desc, valid):
        return self._bow_np(desc, valid)

    def scores_range(self, v, lo: int, hi: int) -> np.ndarray:
        return 1.0 - 0.5 * np.sum(np.abs(self.vectors[lo:hi] - v[None, :]), axis=-1)

    def scores_at(self, v, idxs) -> np.ndarray:
        ii = np.asarray(idxs, np.int64)
        return 1.0 - 0.5 * np.sum(np.abs(self.vectors[ii] - v[None, :]), axis=-1)


# ---------------------------------------------------- product quantization
# the 256-bit descriptor splits into two 128-bit halves, each quantized
# against its own 256-word codebook; the joint word w1·256 + w2 spans 65,536
# words
PQ_HALF_WORDS = DESC_WORDS // 2  # 4 words = 128 bits per half
PQ_WORDS = 256  # per-half codebook size
PQ_VOCAB = PQ_WORDS * PQ_WORDS  # effective joint vocabulary


class ProductVocabulary(NamedTuple):
    vocab1: torch.Tensor  # (256, 4) int32, first-half codebook
    vocab2: torch.Tensor  # (256, 4) int32, second-half codebook
    idf: Optional[torch.Tensor] = None  # (65536,) float32 joint idf weights


def make_product_vocabulary(seed: int = 7, device=None) -> ProductVocabulary:
    rng = np.random.RandomState(seed)

    def half():
        return _words(rng.randint(0, 2**32, size=(PQ_WORDS, PQ_HALF_WORDS), dtype=np.uint64)
                      .astype(np.uint32)).to(device)

    return ProductVocabulary(vocab1=half(), vocab2=half())


def _train_half(descs_half: torch.Tensor, iters: int, seed: int) -> torch.Tensor:
    """k-medoids over one 128-bit half (``train_vocabulary``'s refinement at
    width 4)."""
    N = descs_half.shape[0]
    rng = np.random.RandomState(seed)
    if N >= PQ_WORDS:
        pick = torch.as_tensor(rng.choice(N, PQ_WORDS, replace=False), device=descs_half.device)
        centroids = descs_half[pick]
    else:
        pad = make_product_vocabulary(seed, descs_half.device).vocab1[: PQ_WORDS - N]
        centroids = torch.cat([descs_half, pad])
    return _kmedoids(descs_half.contiguous(), centroids.contiguous(), iters)


def train_product_vocabulary(descriptors: torch.Tensor, iters: int = 8,
                             seed: int = 7) -> ProductVocabulary:
    return ProductVocabulary(
        vocab1=_train_half(descriptors[:, :PQ_HALF_WORDS], iters, seed),
        vocab2=_train_half(descriptors[:, PQ_HALF_WORDS:], iters, seed + 1),
    )


def product_words(desc: torch.Tensor, vocab1: torch.Tensor, vocab2: torch.Tensor,
                  nearest: Callable = hamming.nearest_codeword) -> torch.Tensor:
    """(K,) int32 joint word ids: both halves as one batch of two codeword
    searches, (2, K, 4) x (2, 256, 4) — one kernel launch on the card."""
    halves = torch.stack([desc[:, :PQ_HALF_WORDS], desc[:, PQ_HALF_WORDS:]])
    w = assign_words(halves, torch.stack([vocab1, vocab2]), nearest)  # (2, K)
    return (w[0] * PQ_WORDS + w[1]).to(torch.int32)


def compute_idf_product(doc_descs: list, pv: ProductVocabulary) -> torch.Tensor:
    """Joint-word idf over a keyframe corpus (DBoW2 TF_IDF); (65536,) float32
    on the CPU."""
    dev = pv.vocab1.device
    return _doc_frequency(
        doc_descs, lambda d: product_words(d.to(dev), pv.vocab1, pv.vocab2), PQ_VOCAB)


def save_product_vocabulary(path: str, pv: ProductVocabulary) -> None:
    out = dict(vocab1=uint32_words(pv.vocab1), vocab2=uint32_words(pv.vocab2))
    if pv.idf is not None:
        out["idf"] = np.asarray(pv.idf.cpu() if isinstance(pv.idf, torch.Tensor) else pv.idf,
                                np.float32)
    np.savez(path, **out)


def load_product_vocabulary(path: str) -> ProductVocabulary:
    arr = np.load(path, allow_pickle=False)
    if "vocab1" not in getattr(arr, "files", []):
        raise ValueError(f"not a product vocabulary: {path}")
    idf = torch.as_tensor(np.asarray(arr["idf"])) if "idf" in arr.files else None
    return ProductVocabulary(vocab1=_words(arr["vocab1"]), vocab2=_words(arr["vocab2"]), idf=idf)


class ProductKeyframeDatabase:
    """Sparse-BoW database over the 65k product vocabulary: each keyframe's
    ≤ M unique active words (ids + L1-normalized tf·idf weights) as two
    packed host arrays, an inverted file (word → keyframes, weights) and a
    device mirror of the packed table, on ``device`` (``cuda`` unless
    another is named). L1 scoring uses 1 − ½‖q−d‖₁ =
    Σ_w min(q_w, d_w) for L1-normalized vectors."""

    M = 512  # max unique words per keyframe (≥ keypoint budget)
    # database size from which host queries score through the inverted file
    DEVICE_QUERY_AT = 1024

    def __init__(self, pv: Optional[ProductVocabulary] = None, capacity: int = 4096,
                 device=None, nearest: Callable = hamming.nearest_codeword):
        self.device = _database_device(device, "ProductKeyframeDatabase")
        pv = pv if pv is not None else make_product_vocabulary()
        self.pv = ProductVocabulary(pv.vocab1.to(self.device), pv.vocab2.to(self.device), pv.idf)
        self._idf_np = None if pv.idf is None else np.asarray(
            pv.idf.cpu() if isinstance(pv.idf, torch.Tensor) else pv.idf, np.float32)
        self.nearest = nearest
        self.capacity = capacity
        self.word_ids = np.zeros((capacity, self.M), np.int32)
        self.word_w = np.zeros((capacity, self.M), np.float32)
        self.count = 0
        # incrementally grown device mirror of the packed table (pow2 capacity)
        self._dev_ids: Optional[torch.Tensor] = None
        self._dev_w: Optional[torch.Tensor] = None
        self._dev_count = 0
        # inverted file: word id → ([kf indices], [weights]) (DBoW2's IFRow)
        self._inv: dict = {}

    def words(self, desc) -> np.ndarray:
        """(K,) int32 joint word ids of (K, 8) descriptors, fetched to the host."""
        d = as_words(desc, self.device)
        return product_words(d, self.pv.vocab1, self.pv.vocab2, self.nearest).cpu().numpy()

    def _sparse_bow(self, desc, valid):
        w = self.words(desc)
        v = np.asarray(valid.cpu() if isinstance(valid, torch.Tensor) else valid, bool)
        ids, cnt = np.unique(w[v], return_counts=True)
        tf = cnt.astype(np.float32)
        if self._idf_np is not None:
            tf = tf * self._idf_np[ids]
        s = tf.sum()
        if s > 0:
            tf = tf / s
        ids, tf = ids[: self.M], tf[: self.M]
        out_i = np.zeros(self.M, np.int32)
        out_w = np.zeros(self.M, np.float32)
        out_i[: len(ids)] = ids
        out_w[: len(ids)] = tf
        return out_i, out_w

    def add(self, desc, valid) -> int:
        return self.add_vector(self._sparse_bow(desc, valid))

    def add_vector(self, v) -> int:
        """Add a keyframe by its sparse BoW vector (``bow``'s output)."""
        if self.count >= self.capacity:
            self.word_ids = np.concatenate([self.word_ids, np.zeros_like(self.word_ids)])
            self.word_w = np.concatenate([self.word_w, np.zeros_like(self.word_w)])
            self.capacity *= 2
        idx = self.count
        self.word_ids[idx], self.word_w[idx] = v
        self._index_row(idx)
        self.count += 1
        return idx

    def _index_row(self, idx: int) -> None:
        """Append row ``idx``'s active words to the inverted file."""
        ids = self.word_ids[idx]
        ws = self.word_w[idx]
        for wid, w in zip(ids[ws > 0].tolist(), ws[ws > 0].tolist()):
            lst = self._inv.get(wid)
            if lst is None:
                self._inv[wid] = ([idx], [w])
            else:
                lst[0].append(idx)
                lst[1].append(w)

    def rebuild_index(self) -> None:
        """Rebuild the inverted file from the packed table (after a bulk load)."""
        self._inv = {}
        for idx in range(self.count):
            self._index_row(idx)

    def bow(self, desc, valid):
        """(ids, weights) sparse vector for reuse (query + neighbour floor)."""
        return self._sparse_bow(desc, valid)

    def query(self, desc, valid, top_k: int = 4, exclude_after: int = None):
        if self.count == 0:
            return np.empty(0, np.int64), np.empty(0, np.float32)
        return self.query_vector(self._sparse_bow(desc, valid), top_k=top_k,
                                 exclude_after=exclude_after)

    def _ensure_device_mirror(self) -> None:
        """Bring the device copy of the packed table up to date: full upload
        on pow2 capacity growth, one row-slice copy otherwise."""
        cap_needed = max(self.DEVICE_QUERY_AT, 1 << (self.count - 1).bit_length())
        if self._dev_ids is None or self._dev_ids.shape[0] < cap_needed:
            ids = np.zeros((cap_needed, self.M), np.int32)
            w = np.zeros((cap_needed, self.M), np.float32)
            ids[: self.count] = self.word_ids[: self.count]
            w[: self.count] = self.word_w[: self.count]
            self._dev_ids = torch.as_tensor(ids, device=self.device)
            self._dev_w = torch.as_tensor(w, device=self.device)
            self._dev_count = self.count
        elif self._dev_count < self.count:
            lo, hi = self._dev_count, self.count
            self._dev_ids[lo:hi] = torch.as_tensor(self.word_ids[lo:hi], device=self.device)
            self._dev_w[lo:hi] = torch.as_tensor(self.word_w[lo:hi], device=self.device)
            self._dev_count = self.count

    def _scores_inverted(self, q_ids, q_w, n: int) -> np.ndarray:
        """L1 intersection scores of entries [0, n) via the inverted file."""
        s = np.zeros(n, np.float32)
        for wid, qw in zip(q_ids.tolist(), q_w.tolist()):
            if qw <= 0.0:
                continue
            lst = self._inv.get(wid)
            if lst is None:
                continue
            ii = np.asarray(lst[0], np.int64)
            ww = np.asarray(lst[1], np.float32)
            m = ii < n
            np.add.at(s, ii[m], np.minimum(qw, ww[m]))
        return s

    def query_vector(self, v, top_k: int = 4, exclude_after: int = None):
        q_ids, q_w = v
        n = self.count if exclude_after is None else max(0, min(exclude_after, self.count))
        if n == 0:
            return np.empty(0, np.int64), np.empty(0, np.float32)
        if self.count >= self.DEVICE_QUERY_AT:
            s = self._scores_inverted(q_ids, q_w, n)
        else:
            dense = np.zeros(PQ_VOCAB, np.float32)
            dense[q_ids] = q_w
            gathered = dense[self.word_ids[:n]]  # (n, M)
            s = np.sum(np.minimum(gathered, self.word_w[:n]) * (self.word_w[:n] > 0), axis=1)
        k = min(top_k, n)
        idx = np.argpartition(-s, k - 1)[:k]
        idx = idx[np.argsort(-s[idx])]
        return idx, s[idx]

    def query_vector_device(self, v, top_k: int = 4, exclude_after: int = None):
        """Scoring, recency exclusion and top-k as one device program over the
        mirrored table; only the k (score, index) pairs come back."""
        q_ids, q_w = v
        n = self.count if exclude_after is None else max(0, min(exclude_after, self.count))
        if n == 0:
            return np.empty(0, np.int64), np.empty(0, np.float32)
        self._ensure_device_mirror()
        k = min(top_k, n)
        s, idx = score_packed_topk_device(
            torch.as_tensor(q_ids, device=self.device), torch.as_tensor(q_w, device=self.device),
            self._dev_ids, self._dev_w, n, k=top_k)
        s, idx = s.cpu().numpy(), idx.cpu().numpy()
        keep = np.isfinite(s[:k])
        return idx[:k][keep].astype(np.int64), s[:k][keep]

    def scores_range(self, v, lo: int, hi: int) -> np.ndarray:
        q_ids, q_w = v
        if hi <= lo:
            return np.empty(0, np.float32)
        dense = np.zeros(PQ_VOCAB, np.float32)
        dense[q_ids] = q_w
        gathered = dense[self.word_ids[lo:hi]]
        return np.sum(np.minimum(gathered, self.word_w[lo:hi]) * (self.word_w[lo:hi] > 0), axis=1)

    def scores_at(self, v, idxs) -> np.ndarray:
        q_ids, q_w = v
        ii = np.asarray(idxs, np.int64)
        if ii.size == 0:
            return np.empty(0, np.float32)
        dense = np.zeros(PQ_VOCAB, np.float32)
        dense[q_ids] = q_w
        gathered = dense[self.word_ids[ii]]
        return np.sum(np.minimum(gathered, self.word_w[ii]) * (self.word_w[ii] > 0), axis=1)

    def packed_device(self, pad_to: Optional[int] = None):
        """Packed (ids, weights) device tensors for ``score_packed_device``."""
        n = self.count if pad_to is None else pad_to
        ids = np.zeros((n, self.M), np.int32)
        w = np.zeros((n, self.M), np.float32)
        ids[: self.count] = self.word_ids[: self.count]
        w[: self.count] = self.word_w[: self.count]
        return torch.as_tensor(ids, device=self.device), torch.as_tensor(w, device=self.device)


def score_packed_device(q_ids: torch.Tensor, q_w: torch.Tensor, db_ids: torch.Tensor,
                        db_w: torch.Tensor) -> torch.Tensor:
    """L1 BoW scores (N,) of one sparse query (M,) against the packed
    database (N, M): dense-scatter the query, gather, min-intersect, row-sum."""
    # the query's dense vector; where an id repeats (the zero padding of a
    # row repeats id 0) the last entry wins, as a sequential scatter has it,
    # and deterministically on the card
    ids = q_ids.long()
    last = torch.full((PQ_VOCAB,), -1, dtype=torch.int64, device=db_w.device).scatter_reduce_(
        0, ids, torch.arange(ids.shape[0], device=db_w.device), reduce="amax")
    dense = torch.where(last >= 0, q_w.to(torch.float32)[torch.clamp(last, min=0)],
                        torch.zeros((), dtype=torch.float32, device=db_w.device))
    gathered = dense[db_ids.long()]  # (N, M)
    return torch.sum(torch.minimum(gathered, db_w) * (db_w > 0), dim=1)


def score_packed_topk_device(q_ids, q_w, db_ids, db_w, n, k: int = 4):
    """(scores, indices) of the top ``k`` among entries [0, n) (the rest
    scored −inf), highest first and, among equal scores, the lower index
    first (``lax.top_k``'s order): a stable descending sort, not
    ``torch.topk``, whose tie order on the card is unspecified."""
    s = score_packed_device(q_ids, q_w, db_ids, db_w)
    s = torch.where(torch.arange(s.shape[0], device=s.device) < n, s,
                    torch.full_like(s, -float("inf")))
    vals, idx = torch.sort(s, descending=True, stable=True)
    return vals[:k], idx[:k].to(torch.int32)
