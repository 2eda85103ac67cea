"""Word2Vec — port of ``h2o_tpu/models/word2vec.py`` (``_sgns_step``
:35-52, ``_tokens_of`` :55-66, ``Word2VecModel`` :69-156, ``Word2Vec``
:159-267).

Skip-gram with negative sampling, as the reference trains it in place
of H2O-3's hierarchical softmax.  The training frame is one string (or
categorical) column of tokens, NA rows ending sentences.  Everything
that draws stays on the host, from the same ``numpy.random.default_rng
(seed)`` calls in the same order as the reference: the vocabulary
(``min_word_freq``, most frequent first), the sentences, each epoch's
subsampling (``sent_sample_rate``), the window pairs (a window of 1 to
``window_size`` a word), their permutation and each batch's negatives
(unigram^0.75).  So the pairs and negatives are the reference's.  Win
starts as ``(uniform(key, (V, D)) - 0.5) / D`` (``ops/prng``, bitwise),
Wout at 0; the learning rate decays linearly to 1e-4 of its start over
the steps.

A step runs on the model's device: the gather of the centers' and
targets' rows, a batched dot, the sigmoid, and two ``index_add_``
scatters whose indices repeat.  On CUDA, ``index_add_`` adds repeated
indices in no fixed order, so two runs on the card may differ in the
last bits of the embeddings (the reference's scatter is XLA's, not a
Pallas kernel).  ``find_synonyms`` (cosine) and ``transform`` (NONE:
a vector a token; AVERAGE: a mean vector an NA-delimited sequence) run
on the host vectors.  ``recovery_dir`` snapshots the build
(``models/model.py``), as the reference's does; no iteration checkpoint.
"""

from __future__ import annotations

import warnings
from collections import Counter
from typing import Dict, List, Optional

import numpy as np
import torch

from h2o_tpu_torch.core.device import DeviceLike, cloud
from h2o_tpu_torch.core.frame import Frame, Vec
from h2o_tpu_torch.models import metrics as mm
from h2o_tpu_torch.models.model import Model, ModelBuilder
from h2o_tpu_torch.ops import prng

EPS = 1e-10
NEG_SAMPLING_NOTICE = (
    "word2vec trains skip-gram with negative sampling on this engine (the "
    "reference's hierarchical softmax is replaced; embeddings are "
    "equivalent quality, not bit-identical)")


def sgns_step(Win: torch.Tensor, Wout: torch.Tensor, center: torch.Tensor,
              targets: torch.Tensor, labels: torch.Tensor,
              lr: torch.Tensor) -> None:
    """One skip-gram negative-sampling SGD step, in place.  ``center``
    (B,) int64, ``targets`` (B, 1 + neg) int64 (the true context first),
    ``labels`` (B, 1 + neg) float32 (1 for the context, 0 for the
    negatives), ``lr`` a 0-d float32 tensor."""
    v = Win[center]                                     # (B, D)
    u = Wout[targets]                                   # (B, N, D)
    score = torch.einsum("bd,bnd->bn", v, u)
    g = (torch.sigmoid(score) - labels) * lr            # (B, N)
    dv = torch.einsum("bn,bnd->bd", g, u)
    du = g[:, :, None] * v[:, None, :]
    Win.index_add_(0, center, -dv)
    Wout.index_add_(0, targets.reshape(-1), -du.reshape(-1, du.shape[-1]))


def _tokens_of(frame: Frame, col: Optional[str] = None
               ) -> List[Optional[str]]:
    v = frame.vec(col or frame.names[0])
    if v.host_data is not None:                         # string column
        return [None if t is None or t != t or t == "" else str(t)
                for t in v.host_data]
    if v.is_categorical:
        dom = v.domain
        return [None if c < 0 else dom[int(c)] for c in v.data]
    raise ValueError("Word2Vec wants a string/categorical token column")


class Word2VecModel(Model):
    algo = "word2vec"

    def _vectors(self) -> np.ndarray:
        return self.output["vectors"]

    def word_vector(self, word: str) -> Optional[np.ndarray]:
        idx = self.output["vocab"].get(word)
        return None if idx is None else self._vectors()[idx]

    def find_synonyms(self, word: str, count: int = 20) -> Dict[str, float]:
        """The ``count`` words of largest cosine similarity to ``word``
        (Word2VecModel.findSynonyms); {} for a word not in the
        vocabulary."""
        idx = self.output["vocab"].get(word)
        if idx is None:
            return {}
        W = self._vectors()
        q = W[idx]
        sims = W @ q / (np.linalg.norm(W, axis=1) *
                        max(np.linalg.norm(q), EPS) + EPS)
        words = self.output["words"]
        out = {}
        for i in np.argsort(-sims):
            if int(i) == idx:
                continue
            out[words[int(i)]] = float(sims[int(i)])
            if len(out) >= count:
                break
        return out

    def transform(self, frame: Frame,
                  aggregate_method: str = "NONE") -> Frame:
        """Tokens to vectors (``C1..CD``): a row a token (NaN for NA and
        unknown words), or with ``AVERAGE`` a row a NA-delimited
        sequence, the mean of its known words' vectors."""
        toks = _tokens_of(frame)
        vocab = self.output["vocab"]
        W = self._vectors()
        D = W.shape[1]
        if aggregate_method.upper() == "AVERAGE":
            seqs, cur = [], []
            for t in toks:
                if t is None:
                    seqs.append(cur)
                    cur = []
                else:
                    cur.append(t)
            if cur:
                seqs.append(cur)
            rows = []
            for s in seqs:
                vs = [W[vocab[t]] for t in s if t in vocab]
                rows.append(np.mean(vs, axis=0) if vs
                            else np.full(D, np.nan))
            M = np.asarray(rows, np.float32) if rows else \
                np.zeros((0, D), np.float32)
        else:
            M = np.full((len(toks), D), np.nan, np.float32)
            for i, t in enumerate(toks):
                if t is not None and t in vocab:
                    M[i] = W[vocab[t]]
        return Frame([f"C{j + 1}" for j in range(D)],
                     [Vec(M[:, j]) for j in range(D)])

    def predict_raw(self, frame: Frame):
        raise NotImplementedError("Word2Vec has no predict; use transform")

    def model_metrics(self, frame: Frame = None) -> mm.ModelMetrics:
        return mm.word2vec_metrics(len(self.output["words"]),
                                   self.output["vec_size"])


def word2vec_from_jax_output(output: Dict, params: Dict,
                             device: DeviceLike = None) -> Word2VecModel:
    """The port's ``Word2VecModel`` from an ``h2o_tpu`` Word2Vec's output
    dict (arrays as numpy)."""
    words = list(output["words"])
    out = dict(words=words, vocab={w: i for i, w in enumerate(words)},
               vectors=np.array(output["vectors"], np.float32),
               vec_size=int(output["vec_size"]),
               epochs_run=int(output["epochs_run"]),
               model_category="WordEmbedding")
    m = Word2VecModel(dict(params), out, cloud(device))
    out["training_metrics"] = m.model_metrics()
    return m


class Word2Vec(ModelBuilder):
    algo = "word2vec"
    model_cls = Word2VecModel
    supervised = False
    supports_cv = False

    # the hierarchical softmax is replaced by negative sampling (module
    # docstring); SkipGram is the one architecture.  The reference
    # accepts only HSM and so refuses its own default NegSampling, the
    # estimator both train; the port accepts both
    ENGINE_FIXED = {
        "word_model": ("SkipGram",),
        "norm_model": ("HSM", "NegSampling"),
    }

    def default_params(self) -> Dict:
        p = super().default_params()
        p.update(vec_size=100, window_size=5, sent_sample_rate=1e-3,
                 epochs=5, min_word_freq=5, init_learning_rate=0.025,
                 negative_samples=5, batch_size=4096,
                 word_model="SkipGram", norm_model="NegSampling")
        return p

    @staticmethod
    def vocabulary(toks: List[Optional[str]], min_word_freq: int):
        """(words, vocab, freqs): the words seen at least
        ``min_word_freq`` times, most frequent first (ties in first-seen
        order), their indices and counts."""
        counts = Counter(t for t in toks if t is not None)
        words = sorted([w for w, c in counts.items() if c >= min_word_freq],
                       key=lambda w: -counts[w])
        if not words:
            raise ValueError("no words pass min_word_freq")
        return (words, {w: i for i, w in enumerate(words)},
                np.array([counts[w] for w in words], np.float64))

    @staticmethod
    def sentences(toks: List[Optional[str]], vocab: Dict[str, int]
                  ) -> List[List[int]]:
        """The NA-delimited sentences as vocabulary indices (unknown
        words dropped), those of two words or more."""
        sents: List[List[int]] = [[]]
        for t in toks:
            if t is None:
                if sents[-1]:
                    sents.append([])
            elif t in vocab:
                sents[-1].append(vocab[t])
        return [s for s in sents if len(s) > 1]

    @staticmethod
    def epoch_pairs(sents: List[List[int]], keep_p: np.ndarray,
                    window: int, rng: np.random.Generator):
        """One epoch's (centers, contexts), int32, permuted: each word
        kept with its subsampling probability, paired with the kept
        words within a window of 1..``window`` drawn for it."""
        centers, contexts = [], []
        for s in sents:
            kept = [w for w in s if rng.random() < keep_p[w]]
            for i, c in enumerate(kept):
                b = rng.integers(1, window + 1)
                for j in range(max(0, i - b), min(len(kept), i + b + 1)):
                    if j != i:
                        centers.append(c)
                        contexts.append(kept[j])
        if not centers:
            return None, None
        centers = np.asarray(centers, np.int32)
        contexts = np.asarray(contexts, np.int32)
        perm = rng.permutation(len(centers))
        return centers[perm], contexts[perm]

    def _fit(self, x: List[str], y: Optional[str], train: Frame,
             valid: Optional[Frame] = None) -> Word2VecModel:
        p = self.params
        dev = self.device
        warnings.warn(NEG_SAMPLING_NOTICE)
        toks = _tokens_of(train)
        seed = int(p.get("seed") or -1)
        rng = np.random.default_rng(seed if seed >= 0 else None)
        words, vocab, freqs = self.vocabulary(toks, int(p["min_word_freq"]))
        sents = self.sentences(toks, vocab)

        V, D = len(words), int(p["vec_size"])
        win0 = (prng.uniform(self.rng_key(), (V, D), "cpu").numpy() - 0.5) / D
        Win = torch.from_numpy(np.ascontiguousarray(win0, np.float32)).to(dev)
        Wout = torch.zeros((V, D), dtype=torch.float32, device=dev)

        neg_p = freqs ** 0.75
        neg_p /= neg_p.sum()
        window = int(p["window_size"])
        ssr = float(p["sent_sample_rate"])
        keep_p = np.ones(V)
        if ssr > 0:
            f = freqs / freqs.sum()
            keep_p = np.minimum((np.sqrt(f / ssr) + 1) * ssr / f, 1.0)
        neg = int(p["negative_samples"])
        B = int(p["batch_size"])
        lr0 = float(p["init_learning_rate"])
        epochs = int(p["epochs"])
        labels = torch.zeros((B, 1 + neg), dtype=torch.float32, device=dev)
        labels[:, 0] = 1.0

        step_i, total_steps = 0, None
        for ep in range(epochs):
            centers, contexts = self.epoch_pairs(sents, keep_p, window, rng)
            if centers is None:
                continue
            nb = (len(centers) + B - 1) // B
            if total_steps is None:
                total_steps = nb * epochs
            for bi in range(nb):
                c = centers[bi * B:(bi + 1) * B]
                o = contexts[bi * B:(bi + 1) * B]
                if len(c) < B:          # the tail batch padded, as the
                    padn = B - len(c)   # reference pads its static shape
                    c = np.concatenate([c, c[:1].repeat(padn)])
                    o = np.concatenate([o, o[:1].repeat(padn)])
                negs = rng.choice(V, size=(B, neg), p=neg_p).astype(np.int32)
                targets = np.concatenate([o[:, None], negs], axis=1)
                lr = max(lr0 * (1 - step_i / max(total_steps, 1)),
                         lr0 * 1e-4)
                sgns_step(Win, Wout,
                          torch.from_numpy(c.astype(np.int64)).to(dev),
                          torch.from_numpy(targets.astype(np.int64)).to(dev),
                          labels, torch.tensor(lr, dtype=torch.float32,
                                               device=dev))
                step_i += 1
            self._update(0.1 + 0.85 * (ep + 1) / epochs,
                         f"epoch {ep + 1}/{epochs} ({len(centers)} pairs)")

        out = dict(words=words, vocab=vocab, vectors=Win.cpu().numpy(),
                   vec_size=D, epochs_run=epochs,
                   model_category="WordEmbedding")
        model = self.model_cls(dict(p), out, dev)
        out["training_metrics"] = model.model_metrics()
        return model
