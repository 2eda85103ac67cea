"""Word2Vec in the port held against ``h2o_tpu``'s on the CPU.

The corpora of ``test_matrix_algos.py``: two topic clusters of four
words in 400 sentences of six (``test_word2vec_synonyms``) and the
repeated ``a b c`` sequence (``test_word2vec_transform``), as string
columns, go to ``h2o_tpu.models.word2vec.Word2Vec`` and to the port's
``Word2Vec(device="cpu")``.  Each package's step is wrapped to record
what it is given.

Held: the vocabulary, every step's centers, targets (context and negatives) and
learning rate equal (the host draws are the same ``default_rng`` calls in the
same order); Win and Wout after each of the first two steps within 1e-6
relative (1e-9 absolute: a step adds products of draws, summed in another
order; Wout starts at 0, so the first step moves Wout alone and the second Win
too).  After all epochs the embeddings have taken the two packages' rounding
through every step: the reference test's synonym claim is held on both, and the
drift (the largest |Win| gap over the largest |Win|) is printed by
``tools/torch_port_probes.py word2vec``.  The converter's ``find_synonyms`` and
``transform`` equal the reference's on the same vectors.
"""

import os
import tempfile

import numpy as np
import pytest

import h2o_tpu.models.word2vec as jw2v
from h2o_tpu.core.frame import Frame as JFrame, T_STR as J_STR, Vec as JVec

import h2o_tpu_torch.models.word2vec as pw2v
from h2o_tpu_torch.core.frame import T_CAT, T_STR, Frame, Vec
from h2o_tpu_torch.models.model import Model
from h2o_tpu_torch.models.word2vec import (Word2Vec, Word2VecModel,
                                           word2vec_from_jax_output)
from h2o_tpu_torch.core.store import unpublish_on_exit


@pytest.fixture(autouse=True)
def _unpublish():
    """What a test publishes in the port's DKV is removed after it."""
    with unpublish_on_exit():
        yield


pytestmark = pytest.mark.shared_dkv

ANIMALS = ["cat", "dog", "horse", "cow"]
TOOLS = ["hammer", "wrench", "drill", "saw"]


def _topics():
    rng = np.random.default_rng(42)
    toks = []
    for _ in range(400):
        group = ANIMALS if rng.uniform() < 0.5 else TOOLS
        toks.extend(group[rng.integers(len(group))] for _ in range(6))
        toks.append(None)
    return toks


def _pair(toks):
    return (JFrame(["tokens"], [JVec(toks, J_STR)]),
            Frame(["tokens"], [Vec(toks, T_STR)]))


SYN = dict(vec_size=16, epochs=8, min_word_freq=2, window_size=3, seed=5)


def _record(monkeypatch, module, name, jax_side):
    """Wrap a package's step: the host inputs of every step, and copies
    of (Win, Wout) after each of the first two (Wout starts at 0, so the
    first step moves Wout alone)."""
    seen = {"inputs": [], "snaps": []}
    orig = getattr(module, name)

    def wrap(Win, Wout, c, t, labels, lr):
        seen["inputs"].append((np.asarray(c).copy(), np.asarray(t).copy(),
                               float(lr)))
        out = orig(Win, Wout, c, t, labels, lr)
        if len(seen["snaps"]) < 2:
            w = out if jax_side else (Win, Wout)
            seen["snaps"].append(tuple(np.array(a) for a in w))
        return out
    monkeypatch.setattr(module, name, wrap)
    return seen


@pytest.fixture(scope="module")
def topic_fits(cl):
    mp = pytest.MonkeyPatch()
    js = _record(mp, jw2v, "_sgns_step", True)
    ps = _record(mp, pw2v, "sgns_step", False)
    jf, pf = _pair(_topics())
    try:
        jm = jw2v.Word2Vec(**SYN).train(training_frame=jf)
        with pytest.warns(UserWarning, match="negative sampling"):
            pm = Word2Vec(device="cpu", **SYN).train(training_frame=pf)
    finally:
        mp.undo()
    return jf, pf, jm, pm, js, ps


def test_vocab_pairs_and_negatives_equal(topic_fits):
    _, _, jm, pm, js, ps = topic_fits
    assert pm.output["words"] == jm.output["words"]
    assert pm.output["vocab"] == jm.output["vocab"]
    assert len(ps["inputs"]) == len(js["inputs"]) == 8   # an epoch a step
    for (pc, pt, plr), (jc, jt, jlr) in zip(ps["inputs"], js["inputs"]):
        np.testing.assert_array_equal(pc, jc)
        np.testing.assert_array_equal(pt, jt)
        assert np.float32(plr) == np.float32(jlr)


def test_small_batches_equal(cl, monkeypatch):
    """Batches of 256 without subsampling (many steps an epoch, a
    padded tail batch, the learning rate's decay): every step's inputs
    equal, Win and Wout after the first two steps within 1e-6
    relative."""
    kw = dict(SYN, epochs=2, batch_size=256, negative_samples=3,
              sent_sample_rate=0.0)
    js = _record(monkeypatch, jw2v, "_sgns_step", True)
    ps = _record(monkeypatch, pw2v, "sgns_step", False)
    jf, pf = _pair(_topics())
    jw2v.Word2Vec(**kw).train(training_frame=jf)
    with pytest.warns(UserWarning):
        Word2Vec(device="cpu", **kw).train(training_frame=pf)
    assert len(ps["inputs"]) == len(js["inputs"]) > 20
    for (pc, pt, plr), (jc, jt, jlr) in zip(ps["inputs"], js["inputs"]):
        np.testing.assert_array_equal(pc, jc)
        np.testing.assert_array_equal(pt, jt)
        assert np.float32(plr) == np.float32(jlr)
    _first_steps_close(ps, js)


def _first_steps_close(ps, js):
    assert len(ps["snaps"]) == len(js["snaps"]) == 2
    for pw, jw in zip(ps["snaps"], js["snaps"]):
        for a, b in zip(pw, jw):            # Win, Wout
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)
    assert np.abs(ps["snaps"][1][0] - ps["snaps"][0][0]).max() > 0


def test_first_steps_equal(topic_fits):
    *_, js, ps = topic_fits
    _first_steps_close(ps, js)


def test_synonym_claims_after_all_epochs(topic_fits):
    """test_word2vec_synonyms's claims, on both packages."""
    _, _, jm, pm, _, _ = topic_fits
    for m in (pm, jm):
        assert len(m.output["words"]) == 8
        syn = m.find_synonyms("cat", 3)
        assert len(syn) == 3
        assert sum(w in ANIMALS for w in list(syn)[:2]) >= 1, syn
    tm = pm.output["training_metrics"]
    assert tm.kind == "word2vec" and tm["vocab_size"] == 8 and \
        tm["vec_size"] == 16


def test_transform_matches_reference(cl):
    """test_word2vec_transform's corpus: NONE a row a token, AVERAGE a
    row a sequence, equal to the reference's within 1e-5 relative."""
    toks = ["a", "b", "c", None] * 50
    jf, pf = _pair(toks)
    kw = dict(vec_size=8, epochs=2, min_word_freq=1, window_size=2, seed=1)
    jm = jw2v.Word2Vec(**kw).train(training_frame=jf)
    with pytest.warns(UserWarning):
        pm = Word2Vec(device="cpu", **kw).train(training_frame=pf)
    for agg, rows in (("NONE", len(toks)), ("AVERAGE", 50)):
        t = pm.transform(pf, aggregate_method=agg)
        assert t.nrows == rows and t.ncols == 8
        got = np.stack([t.vec(c).to_numpy() for c in t.names], axis=1)
        jt = jm.transform(jf, aggregate_method=agg)
        want = np.stack([np.asarray(jt.vec(c).to_numpy())[:rows]
                         for c in jt.names], axis=1)
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7)
    assert np.isfinite(pm.transform(pf, "AVERAGE").vec("C1").to_numpy()).all()


def test_converter_and_categorical_tokens(topic_fits):
    jf, pf, jm, _, _, _ = topic_fits
    cm = word2vec_from_jax_output(jm.output, jm.params, device="cpu")
    assert isinstance(cm, Word2VecModel)
    for w in ("cat", "drill"):
        assert cm.find_synonyms(w, 5) == jm.find_synonyms(w, 5)
    assert cm.find_synonyms("zebra") == {}
    np.testing.assert_array_equal(cm.word_vector("saw"),
                                  np.asarray(jm.word_vector("saw")))
    # a categorical token column reads as its levels
    toks = _topics()
    dom = sorted(set(t for t in toks if t))
    codes = np.array([-1 if t is None else dom.index(t) for t in toks],
                     np.int32)
    a = cm.transform(Frame(["t"], [Vec(codes, T_CAT, domain=dom)]))
    b = cm.transform(pf)
    np.testing.assert_array_equal(
        np.stack([a.vec(c).to_numpy() for c in a.names]),
        np.stack([b.vec(c).to_numpy() for c in b.names]))


def test_save_load(topic_fits):
    _, pf, _, pm, _, _ = topic_fits
    with tempfile.TemporaryDirectory() as d:
        m2 = Model.load(pm.save(os.path.join(d, "w2v.bin")), device="cpu")
    assert isinstance(m2, Word2VecModel)
    assert m2.find_synonyms("dog", 4) == pm.find_synonyms("dog", 4)
    with pytest.raises(NotImplementedError, match="transform"):
        m2.predict_raw(pf)


@pytest.mark.parametrize("kw,err", [
    (dict(word_model="CBOW"), "word_model"),
    (dict(norm_model="Softmax"), "norm_model"),
    (dict(min_word_freq=10 ** 6), "min_word_freq")],
    ids=["cbow", "norm_model", "no_words"])
def test_refusals(kw, err):
    toks = _topics()
    if err == "min_word_freq":
        with pytest.warns(UserWarning), pytest.raises(ValueError, match=err):
            Word2Vec(device="cpu", **kw).train(
                training_frame=Frame(["t"], [Vec(toks, T_STR)]))
        return
    with pytest.raises(ValueError, match=err):
        Word2Vec(device="cpu", **kw)
    # the port accepts the reference's default NegSampling, which the
    # reference itself refuses (it accepts HSM only)
    assert Word2Vec(device="cpu", norm_model="NegSampling").params[
        "norm_model"] == "NegSampling"
    with pytest.raises(ValueError, match="norm_model"):
        jw2v.Word2Vec(norm_model="NegSampling")
