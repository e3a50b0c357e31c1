"""Bag-of-words place recognition: the PyTorch port against the JAX package
(CPU).

``ops/bow`` on seeded sign descriptors (the scenes of ``tests/test_bow.py``)
and the keyframe store's two-stage retrieval above a lowered
``bow_threshold`` (a store built like ``tests/test_bow_scale.py``'s, at
12 keyframes of 256 keypoints).  The JAX package seeds k-means with
``jax.random.choice(PRNGKey(0), ..., replace=False, p=p)``; the port takes
the seed indices as an input, and these tests replay that draw.

Tolerances: vocabulary words, idf and signatures within 1e-5; retrieval
order, shortlists, exact scores and loop candidates identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimot_track_tpu.ops import bow as jbow
from multimot_track_tpu.pipeline import keyframes as jkf
from multimot_track_tpu_torch.ops import bow as tbow
from multimot_track_tpu_torch.pipeline import keyframes as tkf

torch.set_num_threads(1)

TOL = 1e-5
N_KP = 256


def jax_vocab_seed(p: torch.Tensor, n_words: int) -> torch.Tensor:
    """The JAX store's k-means seed draw, replayed (a ``vocab_seed`` hook)."""
    idx = jax.random.choice(jax.random.PRNGKey(0), p.shape[0], (n_words,), replace=False,
                            p=jnp.asarray(p.cpu().numpy()))
    return torch.from_numpy(np.array(idx)).to(torch.int64)


def _scenes(rng, n_scenes=6, per_scene=128, flip=0.05):
    protos = [rng.choice([-1, 1], size=(per_scene, 256)).astype(np.int8)
              for _ in range(n_scenes)]

    def observe(k):
        d = protos[k].copy()
        d[rng.random(d.shape) < flip] *= -1
        return d

    return observe


@pytest.mark.parametrize("n_words", [256, 32])
def test_vocabulary_signature_retrieve_match_jax(n_words):
    rng = np.random.default_rng(71)
    observe = _scenes(rng)
    train = np.concatenate([observe(k) for k in range(6)])
    valid = rng.random(len(train)) < 0.95
    key = jax.random.PRNGKey(0)
    vj = jbow.train_vocabulary(key, jnp.asarray(train), jnp.asarray(valid), n_words=n_words)
    p = tbow.seed_probabilities(torch.from_numpy(valid))
    np.testing.assert_array_equal(
        p.numpy(), np.asarray(jnp.asarray(valid, jnp.float32) / max(valid.sum(), 1)))
    init = jax.random.choice(key, len(train), (n_words,), replace=False, p=jnp.asarray(p.numpy()))
    vt = tbow.train_vocabulary(torch.from_numpy(np.array(init)).long(),
                               torch.from_numpy(train), torch.from_numpy(valid), n_words=n_words)
    np.testing.assert_allclose(vt.words.numpy(), np.asarray(vj.words), atol=TOL)
    np.testing.assert_allclose(vt.idf.numpy(), np.asarray(vj.idf), atol=TOL)

    ones = np.ones(128, bool)
    db = [observe(k) for k in range(6)]
    sj = np.stack([np.asarray(jbow.signature(vj, jnp.asarray(d), jnp.asarray(ones)))
                   for d in db])
    st = torch.stack([tbow.signature(vt, torch.from_numpy(d), torch.from_numpy(ones))
                      for d in db])
    np.testing.assert_allclose(st.numpy(), sj, atol=TOL)
    for k in range(6):
        q = observe(k)
        rj = np.asarray(jbow.retrieve(jbow.signature(vj, jnp.asarray(q), jnp.asarray(ones)),
                                      jnp.asarray(sj)))
        rt = tbow.retrieve(tbow.signature(vt, torch.from_numpy(q), torch.from_numpy(ones)), st)
        np.testing.assert_allclose(rt.numpy(), rj, atol=TOL)
        np.testing.assert_array_equal(np.argsort(rt.numpy())[::-1], np.argsort(rj)[::-1])
        assert int(np.argmax(rj)) == k


def test_default_seed_draw():
    """The port's own draw: distinct, valid rows first, the same every time."""
    valid = torch.zeros(500, dtype=torch.bool)
    valid[::3] = True
    p = tbow.seed_probabilities(valid)
    a = tbow.draw_seed_indices(p, 100, torch.Generator().manual_seed(0))
    b = tbow.draw_seed_indices(p, 100, torch.Generator().manual_seed(0))
    assert torch.equal(a, b) and len(set(a.tolist())) == 100
    assert bool(valid[a].all())
    # fewer valid rows than words: the valid ones, then the others
    c = tbow.draw_seed_indices(p, 200, torch.Generator().manual_seed(0))
    assert bool(valid[c[:167]].all()) and not bool(valid[c[167:]].any())


def _store_pair(n_kf=12, threshold=6, seed=11):
    """A JAX and a port store over the same keyframes, and a noisy revisit
    of keyframe 3 as the query."""
    rng = np.random.default_rng(seed)
    descs = [np.where(rng.random((N_KP, 256)) < 0.5, 1, -1).astype(np.int8)
             for _ in range(n_kf)]
    js = jkf.KeyframeStore(capacity=1024, min_gap=1, bow_threshold=threshold)
    ts = tkf.KeyframeStore(capacity=1024, min_gap=1, bow_threshold=threshold, device="cpu",
                           vocab_seed=jax_vocab_seed)
    for i, d in enumerate(descs):
        kw = dict(index=i, Tcw=np.eye(4, dtype=np.float32),
                  uv=rng.uniform(0, 400, (N_KP, 2)).astype(np.float32), desc=d,
                  valid=np.ones(N_KP, bool), Xw=rng.normal(size=(N_KP, 3)).astype(np.float32))
        js.maybe_add(jkf.Keyframe(**kw))
        ts.maybe_add(tkf.Keyframe(**{k: np.copy(v) if isinstance(v, np.ndarray) else v
                                     for k, v in kw.items()}))
    q = descs[3].copy()
    q = np.where(rng.random(q.shape) < 0.05, -q, q).astype(np.int8)
    return js, ts, q


def test_store_bow_path_matches_jax():
    js, ts, q = _store_pair()
    assert len(ts.frames) > ts.bow_threshold
    ones = np.ones(N_KP, bool)
    n_exact = []
    pair_count = ts._pair_count
    ts._pair_count = lambda *a, **kw: n_exact.append(1) or pair_count(*a, **kw)
    sj = js.similarity_scores(jnp.asarray(q), jnp.asarray(ones))
    st = ts.similarity_scores(torch.from_numpy(q), torch.from_numpy(ones))
    np.testing.assert_allclose(ts._voc.words.numpy(), np.asarray(js._voc.words), atol=TOL)
    np.testing.assert_array_equal(st, sj)
    # exact scoring ran on the shortlist only
    assert len(n_exact) == ts.bow_shortlist
    assert 0 < (st > 0).sum() <= ts.bow_shortlist
    assert int(np.argmax(st)) == 3 and st[3] > 100
    # signatures are cached per keyframe, and equal the JAX package's
    for kf_t, kf_j in zip(ts.frames[:10], js.frames[:10]):
        np.testing.assert_allclose(ts._sigs[id(kf_t)][1].numpy(), js._sigs[id(kf_j)],
                                   atol=TOL)
    n_exact.clear()
    assert ts.detect_loop(torch.from_numpy(q), torch.from_numpy(ones)) == \
        js.detect_loop(jnp.asarray(q), jnp.asarray(ones)) == 3
    assert len(n_exact) == ts.bow_shortlist


def test_store_signature_cache_survives_eviction():
    """An evicted keyframe's cache entry is never read for a new keyframe."""
    _, ts, q = _store_pair(n_kf=10)
    ones = torch.ones(N_KP, dtype=torch.bool)
    ts.similarity_scores(torch.from_numpy(q), ones)
    old = ts.frames.pop(5)
    new = tkf.Keyframe(index=99, Tcw=np.eye(4, dtype=np.float32), uv=old.uv,
                       desc=-old.desc, valid=old.valid, Xw=old.Xw)
    ts.frames.insert(5, new)
    ts.similarity_scores(torch.from_numpy(q), ones)
    sig_new = ts._sigs[id(new)][1]
    assert ts._sigs[id(new)][0] is new
    assert torch.equal(sig_new, tbow.signature(ts._voc, torch.from_numpy(new.desc), ones))
