"""The port's loop closure against the JAX package's, in float64 on the CPU
with the kernels' plain versions.

Inputs: the JAX loop-closure tests' rendered revisit (one 200x150 camera, 8
traverse keyframes and 3 revisits, accumulating VIO drift;
``torch_parity.revisit_exports``), fed as the same keyframe exports to a
JAX ``LoopCloser`` and a port one (``RECENCY_EXCLUSION`` lowered to 5 in
both modules, as the JAX tests do), the port drawing the JAX closer's P3P
samples; the JAX tests' drifted 40-node graph (``_make_drifted_graph``);
descriptors and vocabularies from numpy seeds.

Tolerances: descriptors, word ids, vocabularies, k-medoids centroids, idf
weights, database rows, loops, inlier counts and funnel counters exact; BoW
scores within 1e-6 (the host scores are the same numpy on identical rows;
the flat database's device histogram sums in another order); pose graph
within 1e-8; the whole closer's optimized path, drift and loop relatives
within 1e-6 m (P3P poses, refined twice by GN, then 30 pose-graph GN
iterations); host modules (health, switching, global map, frustum PLY)
equal.
"""
import contextlib
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import svin_tpu.loopclosure.loop_closure as jlc
import svin_tpu_torch.loopclosure.loop_closure as tlc
from svin_tpu.kinematics import Transformation as JT
from svin_tpu.kinematics import quaternion as jquat
from svin_tpu.loopclosure import frustums as jfr
from svin_tpu.loopclosure import globalmap as jgm
from svin_tpu.loopclosure import posegraph as jpg
from svin_tpu.loopclosure import retrieval as jret
from svin_tpu.loopclosure import switching as jsw
from svin_tpu.ops import hamming as jham
from svin_tpu.pipeline.config import HealthConfig as JaxHealthConfig
from svin_tpu.pipeline.config import VioConfig as JaxVioConfig
from svin_tpu_torch.cameras import make_camera
from svin_tpu_torch.convert import (config_from_numpy, posegraph_from_numpy,
                                    product_vocabulary_from_numpy, vocabulary_from_numpy)
from svin_tpu_torch.kinematics import Transformation as TT
from svin_tpu_torch.loopclosure import frustums as tfr
from svin_tpu_torch.loopclosure import globalmap as tgm
from svin_tpu_torch.loopclosure import posegraph as tpg
from svin_tpu_torch.loopclosure import retrieval as tret
from svin_tpu_torch.loopclosure import switching as tsw
from svin_tpu_torch.pipeline.config import HealthConfig
from svin_tpu_torch.pipeline.outputs import DebugOutputDirs
from test_loopclosure import _make_drifted_graph
from torch_parity import jax_p3p_draws, revisit_exports

torch.set_num_threads(1)


@contextlib.contextmanager
def recency(n):
    """Both packages' RECENCY_EXCLUSION set to ``n`` (module globals read at
    call time), restored after."""
    old = jlc.RECENCY_EXCLUSION, tlc.RECENCY_EXCLUSION
    jlc.RECENCY_EXCLUSION = tlc.RECENCY_EXCLUSION = n
    try:
        yield
    finally:
        jlc.RECENCY_EXCLUSION, tlc.RECENCY_EXCLUSION = old


def port_camera():
    return make_camera(200, 150, 160.0, 160.0, 100.0, 75.0, model="none")


def jax_camera():
    from svin_tpu.cameras import make_camera as jax_make_camera

    return jax_make_camera(200, 150, 160.0, 160.0, 100.0, 75.0, model="none")


def jax_cfg(mode="4dof"):
    cfg = JaxVioConfig()
    cfg.loop_closure.min_correspondences = 12
    cfg.loop_closure.pgo_mode = mode
    return cfg


def port_closer(cfg, **kw):
    return tlc.LoopCloser(port_camera(), config_from_numpy(cfg), device="cpu",
                          draw_p3p=jax_p3p_draws, **kw)


@pytest.fixture(scope="module")
def revisit():
    return revisit_exports()


@pytest.fixture(scope="module")
def runs(revisit, tmp_path_factory):
    """Both packages' closers over the revisit, in 4-DoF and 6-DoF (the
    port's 4-DoF one in debug mode, writing its stage images)."""
    cam, exports, gt = revisit
    out = {}
    with recency(5):
        for mode in ("4dof", "6dof"):
            jc = jlc.LoopCloser(cam, jax_cfg(mode))
            jl = [jc.add_keyframe(e) for e in exports]
            tcfg = config_from_numpy(jax_cfg(mode))
            tcfg.debug_mode = mode == "4dof"
            tc = tlc.LoopCloser(port_camera(), tcfg, device="cpu", draw_p3p=jax_p3p_draws)
            dbg = None
            if tcfg.debug_mode:
                dbg = str(tmp_path_factory.mktemp("dbg"))
                tc.debug = DebugOutputDirs(dbg)
            tl = [tc.add_keyframe(e) for e in exports]
            out[mode] = dict(jc=jc, jl=jl, tc=tc, tl=tl, dbg=dbg)
    return out


def _loops(ls):
    return [(lp.query_index, lp.match_index, lp.num_inliers) for lp in ls if lp is not None]


@pytest.mark.parametrize("mode", ["4dof", "6dof"])
def test_closer_matches_jax_on_the_rendered_revisit(runs, mode):
    r = runs[mode]
    jc, tc = r["jc"], r["tc"]
    assert _loops(r["tl"]) == _loops(r["jl"])
    assert len(_loops(r["tl"])) >= 2 and any(q >= 8 for q, _, _ in _loops(r["tl"]))
    assert tc.stats == jc.stats
    for a, b in zip(r["tl"], r["jl"]):
        if b is not None:
            np.testing.assert_allclose(a.rel_t, b.rel_t, rtol=0, atol=1e-6)
            assert abs(a.rel_yaw - b.rel_yaw) < 1e-6
            np.testing.assert_array_equal(a.uv_query, b.uv_query)
    np.testing.assert_allclose(tc.optimized_path(), jc.optimized_path(), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tc.nodes.yaw, jc.nodes.yaw, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tc.t_drift, jc.t_drift, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tc.R_drift, jc.R_drift, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(tc.edges.valid, jc.edges.valid)
    assert tc.n_edges == jc.n_edges and len(tc.pgo_log) == len(jc.pgo_log)
    assert [p["n_edges"] for p in tc.pgo_log] == [p["n_edges"] for p in jc.pgo_log]


def test_closer_keyframe_features_match_jax(runs):
    jc, tc = runs["4dof"]["jc"], runs["4dof"]["tc"]
    for a, b in zip(tc.keyframes, jc.keyframes):
        np.testing.assert_array_equal(a.window_desc, np.asarray(b.window_desc).view(np.int32))
        np.testing.assert_array_equal(a.extra_desc, np.asarray(b.extra_desc).view(np.int32))
        np.testing.assert_array_equal(a.extra_valid, np.asarray(b.extra_valid))
        np.testing.assert_array_equal(a.extra_uv, np.asarray(b.extra_uv))
        assert a.connected == b.connected
    np.testing.assert_array_equal(tc.db.word_ids[: tc.db.count], jc.db.word_ids[: jc.db.count])
    np.testing.assert_array_equal(tc.db.word_w[: tc.db.count], jc.db.word_w[: jc.db.count])


def test_closer_reduces_trajectory_error(revisit, runs):
    _, exports, gt = revisit
    tc = runs["4dof"]["tc"]
    vio = np.stack([e["T_WC_r"] for e in exports])
    rmse = lambda p: np.sqrt(np.mean(np.sum((p - gt) ** 2, axis=1)))  # noqa: E731
    assert rmse(tc.optimized_path()) < 0.6 * rmse(vio)


def test_debug_stage_images_written(runs):
    dbg = runs["4dof"]["dbg"]
    for sub, prefix in (("loop_candidates", "loop_candidate"),
                        ("descriptor_matched", "descriptor_match"), ("pnp_verified", "pnp_verified")):
        assert [f for f in os.listdir(os.path.join(dbg, sub)) if f.startswith(prefix)], sub


# --------------------------------------------------------------- pose graph
def test_optimize_4dof_matches_jax():
    nodes, edges, t_gt, _, N = _make_drifted_graph()
    want = jpg.optimize_4dof(nodes, edges, jnp.int32(1), iters=10)
    got = tpg.optimize_4dof(posegraph_from_numpy(nodes), posegraph_from_numpy(edges), 1, iters=10)
    np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.yaw.numpy(), np.asarray(want.yaw), rtol=0, atol=1e-8)
    assert np.linalg.norm(got.p[N - 1].numpy() - t_gt[N - 1]) < 0.15 * np.linalg.norm(
        np.asarray(nodes.p[N - 1]) - t_gt[N - 1])


def _graph6():
    nodes, edges, _, _, _ = _make_drifted_graph()
    R = jax.vmap(jpg.ypr_to_matrix)(nodes.yaw, nodes.pitch + 0.05, nodes.roll - 0.03)
    n6 = jpg.PoseGraph6Nodes(r=nodes.p, q=jax.vmap(jquat.from_rotation_matrix)(R), valid=nodes.valid)
    E = edges.i.shape[0]
    q_ij = jax.vmap(lambda y: jquat.from_rotation_matrix(jpg.ypr_to_matrix(y, 0.0, 0.0)))(edges.yaw_ij)
    W = jnp.tile(jnp.diag(jnp.asarray([20.0, 20, 20, 100, 100, 57.3])), (E, 1, 1))
    return n6, jpg.PoseGraph6Edges(i=edges.i, j=edges.j, t_ij=edges.t_ij, q_ij=q_ij, sqrt_info=W,
                                   valid=edges.valid, is_loop=edges.is_loop)


def test_optimize_6dof_matches_jax():
    n6, e6 = _graph6()
    want = jpg.optimize_6dof(n6, e6, jnp.int32(1), iters=8)
    got = tpg.optimize_6dof(posegraph_from_numpy(n6), posegraph_from_numpy(e6), 1, iters=8)
    np.testing.assert_allclose(got.r.numpy(), np.asarray(want.r), rtol=0, atol=1e-8)
    np.testing.assert_allclose(got.q.numpy(), np.asarray(want.q), rtol=0, atol=1e-8)
    # without is_loop (no Huber edges)
    e6 = e6._replace(is_loop=None)
    want = jpg.optimize_6dof(n6, e6, jnp.int32(1), iters=3)
    got = tpg.optimize_6dof(posegraph_from_numpy(n6), posegraph_from_numpy(e6), 1, iters=3)
    np.testing.assert_allclose(got.r.numpy(), np.asarray(want.r), rtol=0, atol=1e-8)


def test_ypr_helpers_match_jax():
    rng = np.random.default_rng(0)
    ypr = rng.uniform(-1.5, 1.5, (20, 3))
    R_j = np.stack([np.asarray(jpg.ypr_to_matrix(*a)) for a in ypr])
    R_t = tpg.ypr_to_matrix(*torch.as_tensor(ypr).T)
    np.testing.assert_allclose(R_t.numpy(), R_j, rtol=0, atol=1e-15)
    np.testing.assert_allclose(np.stack([tpg.ypr_to_matrix_np(*a) for a in ypr]), R_j, atol=1e-15)
    back = np.stack([np.asarray(x) for x in jpg.matrix_to_ypr(jnp.asarray(R_j))], -1)
    np.testing.assert_allclose(torch.stack(tpg.matrix_to_ypr(R_t), -1).numpy(), back, atol=1e-15)
    np.testing.assert_allclose(np.stack(tpg.matrix_to_ypr_np(R_j), -1), back, atol=1e-15)
    a = np.linspace(-10, 10, 41)
    np.testing.assert_allclose(tpg.normalize_angle(torch.as_tensor(a)).numpy(),
                               np.asarray(jpg.normalize_angle(jnp.asarray(a))), atol=1e-15)
    np.testing.assert_allclose(tpg.normalize_angle_np(a), np.asarray(jpg.normalize_angle_np(a)))


# ------------------------------------------------------------- vocabularies
def _words(rng, n, w=8):
    return rng.integers(0, 2**32, size=(n, w), dtype=np.uint64).astype(np.uint32)


def test_vocabularies_are_bit_identical():
    np.testing.assert_array_equal(tret.make_vocabulary(3, 256).numpy(),
                                  np.asarray(jret.make_vocabulary(3, 256)).view(np.int32))
    jpv, tpv = jret.make_product_vocabulary(5), tret.make_product_vocabulary(5)
    for a, b in ((tpv.vocab1, jpv.vocab1), (tpv.vocab2, jpv.vocab2)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b).view(np.int32))


@pytest.mark.parametrize("n", [900, 100])  # more, and fewer, descriptors than words
def test_kmedoids_centroids_are_bit_identical(runs, n):
    tc = runs["4dof"]["tc"]
    pool = np.concatenate([np.concatenate([k.window_desc[k.window_valid], k.extra_desc[k.extra_valid]])
                           for k in tc.keyframes])[:n]
    want = jret.train_vocabulary(jnp.asarray(pool.view(np.uint32)), size=128, iters=4)
    got = tret.train_vocabulary(torch.as_tensor(pool), size=128, iters=4)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want).view(np.int32))
    jpv = jret.train_product_vocabulary(jnp.asarray(pool.view(np.uint32)), iters=3)
    tpv = tret.train_product_vocabulary(torch.as_tensor(pool), iters=3)
    np.testing.assert_array_equal(tpv.vocab1.numpy(), np.asarray(jpv.vocab1).view(np.int32))
    np.testing.assert_array_equal(tpv.vocab2.numpy(), np.asarray(jpv.vocab2).view(np.int32))


def _tied(rng, n, v, w):
    """n descriptors and v codewords of w words, a quarter of the codewords
    repeated and descriptors on them, so the minimum distance ties."""
    vocab, desc = _words(rng, v, w), _words(rng, n, w)
    q = v // 4
    vocab[v - q:] = vocab[:q]
    desc[:q] = vocab[:q]
    desc[q:2 * q, -1] = vocab[:q, -1] ^ (1 << 7)
    return desc, vocab


@pytest.mark.parametrize("width", [8, 4])
def test_assign_words_and_kmedoids_match_jax_with_ties(width):
    """The word assignment (``assign_words``: the nearest-codeword function),
    one k-medoids step (``_kmedoids``, the refinement of both vocabulary
    trainers) and, at width 4, the product vocabulary's ``product_words``,
    bit for bit against the JAX package on descriptors that tie."""
    rng = np.random.default_rng(width)
    desc, vocab = _tied(rng, 400, 64, width)
    jd, jv = jnp.asarray(desc), jnp.asarray(vocab)
    td, tv = torch.as_tensor(desc.view(np.int32)), torch.as_tensor(vocab.view(np.int32))
    want = np.asarray(jnp.argmin(jham.hamming_matrix_ref(jd, jv), axis=1))
    got = tret.assign_words(td, tv).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[:16] == np.arange(16)).all()  # the first of two equal codewords
    # one k-medoids step: the JAX trainers' step, written out (their
    # train_* functions seed from a numpy draw the port repeats)
    bits = jham.unpack_bits_pm1(jd).astype(jnp.int32)
    sums = jax.ops.segment_sum(bits, jnp.asarray(want), num_segments=64)
    counts = jax.ops.segment_sum(jnp.ones(400, jnp.int32), jnp.asarray(want), num_segments=64)
    maj = (sums > 0).astype(jnp.uint32).reshape(64, width, 32)
    packed = jnp.sum(maj * (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32)), axis=-1,
                     dtype=jnp.uint32)
    step = np.asarray(jnp.where((counts > 0)[:, None], packed, jv))
    np.testing.assert_array_equal(tret._kmedoids(td, tv, 1).numpy(), step.view(np.int32))
    if width == 4:
        pd, pv1 = _tied(rng, 300, 256, 4)
        _, pv2 = _tied(rng, 300, 256, 4)
        full = np.concatenate([pd, pd[::-1]], axis=1)  # both halves sit on ties
        full[:, 4:][:64] = pv2[:64]
        want_w = jret.product_words(jnp.asarray(full), jnp.asarray(pv1), jnp.asarray(pv2))
        got_w = tret.product_words(torch.as_tensor(full.view(np.int32)),
                                   torch.as_tensor(pv1.view(np.int32)),
                                   torch.as_tensor(pv2.view(np.int32)))
        np.testing.assert_array_equal(got_w.numpy(), np.asarray(want_w))


def test_words_bow_and_idf_match_jax():
    rng = np.random.default_rng(1)
    docs = [(_words(rng, 300), rng.random(300) < 0.9) for _ in range(5)]
    jpv = jret.make_product_vocabulary()
    tpv = product_vocabulary_from_numpy(jpv)
    vocab = jret.make_vocabulary(size=256)
    tvocab, _ = vocabulary_from_numpy(np.asarray(vocab))
    for d, v in docs:
        td = torch.as_tensor(d.view(np.int32))
        want_w = jret.product_words(jnp.asarray(d), jpv.vocab1, jpv.vocab2)
        np.testing.assert_array_equal(tret.product_words(td, tpv.vocab1, tpv.vocab2).numpy(),
                                      np.asarray(want_w))
        got = tret.bow_vector(td, torch.as_tensor(v), tvocab, 256)
        want = jret.bow_vector(jnp.asarray(d), jnp.asarray(v), vocab, 256)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-7)
        np.testing.assert_array_equal(got.numpy() > 0, np.asarray(want) > 0)  # the same words
    jdocs = [(jnp.asarray(d), jnp.asarray(v)) for d, v in docs]
    tdocs = [(torch.as_tensor(d.view(np.int32)), torch.as_tensor(v)) for d, v in docs]
    np.testing.assert_array_equal(tret.compute_idf(tdocs, tvocab).numpy(),
                                  np.asarray(jret.compute_idf(jdocs, vocab)))
    np.testing.assert_array_equal(tret.compute_idf_product(tdocs, tpv).numpy(),
                                  np.asarray(jret.compute_idf_product(jdocs, jpv)))
    w = tret.bow_vector(tdocs[0][0], tdocs[0][1], tvocab, 256,
                        weights=tret.compute_idf(tdocs, tvocab))
    ww = jret.bow_vector(jdocs[0][0], jdocs[0][1], vocab, 256,
                         weights=jret.compute_idf(jdocs, vocab))
    np.testing.assert_allclose(w.numpy(), np.asarray(ww), rtol=0, atol=1e-7)
    np.testing.assert_allclose(tret.l1_scores(w, torch.stack([w, w * 0.5])).numpy(),
                               np.asarray(jret.l1_scores(ww, jnp.stack([ww, ww * 0.5]))), atol=1e-7)


def test_vocabulary_files_load_in_either_package(tmp_path):
    rng = np.random.default_rng(2)
    vocab = jret.make_vocabulary(seed=4, size=64)
    idf = np.abs(rng.normal(size=64)).astype(np.float32)
    jret.save_vocabulary(str(tmp_path / "j.npz"), vocab, weights=jnp.asarray(idf))
    v, w = tret.load_vocabulary(str(tmp_path / "j.npz"))
    np.testing.assert_array_equal(v.numpy(), np.asarray(vocab).view(np.int32))
    np.testing.assert_array_equal(w.numpy(), idf)
    tret.save_vocabulary(str(tmp_path / "t.npy"), v)
    back, none = jret.load_vocabulary(str(tmp_path / "t.npy"))
    assert none is None and np.asarray(back).dtype == np.uint32
    np.testing.assert_array_equal(np.asarray(back), np.asarray(vocab))
    pv = jret.make_product_vocabulary(6)._replace(idf=jnp.asarray(rng.random(65536), jnp.float32))
    jret.save_product_vocabulary(str(tmp_path / "jp.npz"), pv)
    tpv = tret.load_product_vocabulary(str(tmp_path / "jp.npz"))
    tret.save_product_vocabulary(str(tmp_path / "tp.npz"), tpv)
    back = jret.load_product_vocabulary(str(tmp_path / "tp.npz"))
    for a, b in zip(back, pv):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    with pytest.raises(ValueError):
        tret.load_product_vocabulary(str(tmp_path / "t.npy"))


def _db_pair(kind, rng):
    """A JAX and a port database with the same 12 entries, entry 7 a copy of
    entry 2 (a planted tie)."""
    if kind == "product":
        jdb, tdb = (jret.ProductKeyframeDatabase(capacity=8),
                    tret.ProductKeyframeDatabase(capacity=8, device="cpu"))
    else:
        jdb, tdb = jret.KeyframeDatabase(capacity=8), tret.KeyframeDatabase(capacity=8, device="cpu")
    entries = [(_words(rng, 400), rng.random(400) < 0.95) for _ in range(12)]
    entries[7] = entries[2]
    for d, v in entries:
        jdb.add(jnp.asarray(d), jnp.asarray(v))
        tdb.add(d, v)
    return jdb, tdb, entries


@pytest.mark.parametrize("kind", ["product", "flat"])
def test_database_queries_match_jax_with_a_planted_tie(kind):
    rng = np.random.default_rng(3)
    jdb, tdb, entries = _db_pair(kind, rng)
    assert tdb.count == jdb.count == 12 and tdb.capacity == jdb.capacity == 16
    q = entries[2][0].copy()
    q[:150] = _words(rng, 150)  # a noisy revisit of entries 2 and 7
    v = entries[2][1]
    ji, js = jdb.query(jnp.asarray(q), jnp.asarray(v), top_k=4, exclude_after=12)
    ti, ts = tdb.query(q, v, top_k=4, exclude_after=12)
    assert list(ti) == list(ji) and set(ti[:2]) == {2, 7}
    np.testing.assert_allclose(ts, js, rtol=0, atol=1e-6)
    assert ts[0] == ts[1]  # the tie
    jv, tv = jdb.bow(jnp.asarray(q), jnp.asarray(v)), tdb.bow(q, v)
    np.testing.assert_allclose(tdb.scores_range(tv, 3, 10), jdb.scores_range(jv, 3, 10), atol=1e-6)
    np.testing.assert_allclose(tdb.scores_at(tv, [0, 7, 2]), jdb.scores_at(jv, [0, 7, 2]), atol=1e-6)
    ji, js = jdb.query_vector(jv, top_k=3, exclude_after=5)  # recency exclusion
    ti, ts = tdb.query_vector(tv, top_k=3, exclude_after=5)
    assert list(ti) == list(ji) and 7 not in ti


def test_packed_device_scoring_matches_jax_with_ties():
    rng = np.random.default_rng(4)
    jdb, tdb, entries = _db_pair("product", rng)
    q_ids, q_w = tdb.bow(*entries[2])
    db_ids, db_w = tdb.packed_device(pad_to=16)
    want = jret.score_packed_device(jnp.asarray(q_ids), jnp.asarray(q_w), jnp.asarray(db_ids.numpy()),
                                    jnp.asarray(db_w.numpy()))
    got = tret.score_packed_device(torch.as_tensor(q_ids), torch.as_tensor(q_w), db_ids, db_w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
    for n, k in ((12, 4), (5, 4), (16, 6)):  # ties: 2 and 7, and the zero rows past 12
        ws, wi = jret.score_packed_topk_device(jnp.asarray(q_ids), jnp.asarray(q_w),
                                               jnp.asarray(db_ids.numpy()), jnp.asarray(db_w.numpy()),
                                               jnp.int32(n), k=k)
        gs, gi = tret.score_packed_topk_device(torch.as_tensor(q_ids), torch.as_tensor(q_w), db_ids,
                                               db_w, n, k=k)
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), rtol=0, atol=1e-6)
    ti, ts = tdb.query_vector_device((q_ids, q_w), top_k=4, exclude_after=12)
    ji, js = jdb.query_vector_device((q_ids, q_w), top_k=4, exclude_after=12)
    assert list(ti) == list(ji)


def test_product_db_query_paths_agree():
    """Past DEVICE_QUERY_AT entries the host query scores through the
    inverted file; it, the dense scan and the device program agree, also
    after incremental adds (the JAX test's case, on the port)."""
    rs = np.random.RandomState(1)
    N = tret.ProductKeyframeDatabase.DEVICE_QUERY_AT + 200
    db = tret.ProductKeyframeDatabase(capacity=2 * N, device="cpu")
    off = rs.randint(0, 65536, (N, 1))
    db.word_ids[:N] = (off + np.arange(db.M)[None, :] * 127) % 65536
    w = rs.rand(N, db.M).astype(np.float32)
    db.word_w[:N] = w / w.sum(1, keepdims=True)
    db.count = N
    db.rebuild_index()
    q = (db.word_ids[3].copy(), db.word_w[3].copy())
    idx_inv, s_inv = db.query_vector(q, top_k=4, exclude_after=N - 60)
    idx_dev, s_dev = db.query_vector_device(q, top_k=4, exclude_after=N - 60)
    host = tret.ProductKeyframeDatabase(capacity=2 * N, device="cpu")
    host.word_ids[:N], host.word_w[:N], host.count = db.word_ids[:N], db.word_w[:N], N
    host.DEVICE_QUERY_AT = 10**9  # the dense host scan
    idx_h, s_h = host.query_vector(q, top_k=4, exclude_after=N - 60)
    assert list(idx_inv) == list(idx_h) == list(idx_dev)
    np.testing.assert_allclose(s_inv, s_h, atol=1e-5)
    np.testing.assert_allclose(s_dev, s_h, atol=1e-5)
    db.add(rs.randint(0, 2**32, (40, 8)).astype(np.uint32), np.ones(40, bool))
    idx2, _ = db.query_vector(q, top_k=4, exclude_after=db.count)
    idx2d, _ = db.query_vector_device(q, top_k=4, exclude_after=db.count)
    assert list(idx2) == list(idx2d)


# -------------------------------------------------------------- host modules
def test_health_and_switching_match_jax():
    jh = JaxHealthConfig(enable=True, min_keypoints=15, kps_per_quadrant=2, consecutive_keyframes=2,
                         keyframe_wait_time=1.5)
    th = HealthConfig(enable=True, min_keypoints=15, kps_per_quadrant=2, consecutive_keyframes=2,
                      keyframe_wait_time=1.5)
    for args in ((40, np.array([10, 10, 10, 10]), 10, np.ones(40)),
                 (5, np.array([2, 1, 1, 1]), 0, np.ones(5)),
                 (20, np.array([20, 0, 0, 0]), 0, np.ones(20)),
                 (20, np.array([5, 5, 5, 5]), 80, np.ones(20)),
                 (30, np.array([9, 9, 9, 9]), 1, np.r_[np.full(27, 1e-3), np.ones(3)])):
        a, b = tsw.check_health(th, *args), jsw.check_health(jh, *args)
        assert (a.healthy, a.reason) == (b.healthy, b.reason)
    js, ts = jsw.SwitchingEstimator(cfg=jh), tsw.SwitchingEstimator(cfg=th)
    rng = np.random.default_rng(0)
    q0 = np.array([0.0, 0.0, 0.0, 1.0])
    for k in range(14):
        t = float(k)
        prim = (rng.normal(size=3), q0)
        js.add_primitive_pose(t, JT(r=jnp.asarray(prim[0]), q=jnp.asarray(prim[1])))
        ts.add_primitive_pose(t, TT(r=prim[0], q=prim[1]))
        vio = (rng.normal(size=3), q0)
        healthy = k < 3 or k > 9
        a = ts.add_keyframe(t + 0.5, TT(r=vio[0], q=vio[1]), tsw.HealthStatus(healthy, "x"))
        b = js.add_keyframe(t + 0.5, JT(r=jnp.asarray(vio[0]), q=jnp.asarray(vio[1])),
                            jsw.HealthStatus(healthy, "x"))
        assert ts.state.name == js.state.name
        np.testing.assert_allclose(np.asarray(a.r), np.asarray(b.r), atol=1e-12)
    js.add_primitive_pose(20.0, JT(r=jnp.zeros(3), q=jnp.asarray(q0)))  # VIO silence
    ts.add_primitive_pose(20.0, TT(r=np.zeros(3), q=q0))
    assert ts.state.name == js.state.name and ts.switch_log == js.switch_log
    assert len(ts.switch_log) >= 3


def test_global_map_and_frustum_ply_bytes_equal(tmp_path):
    rng = np.random.default_rng(5)
    jm, tm = jgm.GlobalMap(min_quality=0.1), tgm.GlobalMap(min_quality=0.1)
    poses = {}
    for k in range(4):
        r, q = rng.normal(size=3), rng.normal(size=4)
        q /= np.linalg.norm(q)
        poses[k] = (r, q)
        pts, ids, qual = rng.normal(size=(30, 3)) + [0, 0, 4], rng.integers(0, 50, 30), rng.random(30)
        jm.add_observations(k, JT(r=jnp.asarray(r), q=jnp.asarray(q)), ids, pts, qual)
        tm.add_observations(k, TT(r=r, q=q), ids, pts, qual)
    corr = {k: (r + 0.1, q) for k, (r, q) in poses.items()}
    n_j = jm.update_after_loop({k: JT(r=jnp.asarray(r), q=jnp.asarray(q)) for k, (r, q) in corr.items()})
    assert n_j == tm.update_after_loop({k: TT(r=r, q=q) for k, (r, q) in corr.items()})
    jm.save_ply(str(tmp_path / "j.ply"))
    tm.save_ply(str(tmp_path / "t.ply"))
    assert (tmp_path / "j.ply").read_bytes() == (tmp_path / "t.ply").read_bytes()
    jfr.save_frustums_ply(str(tmp_path / "jf.ply"),
                          {k: JT(r=jnp.asarray(r), q=jnp.asarray(q)) for k, (r, q) in poses.items()},
                          [(0, 2), (0, 99)], scale=0.3)
    tfr.save_frustums_ply(str(tmp_path / "tf.ply"), {k: TT(r=r, q=q) for k, (r, q) in poses.items()},
                          [(0, 2), (0, 99)], scale=0.3)
    assert (tmp_path / "jf.ply").read_bytes() == (tmp_path / "tf.ply").read_bytes()


# ------------------------------------------------------- the closer's paths
def _random_exports(n, seed=0, w=128, h=96):
    rng = np.random.RandomState(seed)
    img = rng.rand(h, w).astype(np.float32)
    return [{
        "kf_index": k, "timestamp": 0.1 * k, "T_WC_r": np.array([0.1 * k, 0.0, 0.0]),
        "T_WC_q": np.array([0.0, 0.0, 0.0, 1.0]), "image": img,
        "keypoints_uv": rng.rand(20, 2) * [w - 1, h - 1], "points_W": rng.rand(20, 3) * 4.0,
        "quality": np.full(20, 0.5), "num_tracked": 20, "quadrant_counts": np.array([5, 5, 5, 5]),
        "response_strengths": np.ones(20),
    } for k in range(n)]


def test_capacity_growth_from_a_small_capacity():
    exports = _random_exports(10)
    cam = make_camera(128, 96, 160.0, 160.0, 64.0, 48.0, model="none")
    from svin_tpu.cameras import make_camera as jax_make_camera

    jc = jlc.LoopCloser(jax_make_camera(128, 96, 160.0, 160.0, 64.0, 48.0, model="none"),
                        JaxVioConfig(), capacity=4)
    tc = tlc.LoopCloser(cam, config_from_numpy(JaxVioConfig()), capacity=4, device="cpu")
    for e in exports:
        jc.add_keyframe(e)
        tc.add_keyframe(e)
    assert tc.capacity == jc.capacity == 16 and tc.n_edges == jc.n_edges == 17
    assert tc.edges.i.shape == jc.edges.i.shape and tc.earliest_loop_index == jc.earliest_loop_index
    for a, b in zip(tc.nodes, jc.nodes):
        np.testing.assert_allclose(a, b, atol=1e-12)
    for a, b in zip(tc.edges, jc.edges):
        np.testing.assert_allclose(a, b, atol=1e-12)


def test_health_gate_and_switching_in_the_closer():
    cfg = JaxVioConfig()
    cfg.health.enable = True
    cfg.health.min_keypoints = 10
    cfg.health.consecutive_keyframes = 1
    from svin_tpu.cameras import make_camera as jax_make_camera

    jc = jlc.LoopCloser(jax_make_camera(128, 96, 160.0, 160.0, 64.0, 48.0, model="none"), cfg)
    tc = tlc.LoopCloser(make_camera(128, 96, 160.0, 160.0, 64.0, 48.0, model="none"),
                        config_from_numpy(cfg), device="cpu")
    exports = _random_exports(8, seed=1)
    q0 = np.array([0.0, 0.0, 0.0, 1.0])
    for k, e in enumerate(exports):
        e = dict(e, num_tracked=2 if 1 <= k <= 4 else 50, num_new=3)
        prim = np.array([5.0 + 0.1 * k, 0.0, 0.0])
        jc.add_primitive_pose(float(k), JT(r=jnp.asarray(prim), q=jnp.asarray(q0)))
        tc.add_primitive_pose(float(k), TT(r=prim, q=q0))
        jc.add_keyframe(e)
        tc.add_keyframe(e)
        assert len(tc.keyframes) == len(jc.keyframes)
        assert tc.switching.state.name == jc.switching.state.name
    assert len(tc.keyframes) == 4 and tc.switching.switch_log == jc.switching.switch_log
    assert any("VIO->PRIMITIVE" in m for _, m in tc.switching.switch_log)
    for (t1, r1, q1), (t2, r2, q2) in zip(tc.robust_trajectory, jc.robust_trajectory):
        assert t1 == t2
        np.testing.assert_allclose(r1, r2, atol=1e-12)


def _dummy_kf(idx, r, q, seq=0):
    z = np.zeros((8, 8), np.int32)
    return tlc.LoopKeyframe(index=idx, timestamp=float(idx), T_WC_vio=TT(r=np.asarray(r, float),
                            q=np.asarray(q, float)), points_W=np.zeros((0, 3)),
                            point_uv=np.zeros((0, 2)), window_desc=z, window_valid=np.zeros(8, bool),
                            extra_uv=np.zeros((8, 2), np.float32), extra_desc=z,
                            extra_valid=np.zeros(8, bool), sequence=seq)


def test_fast_relocalization_and_6dof_pitch_drift():
    """The JAX tests' fast-relocalization and 6-DoF pitch-drift cases on the
    port: the drift re-anchors the current pose on the old node composed
    with the loop relative; the 6-DoF solve corrects a pitch drift."""
    cfg = config_from_numpy(JaxVioConfig())
    cfg.fast_relocalization = True
    tc = tlc.LoopCloser(port_camera(), cfg, device="cpu")
    p_old, yaw_old = np.array([1.0, 2.0, 0.5]), 0.3
    tc.nodes.p[0], tc.nodes.yaw[0], tc.nodes.valid[0] = p_old, yaw_old, True
    from svin_tpu_torch.kinematics import npq

    qz = lambda y: npq.from_rotation_matrix(tpg.ypr_to_matrix_np(y, 0.0, 0.0))  # noqa: E731
    tc.keyframes = [_dummy_kf(0, [9.0, 9.0, 9.0], qz(0.0)), _dummy_kf(1, [4.0, 1.0, 0.2], qz(0.1))]
    rel_t, rel_yaw = np.array([0.5, -0.2, 0.1]), 0.15
    tc._fast_relocalize(tlc.LoopInfo(1, 0, 30, rel_t, rel_yaw))
    T_cor = tc.apply_drift(tc.keyframes[1].T_WC_vio)
    np.testing.assert_allclose(T_cor.r, tpg.ypr_to_matrix_np(yaw_old, 0, 0) @ rel_t + p_old, atol=1e-9)
    before = (tc.yaw_drift, tc.t_drift.copy())
    tc._fast_relocalize(tlc.LoopInfo(1, 0, 30, np.array([25.0, 0, 0]), 0.0))  # out of the gate
    assert tc.yaw_drift == before[0] and np.array_equal(tc.t_drift, before[1])

    cfg6 = config_from_numpy(JaxVioConfig())
    cfg6.loop_closure.pgo_mode = "6dof"
    tc = tlc.LoopCloser(port_camera(), cfg6, device="cpu")
    R0, p0 = tpg.ypr_to_matrix_np(0.3, 0.1, -0.05), np.array([1.0, 2.0, 0.5])
    R1, p1 = tpg.ypr_to_matrix_np(0.5, 0.3, 0.1), np.array([2.0, 1.5, 0.8])
    Rd = tpg.ypr_to_matrix_np(0.0, 0.15, 0.0)
    q0, q1 = npq.from_rotation_matrix(R0), npq.from_rotation_matrix(R1)
    q1_vio = npq.multiply(npq.from_rotation_matrix(Rd), q1)
    p1_vio = Rd @ p1 + np.array([0.4, -0.3, 0.25])
    tc.keyframes = [_dummy_kf(0, p0, q0), _dummy_kf(1, p1_vio, q1_vio)]
    for k, (p, R) in enumerate(((p0, R0), (p1_vio, npq.to_rotation_matrix(q1_vio)))):
        tc.nodes.p[k] = p
        tc.nodes.yaw[k], tc.nodes.pitch[k], tc.nodes.roll[k] = tpg.matrix_to_ypr_np(R)
        tc.nodes.valid[k] = True
    rel = R0.T @ (p1 - p0)
    tc.earliest_loop_index = 0
    tc._add_loop_edge(tlc.LoopInfo(1, 0, 30, rel, 0.2, rel_t_full=rel,
                                   rel_q_full=npq.multiply(npq.conjugate(q0), q1)))
    tc._optimize_and_update_drift()
    np.testing.assert_allclose(tc.nodes.p[1], p1, atol=5e-3)
    assert abs(tc.R_drift[2, 0]) > 0.05 or abs(tc.R_drift[2, 1]) > 0.05
    np.testing.assert_allclose(tc.apply_drift(tc.keyframes[1].T_WC_vio).r, p1, atol=5e-3)


def _jax_dummy_kf(idx, r, q, seq=0):
    z = np.zeros((8, 8), np.int32)
    return jlc.LoopKeyframe(index=idx, timestamp=float(idx), T_WC_vio=JT(r=np.asarray(r, float),
                            q=np.asarray(q, float)), points_W=np.zeros((0, 3)),
                            point_uv=np.zeros((0, 2)), window_desc=z, window_valid=np.zeros(8, bool),
                            extra_uv=np.zeros((8, 2), np.float32), extra_desc=z,
                            extra_valid=np.zeros(8, bool), sequence=seq)


def _closers_past_512(mode, n=513, loops=True):
    """A JAX closer and a port closer holding the same ``n`` keyframes in
    place, as a long session leaves them: a circle of radius 20 m lapped
    twice whose VIO poses carry a yaw random walk, sequential edges from the
    VIO poses and, with ``loops``, loop edges (true relative poses) from the
    second lap back to the first every 32 keyframes. Returns (JAX closer,
    port closer, true positions, loop pairs)."""
    from svin_tpu.kinematics import npq as jnpq

    cfg = JaxVioConfig()
    cfg.loop_closure.pgo_mode = mode
    jc = jlc.LoopCloser(jax_camera(), cfg, capacity=1024)
    tc = tlc.LoopCloser(port_camera(), config_from_numpy(cfg), capacity=1024, device="cpu")
    rng = np.random.default_rng(7)
    th = np.linspace(0, 4 * np.pi, n)
    p_gt = np.stack([20.0 * np.cos(th), 20.0 * np.sin(th), 0.1 * np.sin(3 * th)], 1)
    yaw_gt = th + np.pi / 2
    yaw_vio = yaw_gt + np.cumsum(rng.normal(0, 2e-3, n))
    p_vio = np.zeros((n, 3))
    p_vio[0] = p_gt[0]
    for k in range(1, n):
        p_vio[k] = p_vio[k - 1] + tpg.ypr_to_matrix_np(yaw_vio[k - 1], 0, 0) @ (
            tpg.ypr_to_matrix_np(yaw_gt[k - 1], 0, 0).T @ (p_gt[k] - p_gt[k - 1]))
    q_vio = [jnpq.from_rotation_matrix(tpg.ypr_to_matrix_np(y, 0, 0)) for y in yaw_vio]
    pairs = [(k - n // 2, k) for k in range(n // 2 + 8, n, 32)] if loops else []
    for c, make in ((jc, _jax_dummy_kf), (tc, _dummy_kf)):
        n_back = 4 if mode == "6dof" else 2
        for k in range(n):
            c.keyframes.append(make(k, p_vio[k], q_vio[k]))
            c.nodes.p[k], c.nodes.yaw[k], c.nodes.valid[k] = p_vio[k], yaw_vio[k], True
            for back in range(1, n_back + 1):
                if k - back >= 0:
                    c._add_sequential_edge(k - back, k)
        for m, k in pairs:
            Rm = tpg.ypr_to_matrix_np(yaw_gt[m], 0, 0)
            rel_t = Rm.T @ (p_gt[k] - p_gt[m])
            rel_yaw = float(yaw_gt[k] - yaw_gt[m])
            c._add_loop_edge(tlc.LoopInfo(k, m, 40, rel_t, rel_yaw, rel_t_full=rel_t,
                                          rel_q_full=jnpq.from_rotation_matrix(
                                              tpg.ypr_to_matrix_np(rel_yaw, 0, 0))))
            c.earliest_loop_index = min(c.earliest_loop_index, m)
    return jc, tc, p_gt, pairs


def _loop_residuals(c):
    """Translation residual (m) of every valid loop edge of a closer's graph."""
    e, nd = c.edges, c.nodes
    kk = np.nonzero(e.valid[: c.n_edges] & e.is_loop[: c.n_edges])[0]
    return np.array([np.linalg.norm(tpg.ypr_to_matrix_np(nd.yaw[i], nd.pitch[i], nd.roll[i]).T
                                    @ (nd.p[j] - nd.p[i]) - e.t_ij[k])
                     for k, i, j in zip(kk, e.i[kk], e.j[kk])])


# the 6-DoF closer's CG budget in the parity tests: at its own 96 CG per GN
# step the solve stops far from convergence, where its result is chaotic in
# the last bits of its input (the JAX closer moves by ~3e-4 m when its node
# positions are scaled by 1 ± 1e-15; tests/test_torch_parallel.py holds the
# first GN step within 1e-9 instead); at 160 the two packages' paths agree
# to ~1e-8 m. The 4-DoF closer's default 96 already agrees to ~3e-7 m.
PARITY_CG_ITERS = {"4dof": 96, "6dof": 160}


@pytest.mark.parametrize("mode", ["4dof", "6dof"])
def test_past_512_nodes_the_scalable_solve_matches_jax(mode):
    """Past 512 nodes both closers take the scalable branch (4-DoF: the
    banded branch's system, 30 GN x 96 CG; 6-DoF: PCG, 10 GN x
    PARITY_CG_ITERS CG) on the same in-place graph with loop edges: the
    port's optimized path within 1e-6 m of the JAX closer's, and the loop
    residuals fall."""
    n = 513
    jc, tc, _, _ = _closers_past_512(mode, n)
    res0 = _loop_residuals(tc)
    for c in (jc, tc):
        assert c.pgo_cg_iters == 96
        c.pgo_cg_iters = PARITY_CG_ITERS[mode]
        c._optimize_and_update_drift()
        assert c.pgo_log[-1]["branch"] == "scalable"
    np.testing.assert_allclose(tc.optimized_path(), jc.optimized_path(), rtol=0, atol=1e-6)
    # the 4-DoF loop residuals fall under test_pcg.py's 0.01; the 6-DoF graph
    # whitens a loop residual by 20 before its Huber(0.1) weight, so its loop
    # edges pull weakly (the JAX closer's do the same): they only shrink
    res = _loop_residuals(tc)
    if mode == "4dof":
        assert res.max() < 0.01, res.max()
    else:
        assert res.max() < 0.5 * res0.max(), (res.max(), res0.max())


_EXPORT_512 = {"kf_index": 512, "timestamp": 512.0, "T_WC_r": np.array([20.3, 0.2, 0.0]),
               "T_WC_q": np.array([0.0, 0.0, 0.0, 1.0]), "keypoints_uv": np.zeros((20, 2)),
               "points_W": np.zeros((20, 3)), "window_desc": np.zeros((20, 8), np.uint32),
               "extra_desc": np.zeros((10, 8), np.uint32), "extra_uv": np.zeros((10, 2)),
               "extra_valid": np.ones(10, bool)}
_LOOP_512 = tlc.LoopInfo(512, 0, 40, np.array([0.05, 0.0, 0.0]), 0.01)


def test_past_512_keyframes_fast_relocalization_is_forced():
    """A known behaviour of the JAX closer, reproduced: past 512 keyframes a
    verified loop re-anchors the drift at once and defers the solve even
    with fast relocalization off in the config; the deferred solve (a
    1,024-node prefix, the scalable 4-DoF branch) runs at the flush, and the
    port's path lands within 1e-6 m of the JAX closer's. One loop edge
    closes this chain of 513 nodes, so the correction must travel its whole
    length: at the closer's 96 CG per GN step the solve stops far from
    convergence (the two paths part by ~2.6 cm, as the JAX closer's own
    does when its inputs move by an ulp), and both closers solve at 4 GN x
    2,000 CG, where they agree to ~1e-11 m."""
    _, tc, _, _ = _closers_past_512("4dof", n=512, loops=False)
    tc.pgo_gn_iters, tc.pgo_cg_iters = 4, 2000
    assert not tc.cfg.fast_relocalization
    tc._detect_and_verify = lambda kf: (_LOOP_512, None)
    assert tc.add_keyframe(_EXPORT_512) is _LOOP_512
    assert tc._pending_optimize and tc.pgo_log == []
    R0 = tpg.ypr_to_matrix_np(tc.nodes.yaw[0], 0.0, 0.0)
    reloc = tc.apply_drift(tc.keyframes[512].T_WC_vio).r
    np.testing.assert_allclose(reloc, tc.nodes.p[0] + R0 @ _LOOP_512.rel_t, atol=1e-9)
    tc.flush()
    assert not tc._pending_optimize and tc.pgo_log[-1]["branch"] == "scalable"

    jc = _closers_past_512("4dof", n=512, loops=False)[0]
    jc.pgo_gn_iters, jc.pgo_cg_iters = 4, 2000
    jc._detect_and_verify = lambda kf: _LOOP_512
    assert jc.add_keyframe(_EXPORT_512) is _LOOP_512
    assert jc._pending_optimize and jc.pgo_log == []
    np.testing.assert_allclose(jc.apply_drift(jc.keyframes[512].T_WC_vio).r, reloc, atol=1e-9)
    jc.flush()
    np.testing.assert_allclose(tc.optimized_path(), jc.optimized_path(), rtol=0, atol=1e-6)


def test_pruned_loop_edges_stay_invalid_like_jax():
    """A known behaviour of the JAX closer, reproduced: post-solve pruning
    measures each loop edge by one norm over metres and radians, and a
    pruned edge stays invalid for good."""
    from svin_tpu.cameras import make_camera as jax_make_camera

    jc = jlc.LoopCloser(jax_make_camera(200, 150, 160.0, 160.0, 100.0, 75.0, model="none"),
                        JaxVioConfig())
    tc = tlc.LoopCloser(port_camera(), config_from_numpy(JaxVioConfig()), device="cpu")
    for c in (jc, tc):
        N = 12
        c.nodes.p[:N] = np.stack([[0.5 * k, 0, 0] for k in range(N)])
        c.nodes.valid[:N] = True
        e = c.edges
        for k, (i, j, yaw) in enumerate([(0, 1, 0.0), (1, 2, 0.0), (0, 10, 0.0), (1, 11, 0.0),
                                         (2, 9, 0.0), (3, 8, 0.6)]):  # the last: 0.6 rad, 0 m
            e.i[k], e.j[k], e.yaw_ij[k], e.valid[k] = i, j, yaw, True
            e.t_ij[k] = [0.5 * (j - i), 0, 0]
            e.is_loop[k] = k >= 2
        c.n_edges = 6
    assert tc._prune_outlier_loops() == jc._prune_outlier_loops() == 1
    np.testing.assert_array_equal(tc.edges.valid, jc.edges.valid)
    assert not tc.edges.valid[5] and tc.stats["pruned_edges"] == 1
    tc.edges.yaw_ij[5] = 0.0  # consistent now: still pruned
    tc._prune_outlier_loops()
    assert not tc.edges.valid[5]


def test_closer_runs_on_the_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlc.LoopCloser(port_camera())
    assert tlc.LoopCloser(port_camera(), device="cpu").dtype == torch.float64


@pytest.mark.parametrize("cls", ["KeyframeDatabase", "ProductKeyframeDatabase"])
def test_databases_run_on_the_card_unless_asked_for_the_cpu(cls):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    db_cls = getattr(tret, cls)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        db_cls()
    assert db_cls(device="cpu").device.type == "cpu"
