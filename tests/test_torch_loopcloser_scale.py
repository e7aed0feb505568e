"""The port's LoopCloser at scale, and its covisibility and sequence logic:
``tests/test_loopcloser_scale.py`` run on the port (float64 on the CPU, the
kernels' plain versions).

- the covisibility-graph floor of the loop query against a burst of
  look-alike but not covisible keyframes;
- a sequence reset and the cross-sequence alignment;
- the in-situ scalable branch: loops closed past 512 keyframes through
  ``add_keyframe`` (capacity doubling, the scalable 4-DoF solve, drift
  propagation), at 540 keyframes, and at 2,120 under ``-m slow`` (there also
  the device query and the inverted file of the database).

Every intake is the image-free precomputed-descriptor payload. The asserted
bounds are the JAX tests'.
"""
import numpy as np
import pytest
import torch

from svin_tpu_torch.cameras import make_camera
from svin_tpu_torch.loopclosure import LoopCloser
from svin_tpu_torch.loopclosure.loop_closure import COVIS_WEIGHT_TH, LoopInfo
from svin_tpu_torch.pipeline.config import VioConfig
from svin_tpu_torch.problems import closer_drive, keyframe_export as _export

torch.set_num_threads(1)

CAM = make_camera(200, 150, 160.0, 160.0, 100.0, 75.0, model="none")


def _desc(rng, n):
    return rng.randint(0, 2**32, size=(n, 8)).astype(np.uint32)


def _closer(**lc_kw):
    cfg = VioConfig()
    cfg.health.enable = False
    for k, v in lc_kw.items():
        setattr(cfg.loop_closure, k, v)
    return LoopCloser(CAM, cfg, device="cpu")


def test_covisibility_floor_not_suppressed_by_lookalike_burst(monkeypatch):
    """test_loopcloser_scale.py:80: a burst of frames that look like the
    query but share no landmarks with it must not lift the query's floor
    above a true loop candidate; the floor comes from the covisibility
    graph, not the last three database entries."""
    closer = _closer()
    loop_desc_w = _desc(np.random.RandomState(7), 30)
    loop_desc_e = _desc(np.random.RandomState(7), 120)
    # the query revisits kf 10's place with ~50% descriptor overlap; the
    # burst frames look identical to the query itself
    q_desc_w = loop_desc_w.copy()
    q_desc_w[15:] = _desc(np.random.RandomState(8), 15)
    q_desc_e = loop_desc_e.copy()
    q_desc_e[60:] = _desc(np.random.RandomState(9), 60)
    verified = []

    def spy_verify(cur, old):
        verified.append(old.index)
        return None

    monkeypatch.setattr(closer, "_verify", spy_verify)
    for i in range(71):
        if i == 10:
            e = _export(i, i, [1.0 * i, 0, 0], [0, 0, 0, 1], window_desc=loop_desc_w,
                        extra_desc=loop_desc_e)
        elif i in (67, 68, 69):
            e = _export(i, i, [1.0 * i, 0, 0], [0, 0, 0, 1], window_desc=q_desc_w,
                        extra_desc=q_desc_e)
        elif i == 70:
            # covisible with kfs 60..66 (> COVIS_WEIGHT_TH shared points), not the burst
            covis = [[j for j in range(60, 67)] for _ in range(COVIS_WEIGHT_TH + 5)]
            e = _export(i, i, [1.0 * i, 0, 0], [0, 0, 0, 1], window_desc=q_desc_w,
                        extra_desc=q_desc_e, covis=covis, rng=np.random.RandomState(999))
        else:
            e = _export(i, i, [1.0 * i, 0, 0], [0, 0, 0, 1], rng=np.random.RandomState(1000 + i))
        closer.add_keyframe(e)

    assert 10 in verified, verified
    kf_q = closer.keyframes[70]
    assert sorted(kf_q.connected) == list(range(60, 67))
    v = closer.db.bow(np.concatenate([kf_q.window_desc, kf_q.extra_desc]),
                      np.concatenate([kf_q.window_valid, kf_q.extra_valid]))
    last3_floor = 0.6 * float(np.min(closer.db.scores_range(v, closer.db.count - 3,
                                                            closer.db.count)))
    s_true = float(closer.db.scores_at(v, [10])[0])
    assert last3_floor > s_true * 0.99, (last3_floor, s_true)  # the heuristic would suppress it
    covis_floor = 0.6 * float(np.min(closer.db.scores_at(v, kf_q.connected)))
    assert covis_floor < s_true, (covis_floor, s_true)


def test_sequence_reset_and_cross_sequence_alignment():
    """test_loopcloser_scale.py:148: a VIO restart zeroes the drift, adds no
    sequential edge across the boundary, and the first cross-sequence loop
    aligns the whole new sequence into the world frame."""
    closer = _closer()
    for i in range(6):
        closer.add_keyframe(_export(i, i, [1.0 * i, 0, 0], [0, 0, 0, 1],
                                    rng=np.random.RandomState(i)))
    closer.t_drift = np.array([0.5, 0.5, 0.0])
    n_edges_seq0 = closer.n_edges
    for k, i in enumerate(range(6, 10)):
        closer.add_keyframe(_export(i, i, [100.0 + k, 50.0, 0], [0, 0, 0, 1], sequence=1,
                                    rng=np.random.RandomState(100 + i)))
    np.testing.assert_allclose(closer.t_drift, 0.0)
    assert closer.sequence_cnt == 1 and closer._seq_aligned[1] is False
    e = closer.edges
    for k in range(closer.n_edges):
        assert (closer.keyframes[int(e.i[k])].sequence
                == closer.keyframes[int(e.j[k])].sequence), (int(e.i[k]), int(e.j[k]))
    assert closer.n_edges == n_edges_seq0 + 5  # 6→7, 7→8, 6→8, 8→9, 7→9
    # seq-1 keyframe 8 sees seq-0 keyframe 2's place, 1 m further along +x
    loop = LoopInfo(query_index=8, match_index=2, num_inliers=40, rel_t=np.array([1.0, 0, 0]),
                    rel_yaw=0.0, rel_t_full=np.array([1.0, 0, 0]),
                    rel_q_full=np.array([0.0, 0.0, 0.0, 1.0]))
    kf8 = closer.keyframes[8]
    closer._align_sequence(kf8, loop)
    assert closer._seq_aligned[1] is True
    np.testing.assert_allclose(np.asarray(kf8.T_WC_vio.r), [3.0, 0.0, 0.0], atol=1e-9)
    np.testing.assert_allclose(np.asarray(closer.keyframes[9].T_WC_vio.r), [4.0, 0.0, 0.0],
                               atol=1e-9)
    closer.add_keyframe(_export(10, 10, [105.0, 50.0, 0], [0, 0, 0, 1], sequence=1,
                                rng=np.random.RandomState(777)))
    np.testing.assert_allclose(np.asarray(closer.keyframes[10].T_WC_vio.r), [6.0, 0.0, 0.0],
                               atol=1e-9)


def drive_past_512(closer, N, loop_dst_start, radius):
    """test_loopcloser_scale.py:216's drive (``problems.closer_drive``)
    through ``add_keyframe``: (true positions, VIO positions, loops
    verified)."""
    exports, pos_true, pos_vio = closer_drive(closer.camera, N, loop_dst_start, radius)
    n_loops = sum(closer.add_keyframe(e) is not None for e in exports)
    return pos_true, pos_vio, n_loops


def _check_drive(closer, N, loop_dst_start, pos_true, pos_vio, n_loops):
    """The JAX test's assertions on the drive's outcome."""
    assert len(closer.keyframes) == N
    assert closer.capacity > 512  # the tables doubled
    assert n_loops >= 1, "no loop verified past 512 keyframes"
    assert closer.loops[0].query_index >= loop_dst_start
    assert closer.pgo_log and all(e["branch"] == "scalable" for e in closer.pgo_log)
    path = closer.optimized_path()
    err_corr = np.linalg.norm(path[loop_dst_start:N] - pos_true[loop_dst_start:N], axis=1)
    err_vio = np.linalg.norm(pos_vio[loop_dst_start:N] - pos_true[loop_dst_start:N], axis=1)
    assert np.median(err_corr) < 0.5 * np.median(err_vio), (
        np.median(err_corr), np.median(err_vio))


def test_loopcloser_scalable_branch_in_situ_past_512():
    """The quick case of the in-situ drive: 540 keyframes on a 30 m circle,
    loops from keyframe 520 on, closed through ``add_keyframe`` on the
    scalable branch (6 GN x 32 CG per solve, solves batched every 8
    keyframes): the corrected path beats the drifted one."""
    N, start = 540, 520
    closer = _closer(min_correspondences=25, pnp_ransac_iterations=64)
    closer.pgo_gn_iters, closer.pgo_cg_iters = 6, 32
    pos_true, pos_vio, n_loops = drive_past_512(closer, N, start, 30.0)
    closer.flush()
    _check_drive(closer, N, start, pos_true, pos_vio, n_loops)


@pytest.mark.slow
def test_loopcloser_pcg_branch_in_situ_past_2048():
    """test_loopcloser_scale.py:216: 2,120 keyframes on an 80 m circle, loops
    from keyframe 2,100 on: capacity doubling, the scalable branch, the
    database's device query and inverted file, and drift correction."""
    N, start = 2120, 2100
    closer = _closer(min_correspondences=25, pnp_ransac_iterations=64)
    closer.pgo_gn_iters, closer.pgo_cg_iters = 6, 32
    pos_true, pos_vio, n_loops = drive_past_512(closer, N, start, 80.0)
    _check_drive(closer, N, start, pos_true, pos_vio, n_loops)
    assert closer.capacity > 2048
    assert closer.db.count >= closer.db.DEVICE_QUERY_AT
    assert len(closer.db._inv) > 0  # the inverted-file retrieval ran
