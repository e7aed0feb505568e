"""Engine checkpoints across the two packages, and the outputs writers.

Input: the events of ``test_torch_engine.py``'s run (two 200x150 cameras,
water-depth and sonar events, seed 3, float64 on the CPU, ``time_limit``
0). The JAX engine runs serially to frame 6 and writes a checkpoint with
its ``save_engine``; a fresh JAX engine (its compiled programs taken over
from the first: they are functions of the configuration alone) loads it
with the JAX ``load_engine``, a fresh port engine with the port's, and both
step over the remaining events: per frame identical decisions and counts,
positions within 1e-6 m, the port drawing the JAX engine's RANSAC samples.
The file's leaf numbering is held to ``jax.tree_util.tree_flatten``'s. A
file the port writes loads in the JAX package's ``load_engine`` with equal
arrays. The outputs writers give the JAX ones' CSV text, log text and
rendered arrays on the same inputs.

Loop-closer checkpoints: a JAX ``LoopCloser`` takes the traverse of the
rendered revisit (``torch_parity.revisit_exports``, 8 keyframes) and saves;
the JAX closer reloaded and the port's (loading the same file) take the 3
revisits: the same loops and inlier counts, the optimized path within 1e-6
m, the rebuilt inverted file equal. A file the port writes loads in the JAX
package's ``load_loop_closer`` with equal arrays.
"""
import json

import jax
import numpy as np
import pytest
import torch

from svin_tpu import sim as jsim
from svin_tpu.pipeline import VioEngine as JaxEngine
from svin_tpu.pipeline import checkpoint as jckpt
from svin_tpu.pipeline import outputs as jout
from svin_tpu.pipeline import synthetic_sequence as jax_sequence
from svin_tpu.pipeline.vio import FrameResult as JaxFrameResult
from svin_tpu.kinematics import Transformation as JaxTransformation
from svin_tpu_torch.pipeline import checkpoint as tckpt
from svin_tpu_torch.pipeline import outputs as tout
from svin_tpu_torch.pipeline import run_events
from svin_tpu_torch.pipeline.vio import FrameResult
from svin_tpu_torch.kinematics import Transformation
import svin_tpu.loopclosure.loop_closure as jlc
from test_torch_loopclosure import jax_cfg, port_closer, recency
from torch_parity import revisit_exports
from test_torch_engine import HANDOVER_FRAME, T_SSO, _check_frames, _jax_config, port_engine
from vio_fixtures import small_rig

torch.set_num_threads(1)

# the JAX engine's compiled programs (functions of its configuration)
PROGRAMS = ("_opt_programs", "_make_opt_program", "_opt_program_for", "_marginalize_fn",
            "_preint_prop_fn", "_gravity_fn", "_preintegrate_fn", "_gate_match_all",
            "_match_stage_fn", "_stereo_fns", "_temporal_fns")


def jax_events():
    events, _ = jax_sequence(
        small_rig(), duration=2.6, cam_rate=6.0, imu_rate=100.0, imu_params=_jax_config().imu,
        seed=3, n_points=300, traj=jsim.default_trajectory(scale=0.4, ramp_tau=0.8),
        spread=6.0, depth_offset=3.0, t_first_frame=0.12, depth_enabled=True,
        sonar_enabled=True, sonar_T_SSo=T_SSO,
    )
    return list(events)


def fresh_jax_engine(compiled):
    eng = JaxEngine(_jax_config(), rig=small_rig())
    for name in PROGRAMS:
        setattr(eng, name, getattr(compiled, name))
    return eng


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    events = jax_events()
    jeng = JaxEngine(_jax_config(), rig=small_rig())
    n, at = 0, None
    for i, ev in enumerate(events):
        if ev.kind == "imu":
            jeng.add_imu_measurement(ev.t, *ev.imu)
        elif ev.kind == "depth":
            jeng.add_depth_measurement(ev.t, ev.depth)
        elif ev.kind == "sonar":
            jeng.add_sonar_measurement(ev.t, *ev.sonar)
        elif jeng.add_frame(ev.t, ev.images) is not None:
            n += 1
            if n == HANDOVER_FRAME:
                at = i + 1
                break
    path = str(tmp_path_factory.mktemp("ckpt") / "jax.npz")
    jckpt.save_engine(jeng, path)
    jres = run_events(jckpt.load_engine(fresh_jax_engine(jeng), path), events[at:])
    return dict(events=events, at=at, path=path, jeng=jeng, jres=jres)


def test_jax_checkpoint_continues_in_the_port_frame_by_frame(run):
    eng = tckpt.load_engine(port_engine(), run["path"])
    assert eng.n_states == run["jeng"].n_states
    res = run_events(eng, run["events"][run["at"]:])
    assert len(res) >= 6
    _check_frames(res, run["jres"])


def test_leaf_order_is_jax_tree_flatten_order(run):
    """The file's numbering against the JAX package's own flattening of the
    engine's tables: the same paths and the same arrays, leaf by leaf."""
    data = np.load(run["path"])
    for prefix, tree, paths in (("window", run["jeng"].window, tckpt.WINDOW_LEAVES),
                                ("factors", run["jeng"].factors, tckpt.FACTORS_LEAVES)):
        flat = jax.tree_util.tree_flatten_with_path(tree)[0]
        assert [".".join(k.name for k in p) for p, _ in flat] == list(paths)
        for i, (_, leaf) in enumerate(flat):
            np.testing.assert_array_equal(data[f"{prefix}__{i}"], np.asarray(leaf))


def host_state(eng) -> dict:
    """What a checkpoint holds, by name, as numpy (descriptors as uint32)."""
    out = {}
    for prefix, paths in (("window", tckpt.WINDOW_LEAVES), ("factors", tckpt.FACTORS_LEAVES)):
        tree = getattr(eng, prefix)
        for path in paths:
            leaf = tree
            for name in path.split("."):
                leaf = getattr(leaf, name)
            out[f"{prefix}.{path}"] = np.asarray(leaf)
    out["lm_desc"] = np.asarray(eng._lm_desc).view(np.uint32)
    out["lm_cov"] = np.asarray(eng._lm_cov)
    out["imu"] = np.column_stack([eng.imu_t, np.stack(eng.imu_gyro), np.stack(eng.imu_acc)])
    out["trajectory"] = np.asarray([np.concatenate([[t], r, q]) for t, r, q in eng.trajectory])
    for k in ("n_states", "frame_count", "kf_count", "next_state_id", "next_lm_id",
              "last_kf_slot", "first_depth"):
        out[k] = np.asarray(json.loads(json.dumps(getattr(eng, k))))
    return out


def test_port_checkpoint_loads_in_the_jax_package(run, tmp_path):
    eng = tckpt.load_engine(port_engine(), run["path"])
    run_events(eng, run["events"][run["at"]:])
    path = str(tmp_path / "port.npz")
    tckpt.save_engine(eng, path)
    got = host_state(jckpt.load_engine(JaxEngine(_jax_config(), rig=small_rig()), path))
    want = host_state(eng)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    # and back into the port: the same arrays again
    again = host_state(tckpt.load_engine(port_engine(), path))
    for k in want:
        np.testing.assert_array_equal(again[k], want[k], err_msg=k)


def test_save_refuses_a_solve_in_flight(run, tmp_path):
    eng = tckpt.load_engine(port_engine(), run["path"])
    frames = [ev for ev in run["events"][run["at"]:] if ev.kind == "frame"]
    for ev in run["events"][run["at"]:]:
        if ev.kind == "imu":
            eng.add_imu_measurement(ev.t, *ev.imu)
        if ev is frames[0]:
            break
    t_s, fd = eng.frontend_stage(frames[0].t, frames[0].images)
    eng.backend_step(t_s, frames[0].images, fd)
    with pytest.raises(ValueError, match="in flight"):
        tckpt.save_engine(eng, str(tmp_path / "x.npz"))
    eng.backend_flush()
    tckpt.save_engine(eng, str(tmp_path / "x.npz"))


# ---------------------------------------------------------------- outputs
def results_pair(n=6, seed=0):
    """The same frame results as JAX-package and port FrameResults."""
    rng = np.random.default_rng(seed)
    out_j, out_t = [], []
    for k in range(n):
        r, q = rng.standard_normal(3), rng.standard_normal(4)
        q /= np.linalg.norm(q)
        sb = rng.standard_normal(9)
        kw = dict(timestamp=0.1 * k + 0.123456789, speed_bias=sb, is_keyframe=bool(k % 2),
                  num_tracked=k, num_new_landmarks=2 * k, cost=float(k))
        out_j.append(JaxFrameResult(T_WS=JaxTransformation(r=r, q=q), **kw))
        out_t.append(FrameResult(T_WS=Transformation(r=r, q=q), **kw))
    return out_j, out_t


def test_csv_writers_give_the_jax_text(tmp_path):
    res_j, res_t = results_pair()
    for mod, res, name in ((jout, res_j, "j"), (tout, res_t, "t")):
        w = mod.CsvStateWriter(str(tmp_path / f"state_{name}.csv"))
        for r in res:
            w.write(r)
        w.close()
        lw = mod.CsvLandmarkWriter(str(tmp_path / f"lm_{name}.csv"))
        rng = np.random.default_rng(1)
        lw.write_map(np.arange(7, dtype=np.int32), rng.standard_normal((7, 3)), rng.random(7))
        lw.close()
    for stem in ("state", "lm"):
        assert (tmp_path / f"{stem}_t.csv").read_text() == (tmp_path / f"{stem}_j.csv").read_text()
    assert len((tmp_path / "state_t.csv").read_text().splitlines()) == 7


def test_draw_and_view_give_the_jax_arrays():
    rng = np.random.default_rng(2)
    img = (rng.random((40, 60)) * 255).astype(np.uint8)
    uv = rng.random((12, 2)) * [60, 40]
    valid, matched = rng.random(12) > 0.2, rng.random(12) > 0.5
    for a in (img, img.astype(np.float32) / 255.0):
        np.testing.assert_array_equal(tout.draw_keypoints(a, uv, valid, matched),
                                      jout.draw_keypoints(a, uv, valid, matched))
    pairs = np.stack([rng.permutation(12)[:8], rng.permutation(12)[:8]], axis=1)
    np.testing.assert_array_equal(tout.draw_matches(img, uv, img[:30], uv * 0.7, pairs),
                                  jout.draw_matches(img, uv, img[:30], uv * 0.7, pairs))
    res_j, res_t = results_pair(20, seed=3)
    vj, vt = jout.TopDownViewer(120, 0.2), tout.TopDownViewer(120, 0.2)
    assert np.array_equal(vt.render(), vj.render())  # the empty canvas
    for rj, rt in zip(res_j, res_t):
        vj.add_result(rj)
        vt.add_result(rt)
    img_t = vt.render()
    np.testing.assert_array_equal(img_t, vj.render())
    assert img_t.shape == (120, 120, 3) and (img_t != 10).any()


def test_debug_output_dirs_give_the_jax_files(tmp_path):
    import cv2

    for mod, name in ((jout, "j"), (tout, "t")):
        d = mod.DebugOutputDirs(str(tmp_path / name))
        d.log_loop(5, 1, 30, np.array([0.1, 0.2, 0.3]), 0.05)
        d.log_switch(1.5, "VIO->PRIMITIVE")
        d.save_image("loop_candidates", "kf5", np.zeros((4, 4)))
        d.save_image("pnp_verified", "kf6", np.linspace(0, 1, 4800).reshape(40, 120),
                     caption="current frame: 6")
        d.close()
    for f in ("loop_closure.txt", "switch_info.txt"):
        assert (tmp_path / "t" / f).read_text() == (tmp_path / "j" / f).read_text()
    for f in ("loop_candidates/kf5.png", "pnp_verified/kf6.png"):
        a = cv2.imread(str(tmp_path / "t" / f), cv2.IMREAD_UNCHANGED)
        b = cv2.imread(str(tmp_path / "j" / f), cv2.IMREAD_UNCHANGED)
        assert a is not None and np.array_equal(a, b), f
    assert cv2.imread(str(tmp_path / "t" / "pnp_verified/kf6.png")).shape[0] == 90


# ------------------------------------------------------ loop-closer files
@pytest.fixture(scope="module")
def loop_run(tmp_path_factory):
    cam, exports, _ = revisit_exports()
    path = str(tmp_path_factory.mktemp("loop") / "jax.loop.npz")
    with recency(5):
        jc = jlc.LoopCloser(cam, jax_cfg())
        for e in exports[:8]:
            jc.add_keyframe(e)
        jckpt.save_loop_closer(jc, path)
        again = jckpt.load_loop_closer(jlc.LoopCloser(cam, jax_cfg()), path)
        loops = [again.add_keyframe(e) for e in exports[8:]]
    return dict(cam=cam, exports=exports, path=path, jc=again, loops=loops)


def _loops(ls):
    return [(lp.query_index, lp.match_index, lp.num_inliers) for lp in ls if lp is not None]


def test_jax_loop_checkpoint_continues_in_the_port(loop_run):
    with recency(5):
        tc = tckpt.load_loop_closer(port_closer(jax_cfg()), loop_run["path"])
        assert len(tc.keyframes) == 8 and tc.db.count == 8
        loops = [tc.add_keyframe(e) for e in loop_run["exports"][8:]]
    jc = loop_run["jc"]
    assert _loops(loops) == _loops(loop_run["loops"]) and len(_loops(loops)) >= 2
    assert tc.stats == jc.stats
    np.testing.assert_allclose(tc.optimized_path(), jc.optimized_path(), rtol=0, atol=1e-6)
    assert tc.db._inv.keys() == jc.db._inv.keys()
    for w, (ii, ww) in jc.db._inv.items():
        assert tc.db._inv[w][0] == ii and np.allclose(tc.db._inv[w][1], ww, rtol=0, atol=0)


def test_port_loop_checkpoint_loads_in_the_jax_package(loop_run, tmp_path):
    with recency(5):
        tc = tckpt.load_loop_closer(port_closer(jax_cfg()), loop_run["path"])
        for e in loop_run["exports"][8:]:
            tc.add_keyframe(e)
    path = str(tmp_path / "port.loop.npz")
    tckpt.save_loop_closer(tc, path)
    jc = jckpt.load_loop_closer(jlc.LoopCloser(loop_run["cam"], jax_cfg()), path)
    for a, b in zip(jc.nodes + jc.edges, tc.nodes + tc.edges):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert (jc.n_edges, jc.earliest_loop_index, jc.sequence_cnt, jc._kf_by_export) == (
        tc.n_edges, tc.earliest_loop_index, tc.sequence_cnt, tc._kf_by_export)
    np.testing.assert_array_equal(jc.t_drift, tc.t_drift)
    np.testing.assert_array_equal(jc.db.word_ids[: jc.db.count], tc.db.word_ids[: tc.db.count])
    assert len(jc.keyframes) == len(tc.keyframes) == 11
    for a, b in zip(jc.keyframes, tc.keyframes):
        np.testing.assert_array_equal(np.asarray(a.window_desc), b.window_desc.view(np.uint32))
        np.testing.assert_array_equal(np.asarray(a.extra_desc), b.extra_desc.view(np.uint32))
        np.testing.assert_array_equal(a.points_W, b.points_W)
    for (t1, q1), (t2, q2) in zip(jc._edges_full, tc._edges_full):
        np.testing.assert_array_equal(t1, t2)
        np.testing.assert_array_equal(q1, q2)
    # and back into the port: the same tables and features
    back = tckpt.load_loop_closer(port_closer(jax_cfg()), path)
    for a, b in zip(back.nodes + back.edges, tc.nodes + tc.edges):
        np.testing.assert_array_equal(a, b)
