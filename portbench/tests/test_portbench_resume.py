"""A session resumed on a prior map past the closer's 512-keyframe switch:
the existing mixes render as before, the ``resume`` prior lies along the
window's path (cam0 rendered past the window's frames where it reaches
beyond them), and a tiny resumed run (the switch moved down in the test
alone) taps the scalable pose-graph solve, reads ``correct``, and fails
under both of its controls."""
from __future__ import annotations

import contextlib
import hashlib
import io
import json
import os

import numpy as np
import pytest

import portbench_tiny as tiny
from portbench import control, gen, run

# sha256 of every array the generator made for the two mixes before it
# learned a prior without laps (tiny rig, 120 frames, seed 2**31 + 77, on
# the CPU): events, images, prior
DIGESTS = {"transect": "0e6a23ff025fef8f58c1a865ffb0aca3d0b946cf3b3b55f02adb01d917d47bc5",
           "laps": "2b24ab88818ccad4dee7d813023e70fb3bf0a2975f55f90e6a3e749847129c1c"}


def _digest(seq: gen.Sequence) -> str:
    h = hashlib.sha256()

    def add(x):
        a = np.ascontiguousarray(np.asarray(x))
        h.update(str((a.dtype.str, a.shape)).encode())
        h.update(a.tobytes())

    for f in ("frame_t", "frame_img", "images", "imu_t", "imu_gyro", "imu_acc"):
        add(getattr(seq, f))
    for a in (seq.scene.points, seq.scene.brightness, seq.scene.icov, seq.scene.sonar_points):
        add(a)
    h.update(repr(seq.depth).encode())
    h.update(repr(seq.sonar).encode())
    for ex in seq.prior:
        for k in sorted(ex):
            if k == "point_covisibilities":
                h.update(repr(ex[k]).encode())
            else:
                add(ex[k])
    for R, p in seq.prior_T_WC:
        add(R)
        add(p)
    return h.hexdigest()


def _load(*parts):
    with open(os.path.join(tiny.PORTBENCH, *parts)) as f:
        return json.load(f)


@pytest.mark.parametrize("mix", sorted(DIGESTS))
def test_the_existing_mixes_render_as_before(mix):
    rig = gen.load_rig(_load("tests", "tiny", "tiny_stereorig.json"))
    t = _load("traffic", mix + ".json")
    t["frames"] = 120
    assert _digest(gen.make_sequence(rig, t, 2**31 + 77)) == DIGESTS[mix]


def test_the_resume_prior_lies_along_the_windows_path():
    """Full size: the prior passes the closer's 512-keyframe switch with
    room for the window's keyframes, its stamps all precede the window's,
    and every window frame from the first past the ramp to the prior's last
    lies within one frame of a prior keyframe (the database finds a place
    again only from nearly the same view)."""
    rig = gen.load_rig(_load("configs", "okvis_euroc_stereo.json"))
    t = _load("traffic", "resume.json")
    dt = 1.0 / rig.cam_rate
    frame_t = t["t_first_frame_s"] + dt * np.arange(t["frames"])
    k0 = int(np.searchsorted(frame_t, t["ramp_tau_s"]))
    n, every = t["prior_keyframes"], t["prior_every_frames"]
    kf = k0 + every * np.arange(n)
    assert n >= 512 + 128 and not t.get("lap_s") and t["prior_query"] is False
    assert t["t_first_frame_s"] + kf[-1] * dt - t["prior_t_shift_s"] < frame_t[0]
    assert kf[-1] < t["frames"] and every <= 2  # the window's frames reach past the prior's


def test_the_prior_renders_cam0_past_the_windows_frames():
    """Tiny rig: prior keyframes within the window take its cam0 images,
    those beyond are rendered at their own times as the window's are."""
    rig = gen.load_rig(_load("tests", "tiny", "tiny_stereorig.json"))
    t = _load("tests", "tiny", "tiny_resume.json")
    seq = gen.make_sequence(rig, t, 2**31 + 3)
    k0 = int(np.searchsorted(seq.frame_t, t["ramp_tau_s"]))
    kf = k0 + t["prior_every_frames"] * np.arange(t["prior_keyframes"])
    inside, beyond = kf < len(seq.frame_t), kf >= len(seq.frame_t)
    assert inside.any() and beyond.any()
    images = np.stack([ex["image"] for ex in seq.prior])
    np.testing.assert_array_equal(images[inside], seq.images[kf[inside], 0])
    t_f = t["t_first_frame_s"] + kf[beyond] / rig.cam_rate
    np.testing.assert_array_equal(images[beyond], gen.render(rig, seq.scene, *seq.truth(t_f))[:, 0])


@pytest.fixture
def scalable():
    """The closer's scalable branch past 16 keyframes, solves batched every 2
    and loop candidates after 5 (the tiny prior has 30 keyframes); put back
    after the test."""
    from svin_tpu_torch.loopclosure import loop_closure

    names = ("DENSE_MAX_NODES", "SOLVE_BATCH_KF", "RECENCY_EXCLUSION")
    saved = [getattr(loop_closure, k) for k in names]

    def patch(engine, closer):
        loop_closure.DENSE_MAX_NODES, loop_closure.SOLVE_BATCH_KF = 16, 2
        loop_closure.RECENCY_EXCLUSION = 5

    yield patch
    for k, v in zip(names, saved):
        setattr(loop_closure, k, v)


# float64 on the CPU: the PCG ends below float32's floor, and the held
# nodes never move
LIMITS = dict(tiny.LIMITS, pg_pcg_excess={"max": 1.0}, pg_pcg_fixed_m={"max": 1e-12})


@pytest.mark.parametrize("variant,fails", [
    ("sound", None),
    ("tf32", "pg_pcg_excess"),  # the control: TF32 below the stated float32
    ("pg_shift", "pg_pcg_fixed_m"),  # an answer altered where it is produced
    ("pg_frozen", "pg_pcg_excess"),  # a step that returns its state unchanged
])
def test_a_tiny_resumed_run_judges_the_scalable_solve(tmp_path, scalable, variant, fails):
    from svin_tpu_torch.parallel import pcg

    solver = pcg.optimize_4dof_pcg
    root = tiny.make_root(tmp_path, cell="tiny.resume", traffic="resume", limits=LIMITS)

    def both(engine, closer):
        scalable(engine, closer)
        if control.VARIANTS[variant] is not None:
            control.VARIANTS[variant](engine, closer)

    out, err = io.StringIO(), io.StringIO()
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = run.main(["--workload", "tiny.resume", "--seed", str(2**31 + 5), "--seconds",
                           "3600", "--trace", "0"], root=root, device="cpu", patch=both)
    finally:
        pcg.optimize_4dof_pcg = solver
    assert rc == 0
    res = tiny.last_json(out.getvalue())
    solves = [ln for ln in err.getvalue().splitlines() if ln.startswith("reading pg_pcg_solves")]
    assert solves and float(solves[0].split()[2]) >= 1, err.getvalue()[-2000:]
    if fails is None:
        assert res["correct"] is True, res["checks"]
        assert res["checks"]["pg_pcg_fixed_m"][0] == 0.0
    else:
        assert res["correct"] is False, res["checks"]
        v, _, lim = res["checks"][fails]
        assert v is None or v > lim, res["checks"]


def test_the_taps_put_both_pose_graph_solvers_back():
    from svin_tpu_torch.loopclosure import loop_closure
    from svin_tpu_torch.parallel import pcg

    from portbench import record

    class Engine:
        solve = matcher = None

    before = loop_closure.optimize_4dof, pcg.optimize_4dof_pcg
    taps = record.Taps(Engine(), Engine(), 1)
    assert (loop_closure.optimize_4dof, pcg.optimize_4dof_pcg) != before
    taps.remove()
    assert (loop_closure.optimize_4dof, pcg.optimize_4dof_pcg) == before


def test_the_sparse_reference_solves_the_dense_ones_equations():
    """The scalable graphs' reference (sparse LU over the free coordinates)
    against the dense one on a chain with loops, Huber-active loop edges and
    invalid padding; and a solve that moves nothing reads the graph's descent
    over float32's floor, thousands of F."""
    from portbench import reference

    rng = np.random.default_rng(0)
    N, n = 96, 80
    nodes = {"p": np.cumsum(rng.normal(0, 0.3, (N, 3)), 0).astype(np.float32),
             "yaw": rng.normal(0, 0.3, N).astype(np.float32),
             "pitch": rng.normal(0, 0.05, N).astype(np.float32),
             "roll": rng.normal(0, 0.05, N).astype(np.float32), "valid": np.arange(N) < n}
    seq = [(k - b, k) for k in range(1, n) for b in (1, 2) if k - b >= 0]
    loops = [(int(rng.integers(0, 10)), int(rng.integers(n - 10, n))) for _ in range(6)]
    i, j = (np.array(v) for v in zip(*(seq + loops)))
    E = len(i)
    edges = {"i": i, "j": j, "t_ij": rng.normal(0, 0.3, (E, 3)), "yaw_ij": rng.normal(0, 0.1, E),
             "weight": np.ones(E), "is_loop": np.arange(E) >= len(seq), "valid": np.ones(E, bool)}
    dense = reference.pose_graph_4dof(nodes, edges, 3, 10)
    sparse = reference.pose_graph_4dof(nodes, edges, 3, 10, sparse=True)
    for a, b in zip(dense, sparse):
        np.testing.assert_allclose(a, b, atol=1e-10)
    frozen = (nodes, edges, 3, 10, (nodes["p"], nodes["yaw"]), 96, 32)
    assert reference.pcg_numbers([frozen])["pg_pcg_excess"] > 1e3
