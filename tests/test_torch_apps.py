"""The port's apps on the CPU (``--device cpu``, float64, the kernels'
plain versions), mirroring the JAX package's ``tests/test_app.py`` and
``test_train_vocabulary_cli``: ``run_synchronous`` on the rendered
synthetic sequence writes every output and a checkpoint that a second run
resumes; ``run_live`` replays the same sequence through the threaded
pipeline; ``train_vocabulary`` writes, from the same EuRoC folder, the same
vocabulary and idf arrays as the JAX app (flat and product), and the
loop closer loads them. Without a card and without ``--device cpu`` every
app raises.
"""
import contextlib
import json
import os

import numpy as np
import pytest
import torch

from test_app import CONFIG_YAML

torch.set_num_threads(1)

OUTPUTS = {"svin_vio.txt", "svin_loop.txt", "svin_robust.txt", "state.csv", "landmarks.csv",
           "global_map.ply", "keyframes.ply", "switch_info.txt", "loop_stats.json", "top_view.png"}


@contextlib.contextmanager
def synth_duration(seconds):
    old = os.environ.get("SVIN_SYNTH_DURATION")
    os.environ["SVIN_SYNTH_DURATION"] = str(seconds)
    try:
        yield
    finally:
        if old is None:
            del os.environ["SVIN_SYNTH_DURATION"]
        else:
            os.environ["SVIN_SYNTH_DURATION"] = old


@pytest.fixture(scope="module")
def session(tmp_path_factory):
    """One run_synchronous session on the CPU with a checkpoint saved."""
    from svin_tpu_torch.apps.run_synchronous import main

    d = tmp_path_factory.mktemp("app")
    cfg = d / "rig.yaml"
    cfg.write_text(CONFIG_YAML)
    with synth_duration(2.0):
        rc = main([str(cfg), "--synthetic", str(d / "out1"), "--device", "cpu",
                   "--save-checkpoint", str(d / "session")])
    return dict(rc=rc, dir=d, cfg=str(cfg))


def test_run_synchronous_writes_every_output(session):
    assert session["rc"] == 0
    out = session["dir"] / "out1"
    assert OUTPUTS <= set(os.listdir(out))
    traj = np.loadtxt(out / "svin_vio.txt")
    assert traj.ndim == 2 and traj.shape[1] == 8 and traj.shape[0] >= 8
    np.testing.assert_allclose(np.linalg.norm(traj[:, 4:8], axis=1), 1.0, atol=1e-5)
    loop = np.loadtxt(out / "svin_loop.txt", ndmin=2)
    robust = np.loadtxt(out / "svin_robust.txt", ndmin=2)
    stats = json.loads((out / "loop_stats.json").read_text())
    assert loop.shape[1] == 8 and stats["n_keyframes"] == loop.shape[0] == robust.shape[0] >= 2
    assert set(stats) >= {"stats", "pgo_log", "n_restored", "n_loops", "loops"}
    for ply in ("global_map.ply", "keyframes.ply"):
        lines = (out / ply).read_text().splitlines()
        n_vert = int(next(x for x in lines if x.startswith("element vertex")).split()[-1])
        assert lines[0] == "ply" and n_vert > 0
    assert (out / "state.csv").read_text().count("\n") >= 10
    assert (out / "top_view.png").read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    assert os.path.exists(str(session["dir"] / "session.engine.npz"))
    assert os.path.exists(str(session["dir"] / "session.loop.npz"))


def test_run_synchronous_resumes_a_checkpoint(session):
    from svin_tpu_torch.apps.run_synchronous import main

    d = session["dir"]
    n1 = np.loadtxt(d / "out1" / "svin_loop.txt", ndmin=2).shape[0]
    with synth_duration(1.2):
        rc = main([session["cfg"], "--synthetic", str(d / "out2"), "--device", "cpu",
                   "--resume", str(d / "session")])
    assert rc == 0
    traj2 = np.loadtxt(d / "out2" / "svin_loop.txt", ndmin=2)
    assert traj2.shape[0] > n1  # both sessions' keyframes
    stats = json.loads((d / "out2" / "loop_stats.json").read_text())
    assert stats["n_restored"] == n1


def test_run_live_replays_the_sequence(tmp_path):
    from svin_tpu_torch.apps.run_live import main

    cfg = tmp_path / "rig.yaml"
    cfg.write_text(CONFIG_YAML)
    with synth_duration(1.5):
        rc = main([str(cfg), "--synthetic", str(tmp_path / "live"), "--speed", "0",
                   "--device", "cpu"])
    assert rc == 0
    traj = np.loadtxt(tmp_path / "live" / "svin_vio.txt", ndmin=2)
    assert traj.shape[1] == 8 and traj.shape[0] >= 2
    assert os.path.exists(tmp_path / "live" / "svin_loop.txt")


def _euroc(tmp_path):
    root = tmp_path / "seq" / "mav0"
    (root / "imu0").mkdir(parents=True)
    (root / "cam0" / "data").mkdir(parents=True)
    with open(root / "imu0" / "data.csv", "w") as f:
        f.write("#timestamp,wx,wy,wz,ax,ay,az\n")
        f.write(f"{int(1e9)},0.0,0.0,0.0,0.0,0.0,9.81\n")
    rng = np.random.RandomState(1)
    for k in range(4):
        img = (rng.rand(96, 128) * 255).astype(np.uint8)
        np.save(root / "cam0" / "data" / f"{int(1e9 * (1 + 0.1 * k))}.npy", img)
    return str(tmp_path / "seq")


@pytest.mark.parametrize("product", [False, True])
def test_train_vocabulary_writes_the_jax_vocabulary(tmp_path, product):
    from svin_tpu.apps.train_vocabulary import main as jax_main
    from svin_tpu_torch.apps.train_vocabulary import main
    from svin_tpu_torch.convert import config_from_numpy
    from svin_tpu_torch.cameras import make_camera
    from svin_tpu_torch.loopclosure import LoopCloser
    from svin_tpu.pipeline.config import VioConfig

    seq = _euroc(tmp_path)
    args = ["--size", "64", "--stride", "1", "--iters", "2", "--max-keypoints", "64"] + (
        ["--product"] if product else [])
    assert main([seq, str(tmp_path / "t.npz"), "--device", "cpu"] + args) == 0
    assert jax_main([seq, str(tmp_path / "j.npz")] + args) == 0
    got, want = np.load(tmp_path / "t.npz"), np.load(tmp_path / "j.npz")
    assert got.files == want.files
    for k in want.files:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    cfg = VioConfig()
    cfg.loop_closure.vocabulary_file = str(tmp_path / "t.npz")
    closer = LoopCloser(make_camera(128, 96, 160.0, 160.0, 64.0, 48.0, model="none"),
                        config_from_numpy(cfg), device="cpu")
    if product:
        assert closer.db.pv.idf is not None and closer.db.pv.vocab1.shape == (256, 4)
    else:
        assert closer.db.weights is not None and closer.db.vocab.shape == (64, 8)


def test_apps_raise_without_a_card_unless_given_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the apps run on it")
    from svin_tpu_torch.apps import run_live, run_synchronous, train_vocabulary

    cfg = tmp_path / "rig.yaml"
    cfg.write_text(CONFIG_YAML)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_synchronous.main([str(cfg), "--synthetic", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_live.main([str(cfg), "--synthetic", str(tmp_path / "o")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_vocabulary.main([str(tmp_path), str(tmp_path / "v.npz")])
