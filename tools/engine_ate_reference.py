"""Trajectory error of the VIO engine at the shipped underwater configuration,
JAX package and PyTorch port on identical events, on the CPU in float32.

The reference figures for ``chip_smoke.py``'s ATE bounds. Each process
imports only the package it runs:

    python3 tools/engine_ate_reference.py write EVENTS.npz
    JAX_PLATFORMS=cpu python3 tools/engine_ate_reference.py jax EVENTS.npz
    JAX_PLATFORMS=cpu python3 tools/engine_ate_reference.py jax-split EVENTS.npz
    python3 tools/engine_ate_reference.py torch EVENTS.npz
    python3 tools/engine_ate_reference.py torch-split EVENTS.npz

``write`` renders the port's synthetic sequence (``chip_smoke.py``'s:
configs/underwater_sonar_depth.yaml, two 800x600 cameras, start-from-rest
trajectory, 10 Hz for 3 s, depth and sonar events, seed 0) and stores its
events as uint8 images (the engines quantize float images to uint8 before
upload, so this loses nothing) with the renderer's ground truth. ``jax`` and
``torch`` feed the events to that package's ``VioEngine`` in float32 on the
CPU and print the SE(3)-aligned ATE and per-frame tracking: ``jax`` and
``torch`` through the serial ``add_frame``, ``jax-split`` and ``torch-split``
through the pipelined engine's split steps on one thread (``frontend_stage``
then ``backend_step`` per frame, ``add_frame`` for the frame that
initializes, ``backend_flush`` at the end). All run with
``time_limit`` 0, a fixed 10 LM iterations per frame: the config's
``timeLimit`` budget would follow each host's wall clock and make the
figure depend on the machine.
"""
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
CONFIG = os.path.join(ROOT, "configs", "underwater_sonar_depth.yaml")
DURATION, CAM_RATE, SEED = 3.0, 10.0, 0
SCENE = dict(n_points=600, spread=6.0, depth_offset=3.0, t_first_frame=0.12)


def write(path):
    from svin_tpu_torch import sim
    from svin_tpu_torch.pipeline import load_config, synthetic_sequence

    cfg = load_config(CONFIG)
    rig = cfg.build_rig()
    events, renderer = synthetic_sequence(
        rig, duration=DURATION, cam_rate=CAM_RATE, imu_rate=float(cfg.imu.rate),
        imu_params=cfg.imu, seed=SEED, traj=sim.default_trajectory(scale=0.4, ramp_tau=0.8),
        depth_enabled=True, sonar_enabled=True, sonar_T_SSo=cfg.T_SSo, **SCENE)
    kinds, ts, vals, imgs, gt = [], [], [], [], []
    for ev in events:
        kinds.append(ev.kind)
        ts.append(ev.t)
        if ev.kind == "imu":
            vals.append(np.concatenate(ev.imu))
        elif ev.kind == "depth":
            vals.append(np.array([ev.depth, 0, 0, 0, 0, 0.0]))
        elif ev.kind == "sonar":
            vals.append(np.array([*ev.sonar, 0, 0, 0, 0.0]))
        else:
            vals.append(np.full(6, len(imgs), float))
            imgs.append(np.stack([np.clip(i * 255.0 + 0.5, 0, 255).astype(np.uint8)
                                  for i in ev.images]))
            gt.append(renderer.pose(ev.t).r.numpy())
    np.savez_compressed(path, kinds=np.array(kinds), t=np.array(ts), vals=np.array(vals),
                        images=np.stack(imgs), gt=np.stack(gt))
    print(f"wrote {len(imgs)} frames, {len(kinds)} events to {path}")


def replay(engine, path, split=False):
    d = np.load(path)
    results, walls = [], []

    def keep(r):
        if r is not None:
            results.append(r)

    for kind, t, v in zip(d["kinds"], d["t"], d["vals"]):
        if kind == "imu":
            engine.add_imu_measurement(t, v[:3], v[3:])
        elif kind == "depth":
            engine.add_depth_measurement(t, v[0])
        elif kind == "sonar":
            engine.add_sonar_measurement(t, v[0], v[1])
        else:
            images = list(d["images"][int(v[0])])
            t0 = time.perf_counter()
            if split and engine.n_states > 0:
                t_s, fd = engine.frontend_stage(t, images)
                keep(engine.backend_step(t_s, images, fd))
            else:
                keep(engine.add_frame(t, images))
            walls.append(time.perf_counter() - t0)
    if split:
        keep(engine.backend_flush())
    est = np.stack([np.asarray(r.T_WS.r) for r in results])
    gt = d["gt"][len(d["gt"]) - len(results):]
    return results, est, gt, walls


def report(name, results, est, gt, ate_rmse):
    rmse, _ = ate_rmse(est, gt, with_scale=False)
    _, al = ate_rmse(est, gt, with_scale=True)
    print(f"{name}: frames {len(results)}, keyframes {sum(r.is_keyframe for r in results)}, "
          f"median tracked {np.median([r.num_tracked for r in results[1:]]):.0f}, "
          f"ATE (SE(3)) {rmse:.6f} m, Sim(3) scale {al.scale:.4f}")
    print("  tracked per frame:", [r.num_tracked for r in results])
    print("  LM iterations per frame:", [r.lm_iterations for r in results])


def main():
    mode, path = sys.argv[1], sys.argv[2]
    if mode == "write":
        return write(path)
    if mode in ("jax", "jax-split"):
        import jax

        # a CPU run: a backend plugin registered at interpreter start-up
        # (any factory but JAX's own platforms) is dropped before any
        # backend initializes
        jax.config.update("jax_platforms", "cpu")
        try:
            from jax._src import xla_bridge

            for name in list(xla_bridge._backend_factories):
                if name not in ("cpu", "cuda", "rocm", "tpu", "gpu", "METAL"):
                    xla_bridge._backend_factories.pop(name, None)
        except (ImportError, AttributeError):
            pass  # a JAX without this private registry has nothing to drop
        jax.config.update("jax_enable_x64", False)
        from svin_tpu.evaluation import ate_rmse
        from svin_tpu.pipeline import VioEngine, load_config

        cfg = load_config(CONFIG)
        cfg.time_limit = 0.0
        engine = VioEngine(cfg)
    else:
        import torch

        torch.set_num_threads(4)
        from svin_tpu_torch.evaluation import ate_rmse
        from svin_tpu_torch.pipeline import VioEngine, load_config

        cfg = load_config(CONFIG)
        cfg.time_limit = 0.0
        engine = VioEngine(cfg, dtype=torch.float32, device="cpu")
    results, est, gt, walls = replay(engine, path, split=mode.endswith("-split"))
    report(mode, results, est, gt, ate_rmse)
    print(f"  wall per frame: median {np.median(walls) * 1e3:.1f} ms on this host's CPU")


if __name__ == "__main__":
    main()
