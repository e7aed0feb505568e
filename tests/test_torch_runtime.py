"""The port's multi-process runtime (``svin_tpu_torch.parallel.runtime``),
cooperative mapping (``apps.run_distributed_mapping``) and
``entry.dryrun_multichip`` on the CPU: the mirrors of tests/test_runtime.py
(the keyframe payload against the JAX package's, the single-process
exchange, a two-process sum and exchange, the two-process cooperative
mapping with the JAX test's assertions) and the bootstrap's rules.

Two-process cases run two gloo worker processes (``torch_dist_worker.py``:
one torch thread each, a ``file://`` rendezvous in the test's directory,
only ``svin_tpu_torch`` imported); a worker failure or timeout fails the
test.
"""
import numpy as np
import pytest
import torch
import torch.distributed as dist

from svin_tpu.parallel import pack_keyframe as jax_pack_keyframe
from svin_tpu_torch import parallel as tpar
from svin_tpu_torch.apps import run_distributed_mapping as coop
from svin_tpu_torch.entry import dryrun_multichip
from torch_dist_worker import launch

torch.set_num_threads(1)


def _export(idx):
    return {
        "kf_index": idx,
        "timestamp": 0.1 * idx,
        "T_WC_r": np.array([1.0, 2.0, 3.0]) * idx,
        "T_WC_q": np.array([0.0, 0.0, 0.0, 1.0]),
        "points_W": np.arange(9, dtype=np.float32).reshape(3, 3),
        "descriptors": np.arange(24, dtype=np.uint32).reshape(3, 8),
    }


def test_pack_keyframe_schema():
    """test_runtime.py:34 on the port, and equal to the JAX package's
    payload field by field; int32 descriptor words (the port's form) and
    tensors packed as their uint32 / numpy values."""
    pk = tpar.pack_keyframe(_export(3), cap=8)
    assert pk["points_W"].shape == (8, 3)
    assert pk["point_valid"].sum() == 3
    assert pk["descriptors"].shape == (8, 8)
    np.testing.assert_array_equal(pk["points_W"][:3], _export(3)["points_W"])
    want = jax_pack_keyframe(_export(3), cap=8)
    assert set(pk) == set(want) == {f for f, _, _ in tpar.runtime.KEYFRAME_FIELDS}
    for k in want:
        assert pk[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(pk[k], want[k], err_msg=k)
    ex = _export(3)
    ex.update(descriptors=torch.from_numpy(ex["descriptors"].view(np.int32)),
              points_W=torch.from_numpy(ex["points_W"]), T_WC_r=torch.tensor([3.0, 6.0, 9.0]))
    got = tpar.pack_keyframe(ex, cap=8)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_exchange_single_process_identity():
    """test_runtime.py:44 on the port: without a group every exchange
    returns the local payloads."""
    assert not dist.is_initialized()
    pks = [tpar.pack_keyframe(_export(i), cap=8) for i in (5, 6)]
    got = tpar.exchange_keyframe_payloads(pks, cap=8, max_per_round=4)
    assert [int(g["kf_index"]) for g in got] == [5, 6]
    edges = np.array([[0, 9, 0.1, 0.2, 0.3, 0.05, 5.0]])
    out = tpar.exchange_loop_edges(edges)
    assert out.shape == (1, 7)
    np.testing.assert_allclose(out[0], edges[0])
    pairs = tpar.exchange_shared_pairs(np.array([[0, 1, 1, 2]]))
    assert pairs.tolist() == [[0, 1, 1, 2]]


def test_initialize_distributed_rules(monkeypatch):
    """With no coordinator and one process no group is made (as the JAX
    bootstrap); more processes need a coordinator; a device other than
    CUDA needs its backend named; NCCL is never replaced by gloo;
    ``make_process_mesh`` runs on the card unless told otherwise."""
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert tpar.initialize_distributed() == (0, 1)
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="coordinator"):
        tpar.initialize_distributed(num_processes=2, process_id=0)
    with pytest.raises(ValueError, match="name a backend"):
        tpar.initialize_distributed("file:///nonexistent/rdv", 1, 0, device="cpu")
    with pytest.raises(ValueError, match="outside"):
        tpar.initialize_distributed("file:///nonexistent/rdv", 2, 2, backend="gloo", device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="NCCL needs a CUDA device"):
            tpar.initialize_distributed("file:///nonexistent/rdv", 1, 0)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tpar.make_process_mesh()
    assert not dist.is_initialized()
    mesh = tpar.make_process_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.device.type) == (None, 0, 1, "cpu")
    x = torch.ones(3)
    assert mesh.psum(x) is x


def test_two_process_distributed_exchange(tmp_path):
    """test_runtime.py:122 on the port, two gloo ranks: a sum crosses the
    process boundary (a view is summed in a copy, its base untouched), and
    the keyframe, loop-edge, shared-pair and session exchanges deliver every
    rank's payloads to every rank in rank order (checked in the workers)."""
    out = launch("exchange", 2, tmp_path, {})
    assert bool(out["ok"])


@pytest.fixture(scope="module")
def mapping(tmp_path_factory):
    """The cooperative mapping and ``dryrun_multichip`` on two gloo ranks."""
    return launch("mapping", 2, tmp_path_factory.mktemp("mapping"), {})


def test_two_process_cooperative_mapping(mapping):
    """test_runtime.py:203 on the port: two ranks run session intake →
    keyframe exchange → descriptor association → merge_sessions → the
    joint BA sharded over the two processes, with the JAX test's
    assertions (16 merged poses, >= 8 shared pairs, rank 1's residual drift
    below 0.3 x its injected drift: rank 0's summary here, rank 1's drift
    checked in its worker)."""
    s = {k.split(".", 1)[1]: v for k, v in mapping.items() if k.startswith("mapping.")}
    assert int(s["num_processes"]) == 2 and int(s["devices"]) == 2
    assert int(s["merged_poses"]) == 16
    assert int(s["shared_pairs"]) >= 8
    assert float(s["injected_drift_m"]) == 0.0 and np.isfinite(float(s["joint_cost"]))


def test_cooperative_mapping_removes_drift(tmp_path):
    """The JAX test's drift bound for rank 1: both sessions in this
    process through ``exchange``-free pieces of the chain (``build_session``,
    ``merge_sessions``, the PCG solve), with the association ``run`` makes."""
    from svin_tpu_torch.ops import hamming

    sessions, descs, drifts = [], [], []
    for rank in (0, 1):
        prob, rig, desc, _, drift = coop.build_session(rank, K=8, L_window=32, device="cpu")
        sessions.append(prob)
        descs.append(torch.from_numpy(desc))
        drifts.append(drift)
    ok = torch.ones(32, dtype=torch.bool)
    m = hamming.match_descriptors(descs[1], descs[0], ok, ok, max_distance=10, mutual=True)
    shared = [(0, int(m.idx_b[la]), 1, int(la)) for la in torch.nonzero(m.valid)[:, 0]]
    assert len(shared) >= 8
    merged, pose_maps, _ = tpar.merge_sessions(sessions, shared, anchor=0)
    out, _ = tpar.ba_solve_pcg(tpar.bucket_problem(merged), rig, iters=10, cg_iters=32)
    res = np.median(np.linalg.norm(out.pose_r.numpy()[pose_maps[1]]
                                   - (sessions[1].pose_r.numpy() - drifts[1]), axis=1))
    inj = float(np.linalg.norm(drifts[1]))
    assert inj > 0.05 and res < 0.3 * inj, (res, inj)


def test_dryrun_multichip_two_processes(mapping):
    """``dryrun_multichip(2)`` inside the two-rank group: every section ran
    with a finite cost."""
    d = {k.split(".", 1)[1]: float(v) for k, v in mapping.items() if k.startswith("dryrun.")}
    assert list(d) == ["bucketed BA", "dense pose graph", "PCG BA", "PCG pose graph", "track BA",
                       "6-DoF PCG pose graph (largest |r|)", "cooperative mapping"]
    assert all(np.isfinite(v) for v in d.values()), d


def test_dryrun_multichip_one_process():
    """``dryrun_multichip(1)`` without a group (every exchange the
    identity), and its refusal of a world that is not the group's."""
    d = dryrun_multichip(1, device="cpu")
    assert all(np.isfinite(v) for v in d.values()), d
    with pytest.raises(ValueError, match="2 ranks|has 1 ranks"):
        dryrun_multichip(2, device="cpu")
