"""The engine's LM program cut at its window solves (``OptProgram``), run
eagerly on the CPU: the segments a CUDA replay runs, with the solve called
between them, against ``opt_program``'s eager code.

The window comes from ``torch_parity.port_problem`` (S=4, L=64, O=512,
depth, sonar and landmark-prior factors; float64). Every output is equal bit
for bit, NaNs included: the segments run the same functions on the same
tensors in the same order. The solve is a Python call on every LM
iteration, ``bound`` times a call whatever the frame's ``n_it``: the
benchmark's tap on ``engine.solve`` and the solve routes' ``launches``
counters rely on it. On the CPU the program runs ``opt_program``'s eager
code and never captures a graph. The CUDA replay itself is held to the
eager program in ``test_torch_cuda.py``.
"""
import pytest
import torch

from svin_tpu_torch.estimator import WindowConfig
from svin_tpu_torch.ops.solve import solve_spd
from svin_tpu_torch.pipeline import OptProgram, opt_program
from svin_tpu_torch.problems import IMU_PARAMS
from svin_tpu_torch.utils import timing
from torch_parity import port_problem

torch.set_num_threads(1)

VICTIM = 1


@pytest.fixture(scope="module")
def problem():
    _, _, _, (w, f, rig) = port_problem(max_iterations=5)
    return w, f, rig


def _flat(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for x in tree for t in _flat(x)]


def _assert_identical(got, want):
    a, b = _flat(got), _flat(want)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True)


class CountingSolve:
    def __init__(self):
        self.calls = 0

    def __call__(self, H, b):
        self.calls += 1
        return solve_spd(H, b)


def _args(w, f, n_it, with_marg):
    return (w, f, n_it, VICTIM) if with_marg else (w, f, n_it)


@pytest.mark.parametrize("bound,n_it", [(5, 5), (5, 2), (3, 3), (3, 1)])
@pytest.mark.parametrize("with_marg", [False, True])
def test_segments_equal_the_eager_program(problem, with_marg, bound, n_it):
    w, f, rig = problem
    cfg = WindowConfig(num_states=4, num_landmarks=64, num_obs=512, max_iterations=bound)
    solve = CountingSolve()
    prog = OptProgram(rig, IMU_PARAMS, cfg, with_marg, solve=solve)
    want = opt_program(rig, IMU_PARAMS, cfg, with_marg)(*_args(w, f, n_it, with_marg))
    got = prog.segmented(w, f, n_it, VICTIM if with_marg else None)
    assert solve.calls == bound
    _assert_identical(got, want)
    assert int(got[3 if with_marg else 2]) <= n_it


@pytest.mark.parametrize("with_marg", [False, True])
def test_cpu_call_runs_the_eager_program_and_captures_nothing(problem, with_marg):
    w, f, rig = problem
    cfg = WindowConfig(num_states=4, num_landmarks=64, num_obs=512, max_iterations=4)
    solve = CountingSolve()
    prog = OptProgram(rig, IMU_PARAMS, cfg, with_marg, solve=solve)
    want = opt_program(rig, IMU_PARAMS, cfg, with_marg)(*_args(w, f, 4, with_marg))
    before = timing.counters()
    for _ in range(3):
        _assert_identical(prog(*_args(w, f, 4, with_marg)), want)
    after = timing.counters()
    assert solve.calls == 3 * 4
    for name in ("opt.graph_replay", "opt.graph_capture"):
        assert after.get(name, 0) == before.get(name, 0)
