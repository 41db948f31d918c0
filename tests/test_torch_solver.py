"""The port's placement solve against the JAX package's three arms, on the CPU.

training_operator_tpu_torch/scheduler/packer.py's `solve_batch` (torch, here
on CPU tensors), `TorchSolver` (padded, candidates cached per generation)
and `solve_batch_numpy` must return exactly the placements of JAX
`_solve_batch` (the XLA-jit arm), `_solve_batch_numpy` and
`_solve_batch_python`: the algorithm is integer arithmetic, so equality is
exact, and -1 marks an item not admitted.

- the 16 seeds of TestKernelEquivalence (all three JAX arms);
- 50 larger random instances (up to 16 slices of 8 hosts, 4 classes, 64
  candidates, 96 items) against the numpy and python arms only (each new
  shape would cost the jit arm a compile);
- TestSolveBatch's hand-built cases (identical gangs, cross-class priority,
  padding rows, the rank clamp, an empty pool) against the jit arm;
- the solver bench's 10k-node block against the numpy arm.
"""

import numpy as np
import pytest
import torch

import test_solve_batch as jax_cases
from training_operator_tpu.scheduler.packer import (
    _solve_batch,
    _solve_batch_numpy,
    _solve_batch_python,
)
from training_operator_tpu_torch.scheduler import packer

DTYPES = (bool, bool, np.int32, bool, np.int32, np.int32, bool)


def typed(args):
    return tuple(np.asarray(a, dtype=dt) for a, dt in zip(args, DTYPES))


def port(args):
    chosen, rounds = packer.solve_batch(*(torch.from_numpy(a) for a in typed(args)))
    assert chosen.dtype == torch.int32 and rounds >= 1
    return chosen.numpy()


def solver(args, generation=None, solver_=None):
    a = typed(args)
    s = solver_ or packer.TorchSolver("cpu")
    return s.solve(a[0], a[1:5], a[5], a[6], generation=generation)


def kernel_equivalence_args(seed):
    args = list(jax_cases.TestKernelEquivalence._args(np.random.default_rng(1000 + seed)))
    args[3] = args[3] & args[1].any(axis=-1)  # as test_three_kernels_identical
    return typed(args)


def larger_args(seed):
    rng = np.random.default_rng(5000 + seed)
    s, h = int(rng.integers(1, 17)), 8
    k, c, g = int(rng.integers(1, 5)), int(rng.integers(1, 65)), int(rng.integers(1, 97))
    cand_mask = rng.random((k, c, h)) < 0.3
    return typed((
        rng.random((s, h)) < 0.75,
        cand_mask,
        rng.integers(0, s, size=(k, c)),
        (rng.random((k, c)) < 0.9) & cand_mask.any(axis=-1),
        rng.integers(0, h, size=(k, c)),
        rng.integers(0, k, size=g),
        rng.random(g) < 0.9,
    ))


@pytest.mark.parametrize("seed", range(16))
def test_equals_the_three_jax_arms(seed):
    args = kernel_equivalence_args(seed)
    want = np.asarray(_solve_batch(*args))
    np.testing.assert_array_equal(_solve_batch_numpy(*args), want)
    np.testing.assert_array_equal(_solve_batch_python(*args), want)
    np.testing.assert_array_equal(port(args), want)
    np.testing.assert_array_equal(solver(args), want)
    np.testing.assert_array_equal(packer.solve_batch_numpy(*args), want)


@pytest.mark.parametrize("seed", range(50))
def test_larger_instances_equal_numpy_and_python_arms(seed):
    args = larger_args(seed)
    want = _solve_batch_numpy(*args)
    np.testing.assert_array_equal(_solve_batch_python(*args), want)
    np.testing.assert_array_equal(port(args), want)
    np.testing.assert_array_equal(solver(args), want)
    np.testing.assert_array_equal(packer.solve_batch_numpy(*args), want)


def _one_slice(h, hosts_of_candidates, origin=None):
    cand_mask = np.stack([[jax_cases.host_mask(h, hs) for hs in hosts_of_candidates]])
    c = cand_mask.shape[1]
    return (np.ones((1, h), dtype=bool), cand_mask, np.zeros((1, c)), np.ones((1, c), dtype=bool),
            np.arange(c)[None, :] if origin is None else origin)


def _hand_built():
    """TestSolveBatch's cases as (name, args, expected or None)."""
    cases = []
    free, cm, cs, cv, orr = _one_slice(4, [[i] for i in range(4)])
    cases.append(("identical_gang_desync", (free, cm, cs, cv, orr, np.zeros(4), np.ones(4)),
                  None))
    cm = np.zeros((2, 1, 2), dtype=bool)
    cm[0, 0] = jax_cases.host_mask(2, [0, 1])
    cm[1, 0] = jax_cases.host_mask(2, [0])
    cross = (np.ones((1, 2)), cm, np.zeros((2, 1)), np.ones((2, 1)), np.zeros((2, 1)))
    cases.append(("cross_class_priority", cross + ([0, 1], np.ones(2)), [0, -1]))
    cases.append(("cross_class_priority_reversed", cross + ([1, 0], np.ones(2)), [0, -1]))
    free, cm, cs, cv, _ = _one_slice(2, [[0], [1]])
    cases.append(("padding_rows_ignored",
                  (free, cm, cs, cv, np.array([[0, 1]]), np.zeros(4),
                   [True, False, True, False]), None))
    free, cm, cs, cv, _ = _one_slice(2, [[0]])
    cases.append(("rank_clamp", (free, cm, cs, cv, np.zeros((1, 1)), np.zeros(5), np.ones(5)),
                  [0, -1, -1, -1, -1]))
    cases.append(("empty_free", (np.zeros((2, 4)), np.ones((1, 2, 4)), [[0, 1]],
                                 np.ones((1, 2)), np.zeros((1, 2)), np.zeros(3), np.ones(3)),
                  [-1, -1, -1]))
    return cases


@pytest.mark.parametrize("name,args,expected", _hand_built(),
                         ids=[case[0] for case in _hand_built()])
def test_hand_built_cases(name, args, expected):
    args = typed(args)
    want = np.asarray(_solve_batch(*args))
    if expected is not None:
        np.testing.assert_array_equal(want, expected)
    np.testing.assert_array_equal(port(args), want)
    np.testing.assert_array_equal(solver(args), want)
    if name == "identical_gang_desync":  # all four admitted in one round
        chosen, rounds = packer.solve_batch(*(torch.from_numpy(a) for a in args))
        assert sorted(chosen.tolist()) == [0, 1, 2, 3] and rounds == 2
    if name == "padding_rows_ignored":
        assert want[1] == -1 and want[3] == -1 and want[0] != want[2] >= 0


def test_padded_solve_equals_unpadded_and_caches_candidates():
    s = packer.TorchSolver("cpu")
    s.prewarm(slices=16, hosts=8, items=128, cands=128, classes=8)
    assert s.last_stats["padded"] == (128, 8, 128)
    for seed in range(6):
        args = larger_args(seed)
        want = np.asarray(packer.solve_batch(*(torch.from_numpy(a) for a in args))[0])
        np.testing.assert_array_equal(solver(args, generation=seed, solver_=s), want)
        cached = s._cands
        np.testing.assert_array_equal(solver(args, generation=seed, solver_=s), want)
        assert s._cands is cached  # the same generation reuses the resident tensors
        assert s.last_stats["padded"] == (128, 8, 128)
        assert s.last_stats["items"] == len(args[5])


def test_high_water_marks_only_grow():
    s = packer.TorchSolver("cpu")
    solver(larger_args(3), solver_=s)
    big = s.last_stats["padded"]
    args = kernel_equivalence_args(0)
    np.testing.assert_array_equal(solver(args, solver_=s), np.asarray(_solve_batch(*args)))
    assert s.last_stats["padded"] == big


def test_refuses_hosts_past_the_score_packing():
    s = packer.TorchSolver("cpu")
    free = np.ones((1, 513), dtype=bool)
    cands = (np.ones((1, 1, 513), dtype=bool), np.zeros((1, 1), np.int32),
             np.ones((1, 1), dtype=bool), np.zeros((1, 1), np.int32))
    with pytest.raises(ValueError, match="score packing"):
        s.solve(free, cands, np.zeros(1, np.int32))


def test_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        packer.TorchSolver()


def test_scale_instance_shape():
    free, cand_mask, cand_slice, cand_valid, origin_rank, item_class, active = (
        packer.scale_instance())
    assert free.shape == (2500, 4) and free.all()
    assert cand_mask.shape == (3, 10000, 4)
    assert cand_valid.sum(axis=1).tolist() == [10000, 7500, 2500]
    assert (cand_mask.sum(axis=-1)[cand_valid] == np.repeat([1, 2, 4], [10000, 7500, 2500])).all()
    assert item_class.shape == (2000,) and active.all()
    assert cand_slice[1, :6].tolist() == [0, 0, 0, 1, 1, 1]
    assert origin_rank[1, :6].tolist() == [0, 1, 2, 0, 1, 2]


def test_10k_node_instance_equals_the_jax_numpy_arm():
    inst = packer.scale_instance()
    want = _solve_batch_numpy(*inst)
    assert (want >= 0).all()  # the fleet fits every gang
    np.testing.assert_array_equal(packer.solve_batch_numpy(*inst), want)
    s = packer.TorchSolver("cpu")
    np.testing.assert_array_equal(s.solve(inst[0], inst[1:5], inst[5], inst[6], generation=0),
                                  want)
    assert s.last_stats["padded"] == (2048, 4, 16384) and s.last_stats["rounds"] >= 2
