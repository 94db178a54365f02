"""The plain reference against the mini deck's golden av history, by the
reference checker's 1% rule (``judge.checker_pct`` is a copy of it)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import REPO
from portbench import inputs, judge
from portbench.reference import lbm


def _mini():
    return lbm.read_deck(REPO / "decks" / "mini_64x64.params",
                         REPO / "decks" / "mini_64x64.obstacles.dat")


def test_checker_rule_is_the_reference_checkers():
    ref = np.array([1.0, 2.0, 4.0])
    sim = np.array([1.0, 2.02, 3.96])
    # 100 * diff / (ref - diff) = 100 * (ref - sim) / sim
    assert judge.checker_pct(ref, sim) == pytest.approx(100 * 0.04 / 3.96)
    assert judge.checker_pct(ref, np.array([1.0, np.nan, 4.0])) == float("inf")


def test_reference_meets_the_golden():
    deck = _mini()
    f0 = torch.from_numpy(lbm.rest_state(deck))[:, None, None].expand(9, 64, 64).contiguous()
    f, av = lbm.Reference(deck, "cpu").run(f0)
    golden = np.loadtxt(REPO / "decks" / "mini_64x64.golden_av_vels.dat", usecols=[1])
    assert judge.checker_pct(golden, av.numpy()) < 0.01  # measured 0.0029
    assert f.dtype == torch.float64
    # float64 conserves the mass to rounding (the deck starts at 0.1 a cell)
    assert float(f.sum()) == pytest.approx(float(f0.double().sum()), rel=1e-12)


def test_tf32_control_misses_the_golden():
    deck = _mini()
    f0 = torch.from_numpy(lbm.rest_state(deck))[:, None, None].expand(9, 64, 64).contiguous()
    _, av = lbm.Reference(deck, "cpu", tf32=True).run(f0)
    golden = np.loadtxt(REPO / "decks" / "mini_64x64.golden_av_vels.dat", usecols=[1])
    assert judge.checker_pct(golden, av.numpy()) > 1.0  # measured 8.0


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 3 * 2**-11, 1.0 + 2**-12, -1.0 - 2**-10])
    got = lbm._tf32(x)
    # ties go to even: 1 + 2^-11 -> 1, 1 + 3 * 2^-11 -> 1 + 2^-9
    assert got.tolist() == [1.0, 1.0, 1.0 + 2**-9, 1.0, -1.0 - 2**-10]


def test_seeded_initial_state():
    deck = _mini()
    a = inputs.initial_state(deck, 2**31 + 5, "cpu")
    b = inputs.initial_state(deck, 2**31 + 5, "cpu")
    c = inputs.initial_state(deck, 2**31 + 6, "cpu")
    assert torch.equal(a, b) and not torch.equal(a, c)
    rest = torch.from_numpy(lbm.rest_state(deck))[:, None, None]
    # each cell keeps its density; no value moves by more than 1e-3 of it
    assert torch.allclose(a.sum(0), rest.sum(0).expand(64, 64), rtol=0, atol=1e-7)
    assert float((a - rest).abs().max()) <= 1e-3 * deck.density
    assert bool((a > 0).all())
    assert inputs.initial_state(deck, -3, "cpu").shape == (9, 64, 64)


def test_graph_free_steps_agree_with_a_plain_loop():
    # the reference's run and its step, called by hand, give the same bits
    deck = _mini()
    f0 = inputs.initial_state(deck, 7, "cpu")
    ref = lbm.Reference(deck, "cpu")
    f, av = ref.run(f0, n_iters=10)
    a = f0.double()
    b = torch.empty_like(a)
    for t in range(10):
        assert float(ref.step(a, b)) == float(av[t])
        a, b = b, a
    assert torch.equal(a, f)
