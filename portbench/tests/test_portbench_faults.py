"""``correct`` comes out false when the timed path is broken underneath,
and for the control: the run skips its look for a card and drives the
mini cell on the CPU, where the program runs its kernels' plain versions
(``auto`` is ``pallask`` off CUDA)."""

from __future__ import annotations

import time

import numpy as np
import torch

from conftest import MINI_LIMITS, REPO
from portbench import harness, inputs, judge
from portbench.reference import lbm

from advanced_hpc_lbm_tpu_torch.models import d2q9_bgk
from advanced_hpc_lbm_tpu_torch.ops import kstep_kernel
from advanced_hpc_lbm_tpu_torch.utils import io as lbm_io


def _run(tree):
    cell = harness.load_cell("mini.deck", tree)
    return harness.run_cell(cell, seed=2**31 + 99, seconds=0.3, traced=False, device="cpu",
                            t_process=time.perf_counter(), log=lambda m: None)


def _wrap_pass(monkeypatch, after):
    original = kstep_kernel.plain_multi_step

    def broken(f, mask, params, k, *, out, partials):
        original(f, mask, params, k, out=out, partials=partials)
        after(f, out, partials)
    monkeypatch.setattr(kstep_kernel, "plain_multi_step", broken)


def test_sound_run_is_correct(tree):
    assert _run(tree)["correct"] is True


def test_state_returned_unchanged(tree, monkeypatch):
    _wrap_pass(monkeypatch, lambda f, out, partials: out.copy_(f))
    out = _run(tree)
    assert out["correct"] is False and out["failed"] == out["attempted"]


def test_half_the_cells_left_out_of_the_mean(tree, monkeypatch):
    def half(f, out, partials):
        partials[:, 1::2] = 0
        partials *= 2
    _wrap_pass(monkeypatch, half)
    out = _run(tree)
    assert out["correct"] is False
    assert out["checks"]["av_vels_pct"]["value"] > MINI_LIMITS["av_vels_pct"]


def test_answer_altered_where_produced(tree, monkeypatch):
    original = d2q9_bgk.Simulation._run_on_device

    def altered(self, iters, debug, f0=None):
        f, *rest = original(self, iters, debug, f0)
        f[1, 32, 32] *= 1.01  # one value of the final state
        return (f, *rest)
    monkeypatch.setattr(d2q9_bgk.Simulation, "_run_on_device", altered)
    assert _run(tree)["correct"] is False


def test_written_value_altered(tree, monkeypatch):
    original = lbm_io.write_av_vels

    def altered(path, av):
        av = np.array(av, dtype=np.float64)
        av[len(av) // 2] *= 1.01
        original(path, av)
    monkeypatch.setattr(lbm_io, "write_av_vels", altered)
    out = _run(tree)
    assert out["correct"] is False
    assert out["checks"]["av_vels_pct"]["value"] > MINI_LIMITS["av_vels_pct"]


def test_tf32_control_is_not_correct():
    deck = lbm.read_deck(REPO / "decks" / "mini_64x64.params",
                         REPO / "decks" / "mini_64x64.obstacles.dat")
    for seed in (1, 2, 3):
        f0 = inputs.initial_state(deck, seed, "cpu")
        f_ref, av_ref = lbm.Reference(deck, "cpu").run(f0)
        expected = judge.Expected(deck, f_ref.numpy(), av_ref.numpy())
        f_c, av_c = lbm.Reference(deck, "cpu", tf32=True).run(f0)
        numbers = expected.state_numbers(f_c.numpy(), av_c.numpy(),
                                         lbm.reynolds(deck, av_c.numpy()[-1]))
        assert not judge.verdict(numbers, MINI_LIMITS)
        # every number but the layout misses its limit at this size
        assert all(numbers[k] > MINI_LIMITS[k] for k in MINI_LIMITS if k != "layout_errors")
        assert torch.isfinite(f_c).all()
