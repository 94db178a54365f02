"""Checkpoint/resume in the port: the snapshot manager, its file format
against the JAX package's, and the checkpointed segment loop on every
backend against a straight run and against the JAX package's resume.

A checkpointed run takes the backend a straight run takes, and every
kernel runs the same per-cell step, so f is expected to equal the straight
run's bit for bit (stated tolerance: rtol 1e-6 / atol 1e-8).  av may move
in its last bits where a K-step backend's segment runs a step on the step
kernel that the straight run ran on the K-step kernel (another reduction
order), so av is held within rtol 1e-5.  Against the JAX package (its
``fused`` backend, the port's ``fused``): f within rtol 1e-5 / atol 1e-7,
av within rtol 1e-5.
"""

import dataclasses
import os
import shutil

import numpy as np
import pytest

from advanced_hpc_lbm_tpu.models.d2q9_bgk import Simulation as JaxSimulation
from advanced_hpc_lbm_tpu.params import LBMParams as JaxParams
from advanced_hpc_lbm_tpu.utils.checkpoint import CheckpointManager as JaxManager
from advanced_hpc_lbm_tpu_torch import LBMParams, Simulation, cli
from advanced_hpc_lbm_tpu_torch.models import d2q9_bgk
from advanced_hpc_lbm_tpu_torch.ops import stream_kernel
from advanced_hpc_lbm_tpu_torch.utils import io
from advanced_hpc_lbm_tpu_torch.utils.checkpoint import CheckpointManager

ROOT = os.path.join(os.path.dirname(__file__), "..")
MINI = (os.path.join(ROOT, "decks", "mini_64x64.params"),
        os.path.join(ROOT, "decks", "mini_64x64.obstacles.dat"))


def _deck():
    params = LBMParams(nx=32, ny=16, max_iters=20, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    rng = np.random.RandomState(3)
    mask = np.zeros((16, 32), dtype=bool)
    mask[0] = mask[-1] = True
    mask[5:8, 10:14] = True
    for _ in range(5):
        mask[rng.randint(1, 15), rng.randint(0, 32)] = True
    return params, mask


@pytest.fixture()
def sim():
    return Simulation(*_deck(), backend="fused", device="cpu")


def _same_run(got, want):
    np.testing.assert_allclose(got.f_final, want.f_final, rtol=1e-6, atol=1e-8)
    np.testing.assert_allclose(got.av_vels, want.av_vels, rtol=1e-5)


# ---- the manager (tests/test_checkpoint.py's cases) ---------------------------------

def test_save_load_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    f = np.random.RandomState(0).rand(9, 4, 8).astype(np.float32)
    av = np.float32([1e-5, 2e-5])
    mgr.save(2, f, av)
    step, f2, av2, dens = mgr.latest()
    assert step == 2
    np.testing.assert_array_equal(f2, f)
    np.testing.assert_array_equal(av2, av)
    assert dens is None


def test_save_load_densities(tmp_path):
    mgr = CheckpointManager(tmp_path)
    dens = np.float32([0.4, 0.4, 0.4])
    mgr.save(3, np.zeros((9, 2, 2), np.float32), np.zeros(3, np.float32), densities=dens)
    step, _, _, dens2 = mgr.latest()
    assert step == 3 and mgr.latest_step() == 3
    np.testing.assert_array_equal(dens2, dens)


def test_prune_keeps_newest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, np.zeros((9, 2, 2), np.float32), np.zeros(s, np.float32))
    assert mgr.steps() == [3, 4]
    assert sorted(os.listdir(tmp_path)) == ["step_00000003.npz", "step_00000004.npz"]


def test_empty_dir(tmp_path):
    assert CheckpointManager(tmp_path).latest() is None
    assert CheckpointManager(tmp_path).latest_step() == 0


def test_corrupt_latest_falls_back(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    f = np.arange(9 * 2 * 2, dtype=np.float32).reshape(9, 2, 2)
    mgr.save(2, f, np.zeros(2, np.float32))
    mgr.save(4, f * 2, np.zeros(4, np.float32))
    newest = tmp_path / "step_00000004.npz"
    newest.write_bytes(newest.read_bytes()[:40])
    with pytest.warns(UserWarning, match="unreadable checkpoint"):
        step, f2, _, _ = mgr.latest()
    assert step == 2
    np.testing.assert_array_equal(f2, f)
    with pytest.warns(UserWarning, match="unreadable checkpoint"):
        assert mgr.latest_step() == 2


def test_all_corrupt_returns_none(tmp_path):
    (tmp_path / "step_00000003.npz").write_bytes(b"garbage")
    with pytest.warns(UserWarning):
        assert CheckpointManager(tmp_path).latest() is None


def test_inconsistent_snapshot_is_skipped(tmp_path):
    """A snapshot whose av history is not ``step`` long is unreadable."""
    mgr = CheckpointManager(tmp_path)
    mgr.save(2, np.zeros((9, 2, 2), np.float32), np.zeros(2, np.float32))
    mgr.save(5, np.zeros((9, 2, 2), np.float32), np.zeros(4, np.float32))
    with pytest.warns(UserWarning, match="inconsistent"):
        assert mgr.latest_step() == 2


# ---- one file format for both packages ----------------------------------------------

def test_port_snapshot_reads_in_the_jax_manager(tmp_path):
    f = np.random.RandomState(1).rand(9, 3, 5).astype(np.float32)
    av, dens = np.float32([1.0, 2.0, 3.0]), np.float32([0.5, 0.5, 0.5])
    CheckpointManager(tmp_path).save(3, f, av, densities=dens)
    step, f2, av2, dens2 = JaxManager(tmp_path).latest()
    assert step == 3
    for got, want in ((f2, f), (av2, av), (dens2, dens)):
        np.testing.assert_array_equal(got, want)


def test_jax_snapshot_resumes_like_jax(tmp_path):
    """The JAX package checkpoints 8 of 12 steps; the port and the JAX
    package each resume a copy of that snapshot to 12."""
    params, mask = _deck()
    jparams = JaxParams(**dataclasses.asdict(params))
    jsim = JaxSimulation(jparams, mask, backend="fused")
    jsim.run(n_iters=8, checkpoint_every=4, checkpoint_dir=tmp_path / "jax")
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    assert CheckpointManager(tmp_path / "port").latest_step() == 8
    ref = jsim.run(n_iters=12, checkpoint_every=4, checkpoint_dir=tmp_path / "jax", resume=True)
    port = Simulation(params, mask, backend="fused", device="cpu").run(
        n_iters=12, checkpoint_every=4, checkpoint_dir=tmp_path / "port", resume=True)
    np.testing.assert_allclose(port.f_final, ref.f_final, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(port.av_vels, ref.av_vels, rtol=1e-5)
    assert JaxManager(tmp_path / "port").latest_step() == 12


# ---- the segment loop -----------------------------------------------------------------

@pytest.mark.parametrize("backend,every,kw", [
    ("step", 7, {}),
    ("resident", 7, {}),
    ("pallask", 7, {}),  # K = best_k(16, 32) = 4: every segment has a tail
    ("pallas2", 7, {}),
    ("stream", 10, {}),  # 1 pass and a 2-step tail per segment
    ("fused", 7, {}),
    ("pipeline", 7, {}),
    ("sharded", 7, {"devices": 4}),
    ("sharded", 7, {"devices": 4, "shard_kernel": "pallas"}),
    ("sharded", 10, {"devices": 2, "shard_kernel": "stream"}),
    ("sharded", 7, {"devices": 2, "shard_kernel": "pallas", "ca_steps": 2}),
    ("sharded", 6, {"mesh": (2, 2)}),
    ("sharded", 6, {"mesh": (2, 2), "shard_kernel": "pallas"}),
])
def test_checkpointed_equals_straight(tmp_path, backend, every, kw):
    sim = Simulation(*_deck(), backend=backend, device="cpu")
    straight = sim.run(**kw)
    ck = sim.run(checkpoint_every=every, checkpoint_dir=tmp_path, **kw)
    assert isinstance(ck.f_final, np.ndarray) and ck.av_vels.shape == (20,)
    _same_run(ck, straight)
    last = [s for s in range(every, 20, every)] + [20]
    assert CheckpointManager(tmp_path).steps() == last[-3:]
    step, f, av, dens = CheckpointManager(tmp_path).latest()
    np.testing.assert_array_equal(f, ck.f_final)
    np.testing.assert_array_equal(av, ck.av_vels)
    assert dens is None


def test_resume_continues_exactly(sim, tmp_path):
    sim.run(n_iters=8, checkpoint_every=4, checkpoint_dir=tmp_path)
    assert CheckpointManager(tmp_path).steps()[-1] == 8
    resumed = sim.run(n_iters=12, checkpoint_every=4, checkpoint_dir=tmp_path, resume=True)
    straight = sim.run(n_iters=12)
    np.testing.assert_array_equal(resumed.f_final, straight.f_final)
    np.testing.assert_array_equal(resumed.av_vels, straight.av_vels)


@pytest.mark.parametrize("backend", ["pallask", "stream", "resident"])
def test_resume_continues_on_kernel_backends(tmp_path, backend):
    """A resumed state goes onto the device once and the kernel loops take
    it as their first buffer."""
    sim = Simulation(*_deck(), backend=backend, device="cpu")
    sim.run(n_iters=9, checkpoint_every=9, checkpoint_dir=tmp_path)
    resumed = sim.run(n_iters=20, checkpoint_dir=tmp_path, resume=True)
    _same_run(resumed, sim.run())


def test_resume_without_snapshot_starts_from_rest(sim, tmp_path):
    _same_run(sim.run(n_iters=12, checkpoint_dir=tmp_path, resume=True), sim.run(n_iters=12))
    assert CheckpointManager(tmp_path).steps() == [12]


def test_resume_at_target_runs_nothing(sim, tmp_path):
    first = sim.run(n_iters=8, checkpoint_every=8, checkpoint_dir=tmp_path)
    again = sim.run(n_iters=8, checkpoint_every=8, checkpoint_dir=tmp_path, resume=True)
    np.testing.assert_array_equal(again.f_final, first.f_final)
    np.testing.assert_array_equal(again.av_vels, first.av_vels)


def test_resume_beyond_target_raises(sim, tmp_path):
    sim.run(n_iters=8, checkpoint_every=4, checkpoint_dir=tmp_path)
    with pytest.raises(ValueError, match="beyond"):
        sim.run(n_iters=4, checkpoint_every=4, checkpoint_dir=tmp_path, resume=True)


def test_negative_checkpoint_every_raises(sim, tmp_path):
    with pytest.raises(ValueError, match="checkpoint_every"):
        sim.run(checkpoint_every=-1, checkpoint_dir=tmp_path)


def test_debug_resume_densities_stay_aligned(sim, tmp_path):
    sim.run(n_iters=8, checkpoint_every=4, checkpoint_dir=tmp_path, debug=True)
    resumed = sim.run(n_iters=12, checkpoint_every=4, checkpoint_dir=tmp_path,
                      resume=True, debug=True)
    straight = sim.run(n_iters=12, debug=True)
    assert resumed.densities.shape == resumed.av_vels.shape == (12,)
    np.testing.assert_array_equal(resumed.densities, straight.densities)
    np.testing.assert_array_equal(resumed.av_vels, straight.av_vels)


def test_debug_resume_from_nondebug_snapshot_pads_nan(sim, tmp_path):
    sim.run(n_iters=8, checkpoint_every=4, checkpoint_dir=tmp_path)
    resumed = sim.run(n_iters=12, checkpoint_every=4, checkpoint_dir=tmp_path,
                      resume=True, debug=True)
    straight = sim.run(n_iters=12, debug=True)
    assert resumed.densities.shape == (12,)
    assert np.isnan(resumed.densities[:8]).all()
    np.testing.assert_array_equal(resumed.densities[8:], straight.densities[8:])


def test_check_finite_applies_in_the_run(sim, tmp_path):
    res = sim.run(checkpoint_every=7, checkpoint_dir=tmp_path, check_finite=True, fetch=False)
    assert isinstance(res.f_final, np.ndarray) and not res._check_finite_pending
    assert res.collate() is res


def _card_of(monkeypatch, nbytes):
    monkeypatch.setattr(d2q9_bgk, "_device_memory_bytes", lambda device: nbytes)


def _stream_only_card(n):
    """A card on which the in-place stream tier fits a n x n grid but no
    second state beside it."""
    state = 4 * 9 * n * n
    return int((stream_kernel.tier_bytes(n, n) + 0.3 * state) / d2q9_bgk.FIT_MARGIN)


def test_stream_tail_refused_before_any_segment(monkeypatch, tmp_path):
    """20 steps in segments of 16: the 4-step tail segment needs a second
    state the card cannot hold, so the run fails before the first segment
    and writes no snapshot."""
    _card_of(monkeypatch, _stream_only_card(64))
    params = LBMParams(nx=64, ny=64, max_iters=20, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    sim = Simulation(params, np.zeros((64, 64), dtype=bool), backend="stream", device="cpu")
    with pytest.raises(ValueError, match="n_iters % 8"):
        sim.warmup(checkpoint_every=16, checkpoint_dir=tmp_path)
    with pytest.raises(ValueError, match="n_iters % 8"):
        sim.run(checkpoint_every=16, checkpoint_dir=tmp_path)
    assert CheckpointManager(tmp_path).steps() == []
    res = sim.run(n_iters=16, checkpoint_every=8, checkpoint_dir=tmp_path)
    assert CheckpointManager(tmp_path).steps() == [8, 16]
    assert np.all(np.isfinite(res.f_final))


def test_warmup_with_resume_at_target_does_nothing(monkeypatch, tmp_path):
    sim = Simulation(*_deck(), backend="sharded", device="cpu")
    sim.run(n_iters=8, devices=2, checkpoint_every=8, checkpoint_dir=tmp_path)
    before = dict(sim._runners)

    def refuse(*args, **kwargs):
        raise AssertionError("warmup prepared a run that has nothing left to do")

    monkeypatch.setattr(sim, "_check_single_chip_fit", refuse)
    monkeypatch.setattr(sim, "_run_on_device", refuse)
    sim.warmup(n_iters=8, devices=2, checkpoint_dir=tmp_path, resume=True)
    assert sim._runners == before
    single = Simulation(*_deck(), backend="fused", device="cpu")
    single.run(n_iters=8, checkpoint_every=8, checkpoint_dir=tmp_path / "one")
    monkeypatch.setattr(single, "_check_single_chip_fit", refuse)
    monkeypatch.setattr(single, "_run_on_device", refuse)
    single.warmup(n_iters=8, checkpoint_dir=tmp_path / "one", resume=True)


def test_warmup_resume_skips_corrupt_newest(tmp_path):
    """warmup resolves the resume point as the run will (the newest
    readable snapshot), and builds the runner of each segment length."""
    mgr = CheckpointManager(tmp_path)
    f = np.zeros((9, 16, 32), np.float32)
    mgr.save(2, f, np.zeros(2, np.float32))
    mgr.save(10, f, np.zeros(10, np.float32))
    bad = tmp_path / "step_00000010.npz"
    bad.write_bytes(bad.read_bytes()[:40])
    sim = Simulation(*_deck(), backend="sharded", device="cpu")
    with pytest.warns(UserWarning, match="unreadable checkpoint"):
        sim.warmup(n_iters=12, devices=2, checkpoint_every=6, checkpoint_dir=tmp_path,
                   resume=True)
    # from step 2 to 12 in segments of at most 6: 6 and 4 (from 10: 2)
    assert sorted(key[0] for key in sim._runners) == [4, 6]


# ---- the CLI ---------------------------------------------------------------------------

def _cli(argv, capsys):
    rc = cli.main([str(a) for a in argv])
    out, err = capsys.readouterr()
    return rc, out, err


def _block(out):
    """The ==done== block without its timer values."""
    return [ln.split("\t")[0] if ln.startswith("Elapsed") else ln for ln in out.splitlines()]


def test_cli_checkpoint_and_resume_match_a_straight_run(tmp_path, capsys):
    base = [*MINI, "--device", "cpu", "--backend", "step"]
    rc, straight, _ = _cli([*base, "--iters", "30", "--out-dir", tmp_path], capsys)
    assert rc == 0
    ck = tmp_path / "ck"
    for iters, extra in (("20", []), ("30", ["--resume"])):
        out_dir = tmp_path / f"run{iters}"
        out_dir.mkdir()
        rc, out, err = _cli([*base, "--iters", iters, "--checkpoint-every", "8",
                             "--checkpoint-dir", ck, *extra, "--out-dir", out_dir], capsys)
        assert rc == 0, err
    assert _block(out) == _block(straight)
    assert (out_dir / "final_state.dat").read_bytes() == (tmp_path / "final_state.dat").read_bytes()
    np.testing.assert_allclose(io.read_av_vels(out_dir / "av_vels.dat"),
                               io.read_av_vels(tmp_path / "av_vels.dat"), rtol=1e-5)
    assert CheckpointManager(ck).steps() == [16, 20, 28, 30][-3:]


def test_cli_resume_past_target_exits_1(tmp_path, capsys):
    ck = tmp_path / "ck"
    base = [*MINI, "--device", "cpu", "--backend", "fused", "--checkpoint-dir", ck,
            "--out-dir", tmp_path]
    assert _cli([*base, "--iters", "6", "--checkpoint-every", "6"], capsys)[0] == 0
    (tmp_path / "av_vels.dat").unlink()
    rc, out, err = _cli([*base, "--iters", "4", "--resume"], capsys)
    assert rc == 1 and err.startswith("Error:") and "beyond" in err and out == ""
    assert not (tmp_path / "av_vels.dat").exists()


def test_cli_refused_segment_length_exits_1(monkeypatch, tmp_path, capsys):
    deck = tmp_path / "grid.params"
    deck.write_text("64\n64\n20\n10\n0.1\n0.005\n1.85\n")
    obst = tmp_path / "grid.obstacles.dat"
    obst.write_text("0 0 1\n")
    _card_of(monkeypatch, _stream_only_card(64))
    rc, out, err = _cli([deck, obst, "--device", "cpu", "--backend", "stream",
                         "--checkpoint-every", "16", "--checkpoint-dir", tmp_path / "ck",
                         "--out-dir", tmp_path], capsys)
    assert rc == 1 and err.startswith("Error:") and "n_iters % 8" in err and out == ""
    assert CheckpointManager(tmp_path / "ck").steps() == []


def test_cli_debug_with_checkpoints(tmp_path, capsys):
    rc, out, _ = _cli([*MINI, "--device", "cpu", "--backend", "fused", "--iters", "5",
                       "--debug", "--checkpoint-every", "2", "--checkpoint-dir",
                       tmp_path / "ck", "--out-dir", tmp_path], capsys)
    assert rc == 0
    assert out.count("==timestep:") == out.count("tot density:") == 5
    assert CheckpointManager(tmp_path / "ck").latest()[3].shape == (5,)
