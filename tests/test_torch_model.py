"""The slice as a whole on the CPU: the port's Simulation and CLI against
the JAX package's on the same decks.

The port's ``auto`` backend runs ``pallask``, whose plain version on the
CPU (ghosted windows of the lean window step) reduces ||u|| over the
pre-collision moments as the kernels do; JAX's ``fused`` backend reduces
over the post-collision
moments, so av agrees within rtol 5e-4 over a from-rest run, as
tests/test_resident.py holds the JAX kernels to it, and f within rtol 1e-5.
The port's ``fused`` and ``pipeline`` backends are held to JAX's backends of
the same names; its kernel backends (``step``/``pallas``, ``resident``,
``pallask``, ``pallas2``) to JAX's ``fused`` and to each other.
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from advanced_hpc_lbm_tpu.models.d2q9_bgk import Simulation as JaxSimulation
from advanced_hpc_lbm_tpu.models.d2q9_bgk import SimulationResult as JaxResult
from advanced_hpc_lbm_tpu.params import LBMParams as JaxParams
from advanced_hpc_lbm_tpu.utils import io as jio
from advanced_hpc_lbm_tpu.utils import native as jnative
from advanced_hpc_lbm_tpu_torch import LBMParams, Simulation, SimulationResult, cli
from advanced_hpc_lbm_tpu_torch.models import d2q9_bgk
from advanced_hpc_lbm_tpu_torch.ops import kstep_kernel, resident, step_kernel, stream_kernel
from advanced_hpc_lbm_tpu_torch.parallel import halo, mesh
from advanced_hpc_lbm_tpu_torch.utils import check, io

ROOT = os.path.join(os.path.dirname(__file__), "..")
DECKS = os.path.join(ROOT, "decks")
MINI = (os.path.join(DECKS, "mini_64x64.params"),
        os.path.join(DECKS, "mini_64x64.obstacles.dat"))
MINI_GOLDEN = os.path.join(DECKS, "mini_64x64.golden_av_vels.dat")


@pytest.fixture(scope="module")
def mini_runs():
    port = Simulation.from_decks(*MINI, backend="auto", device="cpu").run()
    ref = JaxSimulation.from_decks(*MINI, backend="fused").run()
    return port, ref


def test_mini_deck_auto_matches_jax_fused(mini_runs):
    port, ref = mini_runs
    assert port.f_final.shape == (9, 64, 64) and port.av_vels.shape == (500,)
    assert isinstance(port.f_final, np.ndarray)  # run() fetched by default
    np.testing.assert_allclose(port.f_final, ref.f_final, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(port.av_vels, ref.av_vels, rtol=5e-4)


def test_mini_deck_passes_golden(mini_runs, tmp_path):
    port, _ = mini_runs
    io.write_av_vels(tmp_path / "av_vels.dat", port.av_vels)
    stats = check.check_av_vels_only(MINI_GOLDEN, str(tmp_path / "av_vels.dat"))
    assert stats.passed(1.0)


def _small_deck():
    params = LBMParams(nx=32, ny=16, max_iters=12, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    rng = np.random.RandomState(0)
    mask = np.zeros((16, 32), dtype=bool)
    mask[0] = mask[-1] = mask[:, 0] = True
    mask[5:8, 10:14] = True
    for _ in range(5):
        mask[rng.randint(1, 13), rng.randint(1, 31)] = True
    return params, mask


def _jax_params(p):
    return JaxParams(**dataclasses.asdict(p))


@pytest.mark.parametrize("backend", ["fused", "pipeline"])
def test_plain_backends_match_jax(backend):
    params, mask = _small_deck()
    port = Simulation(params, mask, backend=backend, device="cpu").run()
    ref = JaxSimulation(_jax_params(params), mask, backend=backend).run()
    np.testing.assert_allclose(port.f_final, ref.f_final, rtol=1e-5, atol=1e-7)
    # whole-grid sums in another order, on the small velocities of a run
    # from rest: the trajectory tolerance of tests/test_pallas.py
    np.testing.assert_allclose(port.av_vels, ref.av_vels, rtol=1e-4)


@pytest.mark.parametrize("backend", ["auto", "step", "pallas", "resident", "pallask",
                                     "pallas2", "fused", "pipeline"])
def test_backends_resolve(backend):
    params, mask = _small_deck()
    sim = Simulation(params, mask, backend=backend, device="cpu")
    want = {"auto": d2q9_bgk.AUTO_BACKEND, "pallas": "step"}.get(backend, backend)
    assert sim.backend == want


def test_pallas_backend_runs_the_step_kernel(tmp_path, capsys):
    """``pallas`` is the JAX package's name for the per-step kernel: the
    port runs its step kernel for it, from the library and the CLI."""
    params, mask = _small_deck()
    port = Simulation(params, mask, backend="pallas", device="cpu").run()
    step = Simulation(params, mask, backend="step", device="cpu").run()
    np.testing.assert_array_equal(port.f_final, step.f_final)
    np.testing.assert_array_equal(port.av_vels, step.av_vels)
    rc, _, err = run_cli([*MINI, "--device", "cpu", "--backend", "pallas", "--iters", "20",
                          "--out-dir", tmp_path], capsys)
    assert rc == 0, err


@pytest.mark.parametrize("backend", d2q9_bgk.WHOLE_RUN)
def test_whole_run_backends_match_jax_fused(backend):
    params, mask = _small_deck()
    port = Simulation(params, mask, backend=backend, device="cpu").run()
    ref = JaxSimulation(_jax_params(params), mask, backend="fused").run()
    np.testing.assert_allclose(port.f_final, ref.f_final, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(port.av_vels, ref.av_vels, rtol=1e-4)
    # and the kernels' own state equals the step kernel's bit for bit
    step = Simulation(params, mask, backend="step", device="cpu").run()
    np.testing.assert_array_equal(port.f_final, step.f_final)


@pytest.mark.parametrize("backend", d2q9_bgk.WHOLE_RUN)
def test_whole_run_backends_pass_mini_golden(backend, tmp_path):
    port = Simulation.from_decks(*MINI, backend=backend, device="cpu").run()
    io.write_av_vels(tmp_path / "av_vels.dat", port.av_vels)
    stats = check.check_av_vels_only(MINI_GOLDEN, str(tmp_path / "av_vels.dat"))
    assert stats.passed(1.0)


@pytest.mark.parametrize("backend", d2q9_bgk.WHOLE_RUN)
def test_debug_on_whole_run_backend_collects_densities(backend):
    """--debug needs per-step densities: the whole-run backends run the
    step kernel's loop for it, as JAX falls back to ``fused``."""
    params, mask = _small_deck()
    sim = Simulation(params, mask, backend=backend, device="cpu")
    res = sim.run(n_iters=5, debug=True)
    plain = sim.run(n_iters=5)
    assert res.densities.shape == (5,)
    np.testing.assert_allclose(res.densities, res.densities[0], rtol=1e-5)
    np.testing.assert_array_equal(res.f_final, plain.f_final)


@pytest.mark.parametrize("ny,nx", [(17, 23), (128, 128), (128, 256), (1024, 1024),
                                   (4096, 4096), (4096, 8192)])
def test_auto_rule(ny, nx):
    """Off CUDA, where no banded resident form runs, auto runs the K-step
    kernel on every grid, at best_k's K."""
    params = LBMParams(nx=nx, ny=ny, max_iters=1, reynolds_dim=10,
                       density=0.1, accel=0.005, omega=1.85)
    sim = Simulation(params, np.zeros((ny, nx), dtype=bool), device="cpu")
    assert sim.backend == "pallask"
    assert sim._k() == (4 if ny * nx <= 256 * 256 else 3 if ny * nx <= 8192 * 8192 else 4)


def test_auto_takes_the_banded_resident_form(monkeypatch):
    """Where the resident kernel's banded form takes the grid on the run's
    device, auto runs resident; elsewhere pallask."""
    params, mask = _small_deck()
    seen = []

    def takes(ny, nx, device):
        seen.append((ny, nx, torch.device(device)))
        return taken
    monkeypatch.setattr(resident, "takes_banded", takes)
    taken = True
    assert Simulation(params, mask, device="cpu").backend == "resident"
    taken = False
    assert Simulation(params, mask, device="cpu").backend == "pallask"
    assert seen == [(params.ny, params.nx, torch.device("cpu"))] * 2


@pytest.mark.parametrize("backend", ["sharded"])
def test_unported_backend_raises(backend):
    """Every backend of the JAX package is ported, the overlapped 1-step
    schedule of ``sharded`` too: what raises is what the JAX package
    refuses (the overlap on another shard kernel than jnp)."""
    params, mask = _small_deck()
    assert backend in d2q9_bgk.BACKENDS
    Simulation(params, mask, backend=backend, device="cpu")
    ring = mesh.make_y_mesh(2, ["cpu"] * 2)
    assert halo.make_sharded_runner(ring, params, 1, overlap=True).overlap
    with pytest.raises(ValueError, match="1-step jnp"):
        halo.make_sharded_runner(ring, params, 1, kernel="pallas", overlap=True)


def test_unknown_backend_and_bad_mask_raise():
    params, mask = _small_deck()
    with pytest.raises(ValueError, match="unknown backend"):
        Simulation(params, mask, backend="nope", device="cpu")
    with pytest.raises(ValueError, match="obstacle mask"):
        Simulation(params, mask[:-1], device="cpu")


@pytest.mark.parametrize("name", d2q9_bgk.BACKENDS)
def test_every_backend_resolves_to_one_table_entry(name):
    """Every backend name is an entry of the model's table, an alias (auto,
    pallas) or the sharded path; under ``debug`` a whole-run backend runs
    the step kernel's entry, every other entry its own."""
    params, mask = _small_deck()
    sim = Simulation(params, mask, backend=name, device="cpu")
    table = d2q9_bgk.BACKEND_TABLE
    if name in ("auto", "pallas", "sharded"):
        assert name not in table
        assert sim.backend == {"auto": "pallask", "pallas": "step"}.get(name, name)
    else:
        assert sim.backend == name and name in table
    if sim.backend == "sharded":
        return
    whole = sim.backend in ("resident", "pallask", "pallas2", "stream")
    assert (sim.backend in d2q9_bgk.WHOLE_RUN) is whole
    assert sim._runs(False) == sim.backend
    assert sim._runs(True) == ("step" if whole else sim.backend)


def test_run_without_fetch_then_collate():
    params, mask = _small_deck()
    sim = Simulation(params, mask, device="cpu")
    sim.warmup()
    res = sim.run(n_iters=5, fetch=False, debug=True)
    assert isinstance(res.f_final, torch.Tensor) and isinstance(res.av_vels, torch.Tensor)
    assert res.collate() is res
    assert isinstance(res.f_final, np.ndarray) and res.av_vels.shape == (5,)
    np.testing.assert_allclose(res.densities, res.densities[0], rtol=1e-5)
    assert res.collate().av_vels.shape == (5,)  # idempotent


def test_reynolds_and_write_match_jax(tmp_path, monkeypatch):
    """From the same host arrays, both packages print the same Reynolds
    number and write the same bytes."""
    monkeypatch.setattr(jnative, "available", lambda: False)
    params, mask = _small_deck()
    res = Simulation(params, mask, device="cpu").run(n_iters=4)
    jres = JaxResult(params=_jax_params(params), f_final=res.f_final, av_vels=res.av_vels)
    jres._obstacles_cache = mask
    assert f"{res.reynolds:.12E}" == f"{jres.reynolds:.12E}"
    (tmp_path / "port").mkdir()
    (tmp_path / "jax").mkdir()
    res.write(tmp_path / "port")
    jres.write(tmp_path / "jax")
    for name in ("final_state.dat", "av_vels.dat"):
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()


def test_check_finite_gates_nan():
    params, mask = _small_deck()
    bad = SimulationResult(params=params, f_final=torch.full((9, 16, 32), float("nan")),
                           av_vels=torch.zeros(3))
    bad._obstacles_cache = mask
    bad._check_finite_pending = True
    with pytest.raises(FloatingPointError, match="final state"):
        bad.collate()
    bad = SimulationResult(params=params, f_final=np.ones((9, 16, 32), np.float32),
                           av_vels=np.array([0.1, np.inf], np.float32))
    with pytest.raises(FloatingPointError, match="step 1"):
        Simulation._assert_finite(bad)


# ---- CLI -------------------------------------------------------------------

def run_cli(args, capsys):
    rc = cli.main([str(a) for a in args])
    captured = capsys.readouterr()
    return rc, captured.out, captured.err


def test_cli_mini_deck_on_cpu(tmp_path, capsys):
    rc, out, _ = run_cli([*MINI, "--device", "cpu", "--out-dir", tmp_path], capsys)
    assert rc == 0
    lines = out.splitlines()
    assert lines[0] == "==done=="
    assert lines[1].startswith("Reynolds number:\t\t")
    assert np.isfinite(float(lines[1].split("\t")[-1]))
    for i, phase in enumerate(["Init", "Compute", "Collate", "Total"]):
        assert lines[2 + i].startswith(f"Elapsed {phase} time:")
        assert lines[2 + i].endswith("(s)")
    assert (tmp_path / "final_state.dat").exists()
    stats = check.check_av_vels_only(MINI_GOLDEN, str(tmp_path / "av_vels.dat"))
    assert stats.passed(1.0)


def test_cli_debug_stream(tmp_path, capsys):
    rc, out, _ = run_cli([*MINI, "--device", "cpu", "--debug", "--iters", "3",
                          "--check-finite", "--backend", "fused", "--out-dir", tmp_path],
                         capsys)
    assert rc == 0
    assert out.count("==timestep:") == out.count("tot density:") == 3
    dens = [float(ln.split()[-1]) for ln in out.splitlines() if "tot density" in ln]
    np.testing.assert_allclose(dens, dens[0], rtol=1e-5)
    assert jio.read_av_vels(tmp_path / "av_vels.dat").shape == (3,)


def test_cli_cuda_without_a_card_exits_1(tmp_path, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, out, err = run_cli([*MINI, "--device", "cuda", "--out-dir", tmp_path], capsys)
    assert rc == 1 and "CUDA" in err and out == ""
    assert not (tmp_path / "av_vels.dat").exists()


@pytest.mark.parametrize("extra,message", [
    (["--backend", "sharded", "--devices", "3"], "not divisible"),
    (["--device", "tpu0"], "bad --device"),
])
def test_cli_bad_choice_exits_1(tmp_path, capsys, extra, message):
    rc, _, err = run_cli([*MINI, "--device", "cpu", *extra, "--out-dir", tmp_path], capsys)
    assert rc == 1 and message in err


def test_cli_unknown_backend_exits_2(tmp_path, capsys):
    """An unknown --backend is refused by argparse with the usage line and
    exit code 2, as the reference's CLI does."""
    with pytest.raises(SystemExit) as e:
        cli.main([*MINI, "--device", "cpu", "--backend", "nope", "--out-dir", str(tmp_path)])
    assert e.value.code == 2
    err = capsys.readouterr().err
    assert "usage:" in err and "invalid choice: 'nope'" in err
    assert not (tmp_path / "av_vels.dat").exists()


def test_cli_bad_deck_exits_1(tmp_path, capsys):
    bad = tmp_path / "bad.params"
    bad.write_text("not a number\n")
    rc, _, err = run_cli([bad, MINI[1], "--device", "cpu"], capsys)
    assert rc == 1 and err.startswith("Error:")


def test_cli_negative_iters_exits_1_without_a_traceback(tmp_path):
    """A negative --iters is refused as the deck's maxIters is, with exit
    code 1 and no traceback (the JAX CLI crashes there instead)."""
    res = subprocess.run([sys.executable, "-m", "advanced_hpc_lbm_tpu_torch", *MINI,
                          "--device", "cpu", "--iters", "-3", "--out-dir", str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode == 1, res.stdout + res.stderr
    assert "Error: max_iters must be >= 0, got -3" in res.stderr.splitlines()
    assert "Traceback" not in res.stdout + res.stderr
    assert res.stdout == "" and not (tmp_path / "av_vels.dat").exists()


@pytest.mark.parametrize("method", ["run", "warmup"])
@pytest.mark.parametrize("backend,kw", [("auto", {}), ("sharded", {"devices": 2})])
def test_negative_iters_raise_before_allocating(monkeypatch, method, backend, kw):
    sim = Simulation(*_small_deck(), backend=backend, device="cpu")

    def refuse(*args, **kwargs):
        raise AssertionError("a state was allocated")
    monkeypatch.setattr(sim, "initial_state", refuse)
    monkeypatch.setattr(halo._Windows, "__init__", refuse)
    with pytest.raises(ValueError, match=r"^max_iters must be >= 0, got -1$"):
        getattr(sim, method)(n_iters=-1, **kw)


@pytest.mark.parametrize("flag", [
    # every flag is ported: malformed values of them are refused
    # (tests/test_torch_multihost.py runs --multihost itself)
    ["--devices", "two"], ["--mesh", "2by2"], ["--shard-kernel", "cuda"], ["--ca-steps", "x"],
    ["--checkpoint-every", "x"], ["--resume", "--checkpoint-every", "x"], ["--multihost=yes"],
    ["--profile"], ["--iters", "x"],
])
def test_cli_rejects_unported_flags(flag, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main([*MINI, *flag])
    assert e.value.code == 2


def test_import_leaves_jax_out():
    code = (
        "import sys, importlib, pkgutil, advanced_hpc_lbm_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'advanced_hpc_lbm_tpu.'))"
        " or m == 'advanced_hpc_lbm_tpu']\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def test_no_jax_import_in_sources():
    pkg = os.path.join(ROOT, "advanced_hpc_lbm_tpu_torch")
    for dirpath, _, files in os.walk(pkg):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(dirpath, name)) as fh:
                    for line in fh:
                        stripped = line.strip()
                        if stripped.startswith(("import ", "from ")):
                            mod = stripped.split()[1]
                            assert mod.split(".")[0] not in ("jax", "advanced_hpc_lbm_tpu"), (
                                f"{name}: {stripped}")


def test_launch_counter_is_a_plain_int():
    for module in (step_kernel, resident, kstep_kernel, stream_kernel):
        assert isinstance(module.launches, int)
    assert isinstance(resident.banded_launches, int)
    assert isinstance(stream_kernel.snapshot_launches, int)


# ---- the stream backend and the device-memory gate ---------------------------

def test_cli_stream_backend_passes_mini_golden(tmp_path, capsys):
    rc, out, err = run_cli([*MINI, "--device", "cpu", "--backend", "stream",
                            "--out-dir", tmp_path], capsys)
    assert rc == 0, err
    assert out.splitlines()[0] == "==done=="
    stats = check.check_av_vels_only(MINI_GOLDEN, str(tmp_path / "av_vels.dat"))
    assert stats.passed(1.0)


def _grid(n):
    return LBMParams(nx=n, ny=n, max_iters=16, reynolds_dim=10,
                     density=0.1, accel=0.005, omega=1.85), np.zeros((n, n), dtype=bool)


def _card_of(monkeypatch, nbytes):
    """Pretend the run's device has ``nbytes`` of memory."""
    monkeypatch.setattr(d2q9_bgk, "_device_memory_bytes", lambda device: nbytes)


def _between(n):
    """A card on which the stream tier fits a n x n grid but two states do
    not (nor the stream tier with a second state for its tail)."""
    state = 4 * 9 * n * n
    return int((stream_kernel.tier_bytes(n, n) + 0.3 * state) / d2q9_bgk.FIT_MARGIN)


def test_auto_falls_through_to_stream(monkeypatch):
    _card_of(monkeypatch, _between(256))
    sim = Simulation(*_grid(256), backend="auto", device="cpu")
    assert sim.backend == "stream"


def test_auto_keeps_pallask_when_it_fits(monkeypatch):
    _card_of(monkeypatch, 80 * 10**9)
    sim = Simulation(*_grid(256), backend="auto", device="cpu")
    assert sim.backend == "pallask"


def test_gate_suggests_stream_before_allocating(monkeypatch):
    _card_of(monkeypatch, _between(256))
    sim = Simulation(*_grid(256), backend="pallask", device="cpu")
    with pytest.raises(ValueError, match="use --backend stream"):
        sim.warmup()
    with pytest.raises(ValueError, match="two state buffers"):
        sim.run(n_iters=8)


def test_gate_raises_when_even_stream_does_not_fit(monkeypatch):
    _card_of(monkeypatch, 4 * 9 * 256 * 256)  # one state: nothing fits
    for backend in ("auto", "stream", "pallask"):
        sim = Simulation(*_grid(256), backend=backend, device="cpu")
        with pytest.raises(ValueError, match="no single-card backend"):
            sim.warmup()


def test_debug_fit_gate_uses_the_step_loop_requirement(monkeypatch):
    """stream passes its gate, but --debug runs the step kernel's two-buffer
    loop, and the gate holds it to that."""
    _card_of(monkeypatch, _between(256))
    sim = Simulation(*_grid(256), backend="stream", device="cpu")
    sim._check_single_chip_fit(False)
    with pytest.raises(ValueError, match="--debug forces the step kernel"):
        sim._check_single_chip_fit(True)


def test_capacity_tier_runs_in_one_buffer_and_refuses_a_tail(monkeypatch):
    _card_of(monkeypatch, _between(256))
    sim = Simulation(*_grid(256), backend="stream", device="cpu")
    assert not sim._stream_tail_fits()
    with pytest.raises(ValueError, match="n_iters % 8"):
        sim.run(n_iters=12)
    res = sim.run(n_iters=16)
    monkeypatch.undo()
    step = Simulation(*_grid(256), backend="step", device="cpu").run(n_iters=16)
    np.testing.assert_array_equal(res.f_final, step.f_final)
    np.testing.assert_allclose(res.av_vels, step.av_vels, rtol=1e-5)


def test_device_memory_is_none_off_cuda():
    assert d2q9_bgk._device_memory_bytes("cpu") is None


def _ragged_mask(ny, nx, seed=9):
    rng = np.random.RandomState(seed)
    mask = rng.rand(ny, nx) < 0.2
    mask[0] = mask[-1] = True
    return mask


@pytest.mark.parametrize("prop,module", [("_enc", stream_kernel), ("_mask", step_kernel)])
def test_kernel_masks_are_encoded_on_the_device(monkeypatch, prop, module):
    """The bool plane goes to the Simulation's device first and is encoded
    there (the meta device shows where), as the JAX package encodes on
    device arrays."""
    seen = []
    real = module.prepare_obstacles
    monkeypatch.setattr(module, "prepare_obstacles",
                        lambda obst: seen.append(obst.device) or real(obst))
    sim = Simulation(LBMParams(nx=37, ny=21, max_iters=2, reynolds_dim=10, density=0.1,
                               accel=0.005, omega=1.85),
                     _ragged_mask(21, 37), backend="stream", device="meta")
    out = getattr(sim, prop)
    assert seen == [torch.device("meta")] and out.device == torch.device("meta")
    assert out.dtype == torch.uint8 and out.shape == (21, 37)


@pytest.mark.parametrize("ny,nx", [(21, 37), (100, 103)])
def test_kernel_masks_equal_the_host_and_jax_encodings(ny, nx):
    import jax.numpy as jnp

    from advanced_hpc_lbm_tpu.ops import pallas_stream

    mask = _ragged_mask(ny, nx)
    sim = Simulation(LBMParams(nx=nx, ny=ny, max_iters=2, reynolds_dim=10, density=0.1,
                               accel=0.005, omega=1.85), mask, backend="stream", device="cpu")
    host = stream_kernel.prepare_obstacles(torch.from_numpy(mask))
    assert sim._enc.numpy().tobytes() == host.numpy().tobytes()
    jenc = np.asarray(pallas_stream.prepare_obstacles(jnp.asarray(mask)))[stream_kernel.K:-stream_kernel.K]
    np.testing.assert_array_equal(sim._enc.numpy(), jenc.astype(np.uint8))
    assert sim._mask.numpy().tobytes() == mask.astype(np.uint8).tobytes()
