"""The PyTorch port's plain ops against the JAX package, on the CPU.

The same seeded numpy inputs go through each JAX function and its
counterpart in ``advanced_hpc_lbm_tpu_torch``.  Tolerances: f within
rtol 1e-6 for the arithmetic ops (both sides compute in float32 with the
same op order; eager JAX and PyTorch agree bit for bit here, jitted XLA
may contract a multiply-add), and bitwise for the pure data movement of
stream_pull and apply_bounce_back.  Whole-grid sums (av velocity, total
density) are taken in another order by the two libraries: rtol 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from advanced_hpc_lbm_tpu.ops import fused as jfused
from advanced_hpc_lbm_tpu.ops import kernel_common as jkc
from advanced_hpc_lbm_tpu.ops import lattice as jlattice
from advanced_hpc_lbm_tpu.ops import reference as jref
from advanced_hpc_lbm_tpu.params import LBMParams as JaxParams
from advanced_hpc_lbm_tpu_torch.ops import fused, kernel_common, lattice, reference
from advanced_hpc_lbm_tpu_torch.params import LBMParams

RTOL = 1e-6
SUM_RTOL = 1e-5

SHAPES = [(16, 32), (17, 23)]


def make_inputs(ny, nx, seed=0):
    """Seeded (params, mask, f): equilibrium x uniform(0.8, 1.2) in a box
    with an interior block and a few random obstacles."""
    jp = JaxParams(nx=nx, ny=ny, max_iters=10, reynolds_dim=10,
                   density=0.1, accel=0.005, omega=1.85)
    rng = np.random.RandomState(seed)
    mask = np.zeros((ny, nx), dtype=bool)
    mask[0] = mask[-1] = True
    mask[ny // 3: ny // 3 + 2, nx // 4: nx // 2] = True
    for _ in range(5):
        mask[rng.randint(1, ny - 1), rng.randint(0, nx)] = True
    f = np.asarray(jref.initial_state(jp)) * rng.uniform(
        0.8, 1.2, (9, ny, nx)).astype(np.float32)
    return jp, mask, f


def T(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def close(port, jax_value, rtol=RTOL):
    np.testing.assert_allclose(
        port.numpy() if isinstance(port, torch.Tensor) else port,
        np.asarray(jax_value), rtol=rtol, atol=0.0,
    )


# ---- params and lattice ------------------------------------------------------

def test_params_from_jax_keeps_fields_and_float32_scalars():
    jp, _, _ = make_inputs(16, 32)
    p = LBMParams.from_jax(jp)
    for name in ("nx", "ny", "max_iters", "reynolds_dim", "density", "accel", "omega"):
        assert getattr(p, name) == getattr(jp, name)
    for name in ("accel_w1", "accel_w2", "omega_f32", "density_f32"):
        assert getattr(p, name).dtype == np.float32
        assert getattr(p, name) == getattr(jp, name)
    assert p.viscosity == jp.viscosity


@pytest.mark.parametrize("bad", [dict(nx=0), dict(ny=-1), dict(max_iters=-1)])
def test_params_validation_matches(bad):
    fields = dict(nx=4, ny=4, max_iters=1, reynolds_dim=1,
                  density=0.1, accel=0.005, omega=1.0) | bad
    with pytest.raises(ValueError):
        JaxParams(**fields)
    with pytest.raises(ValueError):
        LBMParams(**fields)


@pytest.mark.parametrize("name", ["CX", "CY", "W", "OPP", "C_SQ"])
def test_lattice_constants_match(name):
    port, ref = getattr(lattice, name), getattr(jlattice, name)
    assert np.asarray(port).dtype == np.asarray(ref).dtype
    np.testing.assert_array_equal(port, ref)


# ---- reference ops -------------------------------------------------------------

def test_initial_state_bitwise():
    jp, _, _ = make_inputs(16, 32)
    f = reference.initial_state(LBMParams.from_jax(jp), "cpu")
    assert f.dtype == torch.float32 and f.is_contiguous()
    np.testing.assert_array_equal(f.numpy(), np.asarray(jref.initial_state(jp)))


def test_state_from_numpy_roundtrip():
    _, _, f = make_inputs(16, 32)
    t = reference.state_from_numpy(f, "cpu")
    assert t.dtype == torch.float32 and t.shape == f.shape
    np.testing.assert_array_equal(t.numpy(), f)


@pytest.mark.parametrize("ny,nx", SHAPES)
def test_accelerate_flow(ny, nx):
    jp, mask, f = make_inputs(ny, nx)
    out = reference.accelerate_flow(T(f), T(mask), jp.accel_w1, jp.accel_w2)
    ref = jref.accelerate_flow(jnp.asarray(f), jnp.asarray(mask), jp.accel_w1, jp.accel_w2)
    close(out, ref)
    # the port's op returns a new tensor and leaves its input alone
    assert not np.array_equal(out.numpy(), f)


def test_accelerate_flow_guard_fails_on_starved_cells():
    jp, mask, f = make_inputs(16, 32)
    f[3, 14, :16] = jp.accel_w1 * np.float32(0.5)  # W too small to decrement
    out = reference.accelerate_flow(T(f), T(mask), jp.accel_w1, jp.accel_w2)
    ref = jref.accelerate_flow(jnp.asarray(f), jnp.asarray(mask), jp.accel_w1, jp.accel_w2)
    close(out, ref)
    np.testing.assert_array_equal(out.numpy()[:, 14, :16], f[:, 14, :16])


@pytest.mark.parametrize("ny,nx", SHAPES)
def test_stream_pull_bitwise(ny, nx):
    _, _, f = make_inputs(ny, nx)
    np.testing.assert_array_equal(
        reference.stream_pull(T(f)).numpy(), np.asarray(jref.stream_pull(jnp.asarray(f)))
    )


@pytest.mark.parametrize("ny,nx", SHAPES)
def test_apply_bounce_back_bitwise(ny, nx):
    _, mask, f = make_inputs(ny, nx)
    np.testing.assert_array_equal(
        reference.apply_bounce_back(T(f), T(mask)).numpy(),
        np.asarray(jref.apply_bounce_back(jnp.asarray(f), jnp.asarray(mask))),
    )


@pytest.mark.parametrize("ny,nx", SHAPES)
def test_macroscopic(ny, nx):
    _, _, f = make_inputs(ny, nx)
    for port, ref in zip(reference.macroscopic(T(f)), jref.macroscopic(jnp.asarray(f))):
        close(port, ref)


@pytest.mark.parametrize("ny,nx", SHAPES)
def test_equilibrium(ny, nx):
    _, _, f = make_inputs(ny, nx)
    rho, ux, uy = (x.numpy() for x in reference.macroscopic(T(f)))
    close(reference.equilibrium(T(rho), T(ux), T(uy)),
          jref.equilibrium(jnp.asarray(rho), jnp.asarray(ux), jnp.asarray(uy)))


@pytest.mark.parametrize("ny,nx", SHAPES)
def test_bgk_collide(ny, nx):
    jp, mask, f = make_inputs(ny, nx)
    close(reference.bgk_collide(T(f), T(mask), jp.omega_f32),
          jref.bgk_collide(jnp.asarray(f), jnp.asarray(mask), jp.omega_f32))


@pytest.mark.parametrize("ny,nx", SHAPES)
def test_av_velocity_and_total_density(ny, nx):
    _, mask, f = make_inputs(ny, nx)
    close(reference.av_velocity(T(f), T(mask)),
          jref.av_velocity(jnp.asarray(f), jnp.asarray(mask)), SUM_RTOL)
    close(reference.total_density(T(f)), jref.total_density(jnp.asarray(f)), SUM_RTOL)


@pytest.mark.parametrize("ny,nx", SHAPES)
def test_timestep_pipeline(ny, nx):
    jp, mask, f = make_inputs(ny, nx)
    fp, avp = reference.timestep_pipeline(T(f), T(mask), LBMParams.from_jax(jp))
    fj, avj = jref.timestep_pipeline(jnp.asarray(f), jnp.asarray(mask), jp)
    close(fp, fj)
    close(avp, avj, SUM_RTOL)


# ---- kernel_common: the step math of the kernels ---------------------------------

def test_step_constants_are_jax_float32_products():
    jp, _, _ = make_inputs(16, 32)
    c = kernel_common.step_constants(LBMParams.from_jax(jp))
    omega = jp.omega_f32
    assert c["w0_omega"] == np.float32(jlattice.W[0]) * omega
    assert c["w1_omega"] == np.float32(jlattice.W[1]) * omega
    assert c["w2_omega"] == np.float32(jlattice.W[5]) * omega
    assert c["one_minus_omega"] == jnp.float32(1.0) - omega
    assert (c["accel_w1"], c["accel_w2"]) == (jp.accel_w1, jp.accel_w2)
    assert all(v.dtype == np.float32 for v in c.values())


@pytest.mark.parametrize("ny,nx", SHAPES)
def test_collide_matches_jax(ny, nx):
    jp, mask, f = make_inputs(ny, nx)
    out, u_sq = kernel_common.collide([T(p) for p in f], T(mask), LBMParams.from_jax(jp))
    jout, ju_sq = jkc.collide([jnp.asarray(p) for p in f], jnp.asarray(mask), jp)
    for a, b in zip(out, jout):
        close(a, b)
    close(u_sq, ju_sq)


@pytest.mark.parametrize("ny,nx", SHAPES)
def test_forced_matches_jax(ny, nx):
    jp, mask, f = make_inputs(ny, nx)
    f[3, ny - 2, : nx // 2] = jp.accel_w1 * np.float32(0.5)  # some cells fail the guard
    rows = np.arange(ny)[:, None] == ny - 2
    out = kernel_common.forced([T(p) for p in f], T(mask), T(rows), LBMParams.from_jax(jp))
    jout = jkc.forced([jnp.asarray(p) for p in f], jnp.asarray(mask), jnp.asarray(rows), jp)
    for a, b in zip(out, jout):
        close(a, b)


# ---- fused step and run loop ----------------------------------------------------

@pytest.mark.parametrize("ny,nx", SHAPES)
def test_fused_step_matches_jax(ny, nx):
    jp, mask, f = make_inputs(ny, nx)
    n_fluid = np.float32((~mask).sum())
    fp, avp = fused.fused_step(T(f), T(mask), torch.tensor(n_fluid), LBMParams.from_jax(jp))
    fj, avj = jfused.fused_step(jnp.asarray(f), jnp.asarray(mask), jnp.float32(n_fluid), jp)
    close(fp, fj)
    close(avp, avj, SUM_RTOL)


def test_fused_step_writes_into_out():
    jp, mask, f = make_inputs(16, 32)
    n_fluid = torch.tensor(np.float32((~mask).sum()))
    buf = torch.empty(f.shape)
    out, _ = fused.fused_step(T(f), T(mask), n_fluid, LBMParams.from_jax(jp), out=buf)
    assert out is buf
    ref, _ = fused.fused_step(T(f), T(mask), n_fluid, LBMParams.from_jax(jp))
    np.testing.assert_array_equal(buf.numpy(), ref.numpy())


@pytest.mark.parametrize("collect_density", [False, True])
def test_run_simulation_matches_jax(collect_density):
    jp, mask, f = make_inputs(16, 32, seed=2)
    f_in = T(f.copy())
    out = fused.run_simulation(f_in, T(mask), LBMParams.from_jax(jp), n_iters=6,
                               collect_density=collect_density)
    ref = jax.jit(lambda f0, o: jfused.run_simulation(
        f0, o, jp, n_iters=6, collect_density=collect_density))(jnp.asarray(f), jnp.asarray(mask))
    assert len(out) == len(ref) == (3 if collect_density else 2)
    np.testing.assert_allclose(out[0].numpy(), np.asarray(ref[0]), rtol=1e-5, atol=1e-7)
    for a, b in zip(out[1:], ref[1:]):
        assert a.shape == (6,)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    np.testing.assert_array_equal(f_in.numpy(), f)  # f0 is not modified


def test_pipeline_step_matches_reference():
    jp, mask, f = make_inputs(17, 23)
    p = LBMParams.from_jax(jp)
    n_fluid = torch.tensor(np.float32((~mask).sum()))
    fa, ava = fused.pipeline_step(T(f), T(mask), n_fluid, p, out=torch.empty(f.shape))
    fb, avb = reference.timestep_pipeline(T(f), T(mask), p)
    np.testing.assert_array_equal(fa.numpy(), fb.numpy())
    assert float(ava) == float(avb)
