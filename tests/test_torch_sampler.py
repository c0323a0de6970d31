"""The port's sampler against the reference's: the DDIM timestep grid is
equal as integers on all 512 (T, M) pairs, the schedules and a DDIM update
agree as float32 allclose (``cumprod`` and ``linspace`` may round the last
bit differently in the two libraries)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import sampler as jsam  # noqa: E402
from repro_torch.core import sampler as tsam  # noqa: E402

F32 = dict(rtol=1e-6, atol=1e-7)     # float32: a few ulp


def test_ddim_timesteps_equal_on_512_pairs():
    """The grid lands on exact .5 values (937.5 at T=1000, M=16), so the
    last float32 bit of each grid point decides the rounding."""
    for T in (50, 100, 200, 1000):
        for M in range(1, 129):
            want = np.asarray(jsam.ddim_timesteps(T, M))
            got = tsam.ddim_timesteps(T, M).numpy()
            assert got.dtype == np.int32
            np.testing.assert_array_equal(got, want, err_msg=f"T={T} M={M}")


@pytest.mark.parametrize("make", ["linear_schedule", "cosine_schedule"])
@pytest.mark.parametrize("T", [100, 1000])
def test_schedules_allclose(make, T):
    j, t = getattr(jsam, make)(T), getattr(tsam, make)(T)
    np.testing.assert_allclose(t.alpha_bar.numpy(), np.asarray(j.alpha_bar), **F32)
    # the cosine betas are 1 - ab/ab_prev, a difference of numbers near 1:
    # one ulp of 1.0 (1.2e-7) in the ratio is the whole error budget
    np.testing.assert_allclose(t.betas.numpy(), np.asarray(j.betas),
                               rtol=1e-6, atol=3 * 2 ** -23)
    for tt in (0, 1, 37.5, T // 2, T):
        for fn in ("alpha", "sigma"):
            np.testing.assert_allclose(float(getattr(t, fn)(tt)),
                                       float(getattr(j, fn)(tt)), **F32)
    np.testing.assert_allclose(float(t.lam(T // 2)), float(j.lam(T // 2)),
                               rtol=1e-5)


@pytest.mark.parametrize("t_from,t_to", [(1000, 938), (62, 0), (500, 499)])
def test_ddim_step_allclose(t_from, t_to):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    eps = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    j, t = jsam.linear_schedule(1000), tsam.linear_schedule(1000)
    want = np.asarray(jsam.ddim_step(j, jnp.asarray(x), jnp.asarray(eps),
                                     t_from, t_to))
    got = tsam.ddim_step(t, torch.from_numpy(x), torch.from_numpy(eps),
                         t_from, t_to)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_ddim_step_keeps_bf16():
    t = tsam.linear_schedule(1000)
    x = torch.randn(1, 4, 4, 4).to(torch.bfloat16)
    assert tsam.ddim_step(t, x, x, 500, 400).dtype == torch.bfloat16


def test_ddim_sample_allclose():
    """A linear eps function, so the comparison is about the sampler alone."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((1, 4, 4, 2)).astype(np.float32)
    j, t = jsam.linear_schedule(100), tsam.linear_schedule(100)
    want = np.asarray(jsam.ddim_sample(lambda a, s: 0.3 * a, j,
                                       jnp.asarray(x), 10))
    got = tsam.ddim_sample(lambda a, s: 0.3 * a, t, torch.from_numpy(x), 10)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
