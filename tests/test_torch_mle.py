"""sxmc_tpu_torch.stats.mle (and its solver) against the JAX package.

The fits, profiles and limits are held against the JAX package's answers
on the same numpy inputs (``make_stack_inputs`` / ``make_data`` from
their seeds): the JAX package's solvers compile for seconds per function
and shape, so their answers are computed once by
``tests/data/stats_reference/make_reference.py`` and stored beside it.
The solver itself (batched BFGS with the zoom line search) and the NLL's
Hessian are held against ``jax.scipy.optimize.minimize`` and
``jax.hessian`` here, live.  Tolerances: NLL at the optimum 1e-3
absolute, free rates and profiles 1e-3 relative, Hessian errors 1e-2
relative, ``converged`` equal, the chosen systematics equal.
"""

import importlib.util
import pathlib

import numpy as np
import pytest
import torch

from sxmc_tpu_torch.stats import bfgs
from sxmc_tpu_torch.stats.mle import MLE

from test_torch_pdf import make_data, make_stack_inputs
from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)

torch.set_num_threads(1)

REF_DIR = pathlib.Path(__file__).resolve().parent / "data" / "stats_reference"


def load_reference():
    """(the generator module with the inputs' constants, its answers)."""
    spec = importlib.util.spec_from_file_location(
        "make_reference", REF_DIR / "make_reference.py")
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    return gen, dict(np.load(REF_DIR / "reference.npz"))


GEN, REF = load_reference()


def port_mle(binned: bool = False) -> MLE:
    return MLE(*make_stack_inputs("sxmc_tpu_torch", n_mc=GEN.N_MC),
               device="cpu", binned=binned)


def check_fit(res, prefix: str, free=(0, 1, 2)):
    """A FitResult against the reference's ``prefix`` fit."""
    assert abs(res.nll - float(REF[prefix + "nll"])) <= 1e-3
    want = REF[prefix + "params"]
    np.testing.assert_allclose(res.params[list(free)], want[list(free)],
                               rtol=1e-3)
    # The systematics grid's chosen coefficients: the same grid points.
    np.testing.assert_array_equal(res.params[3:],
                                  want[3:].astype(np.float32))
    np.testing.assert_allclose(np.sqrt(np.diag(res.covariance)),
                               REF[prefix + "errors"], rtol=1e-2)
    assert res.converged == bool(REF[prefix + "converged"])


@pytest.fixture(scope="module")
def fitted():
    mle = port_mle()
    return mle, mle.fit(make_data(nev=GEN.NEV))


def test_fit_matches_jax(fitted):
    check_fit(fitted[1], "fit_")


def test_binned_fit_matches_jax():
    mle = port_mle(binned=True)
    check_fit(mle.fit(make_data(nev=GEN.NEV)), "binned_")


def test_weighted_fit_matches_jax(fitted):
    """The Asimov dataset's weighted fit (the JAX package's own events
    and weights as input)."""
    mle = fitted[0]
    data, w = REF["asimov_events"], REF["asimov_weights"]
    res = mle.fit(data, weights=w)
    try:
        check_fit(res, "asimov_")
    finally:
        mle.fit(make_data(nev=GEN.NEV))  # the module's fit again


PROFILES = {
    "profile_a": lambda m, r: m.profile("a", GEN.PROFILE_A, r),
    "profile_scale": lambda m, r: m.profile("scale_0", GEN.PROFILE_SCALE, r),
    "profile2d_ab": lambda m, r: m.profile2d("a", "b", GEN.PROFILE2D_A,
                                             GEN.PROFILE2D_B, r),
    "profile2d_scale_a": lambda m, r: m.profile2d(
        "scale_0", "a", GEN.PROFILE2D_SCALE, GEN.PROFILE2D_A, r),
    "interval_b": lambda m, r: (lambda iv: np.asarray(
        [iv.point_estimate, iv.lower, iv.upper]))(
            m.profile_interval("b", result=r)),
    "upper_limit_a": lambda m, r: m.upper_limit("a", result=r),
    "conditional_a": lambda m, r: m.conditional_fit("a", 0.25, r),
}


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_profiles_match_jax(fitted, name):
    got = np.asarray(PROFILES[name](*fitted), np.float64)
    np.testing.assert_allclose(got, REF[name], rtol=1e-3)


def test_nll_hessian_matches_jax(fitted):
    """torch.func.hessian of the port's NLL against jax.hessian of the
    JAX package's, on the same LUT, norms and weights; and the solver's
    batched (double backward) Hessian against torch.func's."""
    import jax
    import jax.numpy as jnp

    from sxmc_tpu.ops.nll import NLLStatic, nll as j_nll
    from sxmc_tpu_torch.ops.nll import nll as t_nll

    mle, res = fitted
    lut, norms = mle.stack.evaluate(torch.as_tensor(res.params[3:]))
    w = np.random.default_rng(5).uniform(0.5, 2.0, lut.shape[1]).astype(
        np.float32)
    st = mle.static
    jst = NLLStatic(*[np.asarray(x) for x in st[:5]], st.nsources)
    p0 = res.params.astype(np.float32)
    want = np.asarray(jax.jit(jax.hessian(lambda p: j_nll(
        p, jnp.asarray(lut.numpy()), jnp.asarray(norms.numpy()), jst,
        jnp.asarray(w))))(jnp.asarray(p0)))
    consts = mle.nll_spec.consts
    wt = torch.as_tensor(w)

    def f(p):
        return t_nll(p, lut, norms, consts, wt)

    got = torch.func.hessian(f)(torch.as_tensor(p0)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3)
    batched = bfgs.Objective(
        lambda x: t_nll(x, lut, norms, consts, wt)).hessian(
            torch.as_tensor(p0)[None])[0].numpy()
    np.testing.assert_allclose(batched, got, rtol=1e-5, atol=1e-5)


def rosenbrock_jax(x):
    return (1.0 - x[0]) ** 2 + 100.0 * (x[1] - x[0] ** 2) ** 2


def test_bfgs_matches_jax_minimize():
    """The batched BFGS against jax.scipy.optimize.minimize, row by row,
    on Rosenbrock's function in float32 from three starts; a row that
    starts at the minimum stays frozen, bit for bit, while the others
    iterate."""
    import jax
    import jax.numpy as jnp
    from jax.scipy.optimize import minimize

    def one(x0):  # vmap keeps each row's loop state its own
        r = minimize(rosenbrock_jax, x0, method="BFGS",
                     options={"maxiter": 400, "gtol": 1e-4})
        return r.x, r.fun, r.success

    starts = np.asarray([[-1.2, 1.0], [0.5, -0.3], [1.0, 1.0]], np.float32)
    want = [np.asarray(a) for a in
            jax.jit(jax.vmap(one))(jnp.asarray(starts))]
    obj = bfgs.Objective(lambda x: (1.0 - x[..., 0]) ** 2 + 100.0 * (
        x[..., 1] - x[..., 0] ** 2) ** 2)
    x, f, ok = bfgs.bfgs(obj, torch.as_tensor(starts), 400)
    np.testing.assert_allclose(x.numpy(), want[0], rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(f.numpy(), want[1], rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ok.numpy(), want[2])
    assert torch.equal(x[2], torch.as_tensor(starts[2]))
