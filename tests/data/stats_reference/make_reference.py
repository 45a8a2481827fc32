"""The JAX package's answers for the frequentist-tier tests of the port.

    python tests/data/stats_reference/make_reference.py

from the root of the checkout (jax on the CPU; a few minutes, almost all
of it compiling the JAX package's solvers) writes ``reference.npz`` and
``cli_*.json`` beside this file.  tests/test_torch_mle.py,
test_torch_hypotest.py and test_torch_gof.py hold sxmc_tpu_torch against
them: the same numpy inputs, made from the same seeds there
(``test_torch_pdf.make_stack_inputs`` / ``make_data``, the golden
configuration), go through the port, and every toy dataset the JAX
package drew is stored here and fed to the port in the same order.  The
JAX package's solvers compile for several seconds per function and
shape, which is why their answers are computed once, here, and not in
every test run.
"""

import json
import os
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from sxmc_tpu import ensemble as j_ensemble  # noqa: E402
from sxmc_tpu import generator as j_generator  # noqa: E402
from sxmc_tpu.fitconfig import FitConfig  # noqa: E402
from sxmc_tpu.stats import bias as j_bias  # noqa: E402
from sxmc_tpu.stats import feldman_cousins as j_fc  # noqa: E402
from sxmc_tpu.stats import hypotest as j_ht  # noqa: E402
from sxmc_tpu.stats.asimov import asimov_dataset  # noqa: E402
from sxmc_tpu.stats.gof import goodness_of_fit  # noqa: E402
from sxmc_tpu.stats.mle import MLE  # noqa: E402

from test_torch_pdf import make_data, make_stack_inputs  # noqa: E402

# The inputs; the tests read them from here (test_torch_mle.load_reference).
N_MC = 3000
NEV = 400
PROFILE_A = [0.2, 0.3, 0.4, 0.5]
PROFILE_SCALE = [-0.02, -0.005, 0.005, 0.02]
PROFILE2D_A = [0.25, 0.4]
PROFILE2D_B = [0.08, 0.14]
PROFILE2D_SCALE = [-0.01, 0.01]
ASYM_GRID = [0.02, 0.1, 0.3, 0.45]
TOY_RATE = 0.4
NTOYS = 12
CLS_GRID = [0.3, 0.6]
FC_GRID = [0.27, 0.31, 0.35, 0.39]
CLI_STEPS = 200
# The GOF's data: the first toy of the dNLL batch, at its generating rates.
GOF_PARAMS = [TOY_RATE, 1.0, 1.0, 0.0, 0.0]


class Recorder:
    """Wraps a module's make_fake_dataset_batch: keeps every batch it
    returns, and the rates it was asked for, in call order."""

    def __init__(self, module):
        self.module, self.calls = module, []
        self.orig = module.make_fake_dataset_batch

        def wrapped(*args, **kw):
            out = np.asarray(self.orig(*args, **kw), np.float32)
            self.calls.append((dict(kw.get("rates") or {}), out))
            return out

        module.make_fake_dataset_batch = wrapped

    def restore(self):
        self.module.make_fake_dataset_batch = self.orig


def fit_record(out, prefix, res):
    out[prefix + "params"] = np.asarray(res.params, np.float64)
    out[prefix + "nll"] = np.float64(res.nll)
    out[prefix + "errors"] = np.sqrt(np.maximum(np.diag(res.covariance), 0))
    out[prefix + "converged"] = np.bool_(res.converged)


def save_toys(out, prefix, rec):
    out[prefix + "n"] = np.int64(len(rec.calls))
    for i, (rates, batch) in enumerate(rec.calls):
        out[f"{prefix}{i}"] = batch
        out[f"{prefix}{i}_rates"] = np.asarray(
            [rates.get(n, np.nan) for n in ("a", "b", "c")], np.float64)


def unit_references(out):
    data = make_data(nev=NEV)
    mle = MLE(*make_stack_inputs("sxmc_tpu", n_mc=N_MC))
    res = mle.fit(data)
    fit_record(out, "fit_", res)
    out["profile_a"] = mle.profile("a", PROFILE_A)
    out["profile_scale"] = mle.profile("scale_0", PROFILE_SCALE)
    out["profile2d_ab"] = mle.profile2d("a", "b", PROFILE2D_A, PROFILE2D_B)
    out["profile2d_scale_a"] = mle.profile2d("scale_0", "a",
                                             PROFILE2D_SCALE, PROFILE2D_A)
    iv = mle.profile_interval("b")
    out["interval_b"] = np.asarray([iv.point_estimate, iv.lower, iv.upper])
    out["upper_limit_a"] = np.float64(mle.upper_limit("a"))
    out["conditional_a"] = mle.conditional_fit("a", 0.25)

    # The systematics grid alone (its chosen thetas are in fit_params).
    binned = MLE(*make_stack_inputs("sxmc_tpu", n_mc=N_MC), binned=True)
    fit_record(out, "binned_", binned.fit(data))

    a_data, a_w = asimov_dataset(mle)
    out["asimov_events"], out["asimov_weights"] = a_data, a_w
    a_res = mle.fit(a_data, weights=a_w)
    fit_record(out, "asimov_", a_res)

    ht = j_ht.HypoTest(mle, "a")
    asym = ht.asymptotic_upper_limit(data, ASYM_GRID, cl=0.9)
    out["asym_limit"] = np.float64(asym.limit)
    out["asym_expected"] = np.asarray([asym.expected[n]
                                       for n in (-2, -1, 0, 1, 2)])
    out["asym_cls"] = asym.cls_obs
    disc = ht.discovery(data)
    out["disc_q0"], out["disc_z"] = np.float64(disc.q0), \
        np.float64(disc.z_asymptotic)

    # _toy_dnll_batch on a stored toy batch, a different r per toy.
    toys = np.asarray(j_generator.make_fake_dataset_batch(
        jax.random.PRNGKey(31), mle.signals, mle.systematics,
        mle.observables, NTOYS, poisson=True, stack=mle.stack,
        rates={"a": TOY_RATE, "b": 1.0, "c": 1.0}), np.float32)
    r_values = np.linspace(0.2, 0.6, NTOYS).astype(np.float32)
    rb = np.asarray(mle.stack.compute_read_bins(toys))
    dnll, rhat = j_fc._toy_dnll_batch(
        mle, jax.numpy.asarray(r_values), jax.numpy.asarray(rb),
        mle.stack.device_data, 0, tuple(mle._free_rates), mle.maxiter)
    out["dnll_toys"], out["dnll_r"] = toys, r_values
    out["dnll"], out["dnll_rhat"] = np.asarray(dnll), np.asarray(rhat)

    rec = Recorder(j_ht)
    limit, grid, cls = ht.cls_upper_limit(jax.random.PRNGKey(41), data,
                                          CLS_GRID, ntoys=NTOYS, cl=0.9,
                                          refine=1)
    rec.restore()
    out["cls_limit"], out["cls_grid"], out["cls_values"] = (
        np.float64(limit), grid, cls)
    save_toys(out, "cls_toys_", rec)

    rec = Recorder(j_fc)
    fc = j_fc.FeldmanCousins(mle, "a")
    iv = fc.run(jax.random.PRNGKey(43), data, FC_GRID, ntoys=NTOYS, cl=0.9)
    rec.restore()
    out["fc_crit"] = fc.last_belt.crit
    out["fc_dnll"] = fc.last_belt.dnll_toys
    out["fc_interval"] = np.asarray([iv.lower, iv.upper])
    save_toys(out, "fc_toys_", rec)

    rec = Recorder(j_bias)
    ps = j_bias.pull_study(mle, NTOYS, jax.random.PRNGKey(47))
    rec.restore()
    out["pull_estimates"], out["pull_errors"] = ps.estimates, ps.errors
    save_toys(out, "pull_toys_", rec)

    srcs, sigs, systs, obs = make_stack_inputs("sxmc_tpu", n_mc=N_MC)
    rec = Recorder(j_generator)
    g = goodness_of_fit(srcs, sigs, systs, obs, toys[0],
                        np.asarray(GOF_PARAMS, np.float32),
                        ntoys=NTOYS, key=jax.random.PRNGKey(53),
                        stack=mle.stack, refit=True)
    rec.restore()
    out["gof_chi2"], out["gof_ndof"] = np.float64(g.chi2), np.int64(g.ndof)
    out["gof_p_asym"] = np.float64(g.p_asymptotic)
    out["gof_chi2_toys"] = g.chi2_toys
    save_toys(out, "gof_toys_", rec)


def golden_config(workdir):
    with open(os.path.join(REPO, "tests", "data", "golden",
                           "config.json")) as f:
        cfg = json.load(f)
    cfg["fit"].update(nexperiments=1, nsteps=CLI_STEPS,
                      output_format="npz")
    path = os.path.join(workdir, "config.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def cli_references():
    """The JAX ensemble on the golden configuration: --sampler mle --gof 0
    --hypotest-asymptotic, and the Metropolis fit with --hypotest 8
    --bias-study 8; each run's fake dataset and JSON outputs."""
    golden = os.path.join(REPO, "tests", "data", "golden")
    runs = {"mle": dict(sampler="mle", gof_toys=0,
                        hypotest_asymptotic=True),
            "metropolis": dict(hypotest_toys=8, bias_toys=8)}
    for tag, kw in runs.items():
        with tempfile.TemporaryDirectory() as work:
            fc = FitConfig.from_json_file(golden_config(work),
                                          data_root=golden)
            seen = []
            orig = j_ensemble.make_fake_dataset

            def recorded(*a, **k):
                seen.append(np.asarray(orig(*a, **k), np.float32))
                return seen[-1]

            j_ensemble.make_fake_dataset = recorded
            try:
                j_ensemble.run_ensemble(fc, work, verbose=False,
                                        max_retries=0, **kw)
            finally:
                j_ensemble.make_fake_dataset = orig
            result = {"dataset": seen[0].tolist()}
            for name in os.listdir(work):
                if name.endswith(".json") and name != "config.json":
                    with open(os.path.join(work, name)) as f:
                        result[name] = json.load(f)
        with open(os.path.join(HERE, f"cli_{tag}.json"), "w") as f:
            json.dump(result, f)


def main():
    out = {}
    unit_references(out)
    np.savez_compressed(os.path.join(HERE, "reference.npz"), **out)
    cli_references()


if __name__ == "__main__":
    main()
