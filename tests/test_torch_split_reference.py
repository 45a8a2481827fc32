"""The split path (B1, then B2 through the read bins' plan) on the two
configurations that no other port test pins, against the JAX package's
answers stored in ``tests/data/split_reference/reference.npz`` (made by
its ``make_reference.py`` from the same numpy inputs; no JAX runs
here):

  * a 3-D, two-dataset configuration: three observables, a cut, a rate
    source shared by both datasets, a signal sized by ``scale``, a
    two-coefficient ``scale``, a ``resolution_scale`` on a truth field,
    a ``shift`` and a ``ctscale``, a static row, and events out of the
    domain (-1) or of no signal's dataset (-2);
  * the real-data ``data`` section of a two-dataset fit: the events the
    config loads, then the same checks.

``PdfStack.evaluate`` and ``evaluate_batch`` are held to the stored
LUTs within one float32 ulp (rtol 2e-7, as test_torch_lut.py), NaN
and 0 sentinels exact, norms exact; ``MCMC.nll`` within one float32 ulp
of the stored NLLs: the JAX package returns its NLL as a float32 (its
compensated pair added in float32), the port the float64 sum of its
pair, so the two differ by up to half an ulp of the float32 (the 3.5e-5
that ROADMAP §C measured on NLLs of ~1e3 is that rounding).
"""

import json
import os

import numpy as np
import pytest
import torch

from sxmc_tpu_torch.fitconfig import FitConfig
from sxmc_tpu_torch.io import loaders
from sxmc_tpu_torch.mcmc.metropolis import MCMC

from test_torch_lut import _assert_lut

torch.set_num_threads(1)

REF = os.path.join(os.path.dirname(__file__), "data", "split_reference",
                   "reference.npz")
N_MC = 4000


def _write(root, name, cols, fields):
    loaders.write_float_table(os.path.join(root, name),
                              np.stack(cols, axis=1).astype(np.float32),
                              fields)


def config_3d(root: str) -> dict:
    """The 3-D two-dataset configuration, its MC tables written under
    ``root``."""
    rng = np.random.default_rng(21)
    fields = ["energy", "mc_energy", "psd", "costheta", "radius"]
    for name, e0, ew in (("sig_p0", 10.0, 1.0), ("sig_p1", 9.0, 1.5),
                         ("bkg_p0", None, None), ("bkg_p1", None, None)):
        true = (rng.normal(e0, ew, N_MC) if e0 is not None
                else rng.uniform(5.0, 15.0, N_MC))
        _write(root, name + ".npz", [
            true + rng.normal(0.0, 0.3, N_MC), true,
            np.clip(rng.normal(0.6, 0.2, N_MC), 0.0, 0.999),
            rng.uniform(-1.0, 1.0, N_MC), rng.uniform(0.0, 8.0, N_MC)],
            fields)
    return {
        "fit": {"nexperiments": 1, "nsteps": 100, "burnin_fraction": 0.2,
                "signals": ["sig_p0", "sig_p1", "bkg_p0", "bkg_p1"],
                "observables": ["energy", "psd", "costheta"],
                "cuts": ["radius"], "seed": 4, "plots": False},
        "pdfs": {
            "observables": {
                "energy": {"title": "E", "field": "energy", "bins": 12,
                           "min": 5.0, "max": 15.0},
                "psd": {"title": "PSD", "field": "psd", "bins": 5,
                        "min": 0.0, "max": 1.0},
                "costheta": {"title": "cos", "field": "costheta",
                             "bins": 4, "min": -1.0, "max": 1.0},
                "radius": {"title": "R", "field": "radius", "bins": 10,
                           "min": 0.0, "max": 6.0}},
            "systematics": {
                "e_scale": {"title": "scale", "type": "scale",
                            "observable_field": "energy",
                            "mean": [0.0, 0.0], "sigma": [0.01, 0.001]},
                "e_res": {"title": "resolution",
                          "type": "resolution_scale",
                          "observable_field": "energy",
                          "truth_field": "mc_energy", "mean": [0.0],
                          "sigma": [0.05]},
                "psd_shift": {"title": "psd", "type": "shift",
                              "observable_field": "psd", "mean": [0.0],
                              "sigma": [0.02]},
                "ct_scale": {"title": "ct", "type": "ctscale",
                             "observable_field": "costheta",
                             "mean": [0.0], "sigma": [0.05]}}},
        "sources": {"solar": {"mean": 1.0, "sigma": 0.0}},
        "signals": {
            "sig_p0": {"title": "S0", "filename": "sig_p0.npz",
                       "dataset": 0, "source": "solar", "rate": 300.0,
                       "systematics": ["e_scale", "e_res", "psd_shift",
                                       "ct_scale"]},
            "sig_p1": {"title": "S1", "filename": "sig_p1.npz",
                       "dataset": 1, "source": "solar", "rate": 200.0,
                       "systematics": ["e_scale", "ct_scale"]},
            "bkg_p0": {"title": "B0", "filename": "bkg_p0.npz",
                       "dataset": 0, "scale": 0.1, "sigma": 0.1,
                       "systematics": ["psd_shift"]},
            "bkg_p1": {"title": "B1", "filename": "bkg_p1.npz",
                       "dataset": 1, "rate": 250.0, "sigma": 0.1}}}


def events_3d() -> np.ndarray:
    """``(nevents, 4)`` events of the 3-D configuration (tag last): some
    outside the energy or PSD range, some tagged with no signal's
    dataset."""
    rng = np.random.default_rng(5)
    n = 1501
    return np.stack([rng.uniform(4.0, 16.0, n), rng.uniform(-0.05, 1.0, n),
                     rng.uniform(-1.0, 1.0, n),
                     rng.choice([0.0, 1.0, 2.0], n, p=[0.55, 0.4, 0.05])],
                    axis=1).astype(np.float32)


def config_data_section(root: str) -> dict:
    """A two-dataset fit whose events come from its ``data`` section (one
    real table per dataset), an energy scale on both signals."""
    rng = np.random.default_rng(17)
    for name, cols in (("sig_p0", rng.normal(10, 1, N_MC)),
                       ("sig_p1", rng.normal(10, 2, N_MC)),
                       ("bkg_p0", rng.uniform(5, 15, N_MC)),
                       ("bkg_p1", rng.uniform(5, 15, N_MC)),
                       ("data0", np.concatenate([rng.normal(10, 1, 300),
                                                 rng.uniform(4, 16, 401)])),
                       ("data1", np.concatenate([rng.normal(10, 2, 200),
                                                 rng.uniform(4, 16, 303)]))):
        _write(root, name + ".npz", [cols], ["energy"])
    sig = {"title": "S", "source": "signal_rate",
           "systematics": ["e_scale"]}
    return {
        "fit": {"nexperiments": 1, "nsteps": 100, "burnin_fraction": 0.2,
                "signals": ["sig0", "sig1", "bkg0", "bkg1"],
                "observables": ["energy"], "seed": 2, "plots": False},
        "pdfs": {
            "observables": {"energy": {"title": "E", "field": "energy",
                                       "bins": 20, "min": 5.0,
                                       "max": 15.0}},
            "systematics": {"e_scale": {"title": "scale", "type": "scale",
                                        "observable_field": "energy",
                                        "mean": [0.0], "sigma": [0.02]}}},
        "sources": {"signal_rate": {"mean": 1.0, "sigma": 0.0}},
        "signals": {
            "sig0": dict(sig, filename="sig_p0.npz", dataset=0, rate=300.0),
            "sig1": dict(sig, filename="sig_p1.npz", dataset=1, rate=200.0),
            "bkg0": {"title": "B0", "filename": "bkg_p0.npz", "dataset": 0,
                     "rate": 400.0},
            "bkg1": {"title": "B1", "filename": "bkg_p1.npz", "dataset": 1,
                     "rate": 300.0}},
        "data": {"0": [{"title": "run0", "filename": "data0.npz"}],
                 "1": [{"title": "run1", "filename": "data1.npz"}]}}


def data_section_events(fc) -> np.ndarray:
    """Experiment 0's events from a config's ``data`` section, as the
    ensemble assembles them (every dataset's table, in the section's
    order)."""
    return np.concatenate([sigs[0].histogram.get_samples()
                           for sigs in fc.data.values()], axis=0)


# Systematic parameters for evaluate and evaluate_batch, and full
# parameter vectors (rates first) for the NLL, of each configuration.
THETAS = {
    "3d": [[0.0, 0.0, 0.0, 0.0, 0.0], [0.012, -0.0007, 0.04, -0.015, 0.03],
           [-0.009, 0.0004, -0.06, 0.021, -0.04]],
    "data": [[0.0], [0.017], [-0.023]],
}
PARAMS = {
    "3d": [[1.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0, 0.0],
           [1.15, 0.9, 1.05, 0.012, -0.0007, 0.04, -0.015, 0.03],
           [0.8, 1.1, 0.95, -0.009, 0.0004, -0.06, 0.021, -0.04]],
    "data": [[1.0, 1.0, 1.0, 0.0], [1.2, 0.9, 1.1, 0.017],
             [0.85, 1.05, 0.95, -0.023]],
}


def build(kind: str, root: str):
    """``(FitConfig, events)`` of a configuration, its tables under
    ``root``."""
    conf = config_3d(root) if kind == "3d" else config_data_section(root)
    path = os.path.join(root, "fit.json")
    with open(path, "w") as f:
        json.dump(conf, f)
    fc = FitConfig.from_json_file(path, data_root=root)
    return fc, (events_3d() if kind == "3d" else data_section_events(fc))


@pytest.fixture(scope="module")
def ref():
    with np.load(REF) as z:
        return dict(z)


@pytest.fixture(scope="module", params=["3d", "data"])
def fit(request, tmp_path_factory):
    kind = request.param
    fc, events = build(kind, str(tmp_path_factory.mktemp(kind)))
    mcmc = MCMC(fc.sources, fc.signals, fc.systematics, fc.observables,
                device="cpu")
    return kind, mcmc, events


def test_events_and_read_bins_match_jax(fit, ref):
    kind, mcmc, events = fit
    np.testing.assert_array_equal(events, ref[f"{kind}_events"])
    mcmc.stack.set_data(events)
    rb = mcmc.stack.read_bins
    np.testing.assert_array_equal(rb.numpy(), ref[f"{kind}_read_bins"])
    # Both sentinels occur (the 3-D events go out of range and carry a
    # tag of no signal).
    assert (rb == -2).any() and (kind != "3d" or (rb == -1).any())
    assert mcmc.stack.lut_plan(rb) is mcmc.stack.lut_plan(rb)


def test_split_path_matches_jax(fit, ref):
    kind, mcmc, events = fit
    st = mcmc.stack
    st.set_data(events)
    thetas = np.asarray(THETAS[kind], np.float32)
    for i, theta in enumerate(thetas):
        lut, norms = st.evaluate(torch.as_tensor(theta))
        np.testing.assert_array_equal(norms.numpy(),
                                      ref[f"{kind}_norms_{i}"])
        _assert_lut(lut.numpy(), ref[f"{kind}_lut_{i}"])
    lut, norms = st.evaluate_batch(torch.as_tensor(thetas))
    np.testing.assert_array_equal(norms.numpy(), ref[f"{kind}_batch_norms"])
    _assert_lut(lut.numpy(), ref[f"{kind}_batch_lut"])


def test_nll_matches_jax(fit, ref):
    kind, mcmc, events = fit
    got = np.asarray([mcmc.nll(events, p) for p in PARAMS[kind]])
    want = ref[f"{kind}_nll"]
    assert np.all(np.abs(want) > 1e3)
    ulp = np.spacing(np.abs(want).astype(np.float32)).astype(np.float64)
    assert np.all(np.abs(got - want) <= ulp), (got, want, ulp)
