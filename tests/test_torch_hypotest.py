"""sxmc_tpu_torch's Asimov datasets, hypothesis tests and Feldman-Cousins
belts against the JAX package.

The inputs are test_torch_mle's (``make_stack_inputs`` / ``make_data``
from their seeds), the JAX package's answers stored by
``tests/data/stats_reference/make_reference.py``, and every toy batch
the JAX package drew there is fed to the port in the same order
(``toys=``), so that both packages fit the same toys.  Tolerances:
Asimov events exact and weights 1e-6 relative; q0 2e-3 and Z 1e-3
absolute; the asymptotic limit and band 1e-3 relative; the toys' dNLL
2e-3 absolute and r-hat 1e-3 relative; each CLs value within 1/ntoys.
"""

import numpy as np
import pytest
import torch

from sxmc_tpu_torch.stats.asimov import asimov_dataset
from sxmc_tpu_torch.stats.feldman_cousins import (FeldmanCousins,
                                                  toy_dnll_batch)
from sxmc_tpu_torch.stats.hypotest import HypoTest

from test_torch_mle import GEN, REF, port_mle
from test_torch_pdf import make_data
from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fitted():
    mle = port_mle()
    return mle, mle.fit(make_data(nev=GEN.NEV))


def stored_toys(prefix: str):
    """``toys(rates, ntoys)`` replaying the JAX package's batches of
    ``prefix`` in order, each asked for at the JAX package's rates."""
    batches = iter(range(int(REF[prefix + "n"])))

    def toys(rates, ntoys):
        i = next(batches)
        want = REF[f"{prefix}{i}_rates"]
        got = np.asarray([rates[n] for n in ("a", "b", "c")])
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6)
        assert REF[f"{prefix}{i}"].shape[0] == ntoys
        return REF[f"{prefix}{i}"]

    return toys


def test_asimov_dataset_matches_jax(fitted):
    events, weights = asimov_dataset(fitted[0])
    np.testing.assert_array_equal(events, REF["asimov_events"])
    np.testing.assert_allclose(weights, REF["asimov_weights"], rtol=1e-6)


def test_asymptotic_upper_limit_matches_jax(fitted):
    mle, _ = fitted
    asym = HypoTest(mle, "a").asymptotic_upper_limit(
        make_data(nev=GEN.NEV), GEN.ASYM_GRID, cl=0.9)
    assert asym.limit == pytest.approx(float(REF["asym_limit"]), rel=1e-3)
    np.testing.assert_allclose([asym.expected[n] for n in (-2, -1, 0, 1, 2)],
                               REF["asym_expected"], rtol=1e-3)
    np.testing.assert_allclose(asym.cls_obs, REF["asym_cls"], rtol=1e-3,
                               atol=1e-6)
    # The Asimov side fits left the MLE's dataset and fit in place.
    assert mle._last[0].nll == pytest.approx(float(REF["fit_nll"]),
                                             abs=1e-3)


def test_discovery_matches_jax(fitted):
    disc = HypoTest(fitted[0], "a").discovery(make_data(nev=GEN.NEV))
    assert abs(disc.q0 - float(REF["disc_q0"])) <= 2e-3
    assert abs(disc.z_asymptotic - float(REF["disc_z"])) <= 1e-3


def test_toy_dnll_batch_matches_jax(fitted):
    mle = fitted[0]
    rb = mle.stack.compute_read_bins(REF["dnll_toys"])
    dnll, rhat = toy_dnll_batch(mle, REF["dnll_r"], rb, 0, mle._free_rates)
    np.testing.assert_allclose(dnll, REF["dnll"], rtol=0, atol=2e-3)
    np.testing.assert_allclose(rhat, REF["dnll_rhat"], rtol=1e-3)


def test_cls_upper_limit_with_injected_toys(fitted):
    mle = fitted[0]
    limit, grid, cls = HypoTest(mle, "a").cls_upper_limit(
        None, make_data(nev=GEN.NEV), GEN.CLS_GRID, ntoys=GEN.NTOYS, cl=0.9,
        refine=1, toys=stored_toys("cls_toys_"))
    np.testing.assert_allclose(grid, REF["cls_grid"], rtol=1e-6)
    np.testing.assert_allclose(cls, REF["cls_values"], rtol=0,
                               atol=1.0 / GEN.NTOYS)
    assert np.isfinite(limit)


def test_feldman_cousins_with_injected_toys(fitted):
    mle = fitted[0]
    fc = FeldmanCousins(mle, "a")
    iv = fc.run(None, make_data(nev=GEN.NEV), GEN.FC_GRID, ntoys=GEN.NTOYS,
                cl=0.9, toys=stored_toys("fc_toys_"))
    np.testing.assert_allclose(fc.last_belt.dnll_toys, REF["fc_dnll"],
                               rtol=0, atol=2e-3)
    np.testing.assert_allclose(fc.last_belt.crit, REF["fc_crit"], rtol=0,
                               atol=2e-3)
    np.testing.assert_allclose([iv.lower, iv.upper], REF["fc_interval"],
                               rtol=1e-3)


def test_mesh_raises(fitted):
    with pytest.raises(NotImplementedError, match="item 14"):
        FeldmanCousins(fitted[0], "a").build_belt(None, [0.3], mesh=object())
