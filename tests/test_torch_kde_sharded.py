"""KDE signals through the sharded ensemble, the CLI and the statistics
tier's side fits.

The JAX package's sharded ensemble with ``kde_exact`` (its datasets, its
chains' streams and samples) is stored by
tests/data/kde_reference/make_reference.py: fed the same, the port's
per-experiment route, each experiment's exact rows at its own padded
events, must keep JAX's samples (as test_torch_kde_fit: within 1e-5
relative, every decision equal).
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from sxmc_tpu_torch.fitconfig import FitConfig
from sxmc_tpu_torch.parallel import ensemble as par
from sxmc_tpu_torch.stats.likelihood import LikelihoodSpace

from test_torch_kde import make_kde_data, make_kde_inputs
from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)
from test_torch_pooled import GEN, REF

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).resolve().parent / "data" / "golden"


def _fc(nexp=GEN.SHARD_NEXP):
    srcs, sigs, systs, obs = make_kde_inputs("sxmc_tpu_torch", exact=True)
    return FitConfig(nexperiments=nexp, nsteps=GEN.SHARD_STEPS,
                     burnin_fraction=0.2, signal_name="sig",
                     seed=GEN.SHARD_SEED, nchains=GEN.SHARD_CHAINS,
                     signals=sigs, sources=srcs, systematics=systs,
                     observables=obs)


def test_sharded_exact_kde_matches_jax():
    nexp, nch = GEN.SHARD_NEXP, GEN.SHARD_CHAINS

    def streams(phase, seg, n):
        assert seg == 0
        return tuple(torch.as_tensor(np.stack([np.stack(
            [REF[f"shard_{x}_p{phase}_e{e}_c{c}"][:, 0]
             for c in range(nch)], axis=1) for e in range(nexp)], axis=1))
            for x in ("noise", "u"))

    lspaces, limits = par.run_sharded_ensemble(
        _fc(), verbose=False, device="cpu", stream_fn=streams,
        dataset_fn=lambda i: REF[f"shard_data_e{i}"])
    for e, ls in enumerate(lspaces):
        want = REF[f"shard_samples_e{e}"]
        assert ls.samples.shape == want.shape
        np.testing.assert_allclose(ls.samples, want, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(limits, REF["shard_limits"], rtol=1e-4)
    assert limits[0] != limits[1]


def test_sharded_exact_kde_checkpoint_refused(tmp_path):
    with pytest.raises(NotImplementedError, match="kde_exact"):
        par.run_sharded_ensemble(
            _fc(), verbose=False, device="cpu", checkpoint_steps=10,
            checkpoint_path=str(tmp_path / "ck"))


@pytest.mark.parametrize("key", ["kde", "kde_exact"])
def test_cli_fits_a_kde_signal(key, tmp_path):
    """The golden configuration with signal1 declared a KDE (grid, or
    exact at the events; from 2,000 of its MC rows, a KDE's few) through
    the CLI on the CPU: the default fit, and --sharded."""
    from sxmc_tpu_torch.cli import main
    from sxmc_tpu_torch.io import loaders

    data, fields = loaders.read_float_table(str(GOLDEN / "signal1.npz"))
    loaders.write_float_table(str(tmp_path / "kde1.npz"), data[:2000],
                              fields)
    cfg = json.loads((GOLDEN / "config.json").read_text())
    cfg["fit"]["nsteps"] = 60
    cfg["fit"]["output_format"] = "npz"
    sig = cfg["signals"]["signal1"]
    sig.update(filename=str(tmp_path / "kde1.npz"), kde=True,
               kde_exact=key == "kde_exact")
    path = tmp_path / "config.json"
    path.write_text(json.dumps(cfg))
    for flags in ([], ["--sharded"]):
        out = tmp_path / ("out" + "".join(flags))
        assert main([str(path), str(out), "--data-root", str(GOLDEN),
                     "--device", "cpu"] + flags) == 0
        ls = LikelihoodSpace.load(str(out / "golden_0.npz"))
        assert ls.samples.shape[0] > 0 and np.isfinite(ls.samples).all()


def test_side_fits_restore_the_exact_snapshot():
    """The hypothesis tests' side fits (an Asimov dataset) leave the
    fit's exact-KDE events and rows as they found them."""
    from sxmc_tpu_torch.stats.hypotest import _preserved_fit_state
    from sxmc_tpu_torch.stats.mle import MLE

    mle = MLE(*make_kde_inputs("sxmc_tpu_torch", exact=True), device="cpu")
    mle.stack.set_data(make_kde_data())
    before = mle.stack._kde_exact_state
    with _preserved_fit_state(mle):
        mle.stack.set_data(make_kde_data(seed=4, nev=90))
        assert mle.stack._kde_exact_state[0].shape[0] == 90
    assert mle.stack._kde_exact_state is before
