"""The JAX package's answers for tests/test_torch_split_reference.py.

    python tests/data/split_reference/make_reference.py

from the root of the checkout (jax on the CPU; a few seconds) writes
``reference.npz`` beside this file: for the test's two configurations
(``test_torch_split_reference.config_3d`` and ``config_data_section``,
their tables written with numpy into a temporary directory), the
events (the data section's as the JAX ensemble assembles them), the
read bins, ``PdfStack.evaluate`` at each of the test's ``THETAS`` and
``evaluate_batch`` at all of them, and ``MCMC.nll`` at its ``PARAMS``.
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

import jax.numpy as jnp  # noqa: E402

from sxmc_tpu.fitconfig import FitConfig  # noqa: E402
from sxmc_tpu.mcmc.metropolis import MCMC  # noqa: E402

import test_torch_split_reference as t  # noqa: E402


def main():
    out = {}
    for kind, make in (("3d", t.config_3d), ("data", t.config_data_section)):
        with tempfile.TemporaryDirectory() as root:
            path = os.path.join(root, "fit.json")
            with open(path, "w") as f:
                json.dump(make(root), f)
            fc = FitConfig.from_json_file(path, data_root=root)
            if kind == "3d":
                events = t.events_3d()
            else:
                events = np.concatenate([
                    sigs[0].histogram.get_samples()
                    for sigs in fc.data.values()], axis=0)
            mcmc = MCMC(fc.sources, fc.signals, fc.systematics,
                        fc.observables)
        st = mcmc.stack
        st.set_data(events)
        out[f"{kind}_events"] = np.asarray(events, np.float32)
        out[f"{kind}_read_bins"] = np.asarray(st._read_bins)
        thetas = np.asarray(t.THETAS[kind], np.float32)
        for i, theta in enumerate(thetas):
            lut, norms = st.evaluate(jnp.asarray(theta))
            out[f"{kind}_lut_{i}"] = np.asarray(lut)
            out[f"{kind}_norms_{i}"] = np.asarray(norms)
        lut, norms = st.evaluate_batch(jnp.asarray(thetas))
        out[f"{kind}_batch_lut"] = np.asarray(lut)
        out[f"{kind}_batch_norms"] = np.asarray(norms)
        out[f"{kind}_nll"] = np.asarray(
            [mcmc.nll(events, np.asarray(p, np.float32))
             for p in t.PARAMS[kind]], np.float64)
    np.savez_compressed(os.path.join(HERE, "reference.npz"), **out)


if __name__ == "__main__":
    main()
