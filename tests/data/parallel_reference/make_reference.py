"""The JAX package's answers for the sharding tests of the port.

    python tests/data/parallel_reference/make_reference.py

from the root of the checkout (jax on the CPU with 8 virtual devices,
as tests/conftest.py sets them up; about a minute) writes
``reference.npz`` beside this file.  tests/test_torch_mesh.py,
test_torch_nll_sharded.py, test_torch_toys_sharded.py and
test_torch_chain_sharded.py hold sxmc_tpu_torch against it: the inputs
are made from the seeds below by the functions here, for either package
(``pkg``), and every dataset the JAX package drew is stored, so that the
port reads the same events.  What is stored:

  * ``mesh_*``: ``make_mesh``, ``auto_mesh`` and ``local_mesh`` shapes
    (or -1 where JAX raised) on 1, 2, 4 and 8 devices, and
    ``process_local_experiments`` blocks;
  * ``nll_*``: ``event_sharded_nll`` on an 8-shard ``event`` mesh at 6
    parameter points (the stack of ``test_torch_pdf.make_stack_inputs``,
    ``make_data(nev=NLL_NEV)``);
  * ``bin_*``: ``bin_sharded_histograms`` and ``bin_sharded_eval`` on 8
    shards (37 bins: pad bins), unweighted and weighted;
  * ``toys_*``: 24 toys drawn by the JAX package and its
    ``sharded_toy_dnll`` / ``sharded_pull_batch`` on an 8-shard mesh;
  * ``chain_*``: ``run_sharded_chain``'s posterior moments on 8 shards,
    without and with a floating systematic, and the datasets.
"""

import importlib
import os
import sys

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")

import numpy as np  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(os.path.dirname(HERE)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

# The inputs; the tests read them from here.
NLL_NEV = 1000
NLL_POINTS = np.asarray([
    [1.0, 1.0, 1.0, 0.0, 0.0],
    [0.8, 1.1, 0.9, 0.01, 0.002],
    [1.3, 0.7, 1.2, -0.015, 0.005],
    [0.5, 1.5, 1.0, 0.02, -0.003],
    [1.1, 0.95, 0.6, -0.005, 0.008],
    [-0.1, 1.0, 1.0, 0.0, 0.0],          # a negative rate: the barrier
], np.float32)
BIN_THETAS = [0.0, 0.35]
BIN_WEIGHTED_THETA = 0.1
BIN_EVAL_THETA = 0.2
NTOYS = 24
TOY_R = 0.8
CHAIN_STEPS = 8000
CHAIN_BURNIN = 0.2
MESH_SHAPES = [(1, 1, 1), (2, 1, 1), (1, 2, 1), (1, 1, 2), (2, 2, 1),
               (2, 2, 2), (4, 2, 1), (8, 1, 1), (1, 1, 8), (16, 1, 1),
               (3, 1, 1)]
AUTO = [(1, 1), (3, 1), (4, 2), (8, 1), (5, 3), (2, 8)]
LOCAL_CHAINS = [1, 2, 3, 4, 8]
PLE = [(4, 1), (4, 2), (5, 2), (7, 3), (2, 3)]


def bin_fixture(pkg: str, nbins: int = 37, weighted: bool = False):
    """The JAX test_bin_sharded fixture in ``pkg``: two signals under one
    shift systematic, 37 bins (not divisible by 8)."""
    sig = importlib.import_module(pkg + ".signal")
    rng = np.random.default_rng(21)
    fields = ["energy", "DATASET"]
    obs = sig.Observable(name="energy", field="energy", bins=nbins,
                         lower=0.0, upper=10.0, field_index=0)
    syst = sig.Systematic(name="shift", type=0, observable_field="energy",
                          means=[0.0], sigmas=[0.1],
                          observable_field_index=0, pidx=[0])
    mc1 = rng.normal(5, 1.5, (4000, 1)).astype(np.float32)
    mc2 = rng.uniform(0, 10, (6000, 1)).astype(np.float32)
    s1 = sig.Signal.from_table("sig", "s", mc1, ["energy"], 0,
                               sig.Source(name="s", index=0, mean=1.0),
                               100.0, fields, [obs], [], [syst])
    s2 = sig.Signal.from_table("bkg", "b", mc2, ["energy"], 0,
                               sig.Source(name="b", index=1, mean=1.0),
                               200.0, fields, [obs], [], [syst])
    if weighted:
        s2.histogram.weights = rng.uniform(0.5, 2.0, 6000).astype(
            np.float32)
    return [s1, s2], [obs], [syst]


def bin_eval_data(nev: int = 500):
    rng = np.random.default_rng(3)
    return np.stack([rng.uniform(-1, 11, nev).astype(np.float32),
                     np.where(rng.uniform(size=nev) < 0.1, 9.0,
                              0.0).astype(np.float32)], axis=1)


def toy_model(pkg: str):
    """The JAX test_toys_sharded model: (sources, signals, observables)."""
    sig = importlib.import_module(pkg + ".signal")
    rng = np.random.default_rng(11)
    obs = sig.Observable(name="energy", field="energy", bins=20, lower=5.0,
                         upper=15.0, field_index=0)
    sig_mc = rng.normal(10, 1, (20000, 1)).astype(np.float32)
    bkg_mc = rng.uniform(5, 15, (20000, 1)).astype(np.float32)
    src_s = sig.Source(name="sig", index=0, mean=1.0, sigma=0.0)
    src_b = sig.Source(name="bkg", index=1, mean=1.0, sigma=0.1)
    fields = ["energy", "DATASET"]
    s = sig.Signal.from_table("sig", "S", sig_mc, ["energy"], 0, src_s,
                              150.0, fields, [obs], [], [])
    b = sig.Signal.from_table("bkg", "B", bkg_mc, ["energy"], 0, src_b,
                              400.0, fields, [obs], [], [])
    return [src_s, src_b], [s, b], [obs]


def chain_fixture(pkg: str, with_systematic: bool, seed: int = 5):
    """tests/test_mcmc.py's make_fixture in ``pkg``: (obs, systematics,
    sources, signals)."""
    sig = importlib.import_module(pkg + ".signal")
    rng = np.random.default_rng(seed)
    obs = sig.Observable(name="energy", field="energy", bins=20, lower=5.0,
                         upper=15.0, field_index=0)
    systs = []
    if with_systematic:
        systs = [sig.Systematic(
            name="energy_shift", type=0, observable_field="energy",
            means=[0.0], sigmas=[0.05], observable_field_index=0,
            pidx=[0])]
    fields = ["energy", "DATASET"]
    sig_mc = rng.normal(10, 1, (20000, 1)).astype(np.float32)
    bkg_mc = rng.uniform(5, 15, (20000, 1)).astype(np.float32)
    src_s = sig.Source(name="sig", index=0, mean=1.0, sigma=0.0)
    src_b = sig.Source(name="bkg", index=1, mean=1.0, sigma=0.1)
    s = sig.Signal.from_table("sig", "Signal", sig_mc, ["energy"], 0, src_s,
                              200.0, fields, [obs], [], systs)
    b = sig.Signal.from_table("bkg", "Bkg", bkg_mc, ["energy"], 0, src_b,
                              400.0, fields, [obs], [], [])
    return obs, systs, [src_s, src_b], [s, b]


def main():
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    from sxmc_tpu.generator import make_fake_dataset, make_fake_dataset_batch
    from sxmc_tpu.mcmc.metropolis import MCMC
    from sxmc_tpu.parallel import bin_sharded, chain_sharded, nll_sharded
    from sxmc_tpu.parallel import mesh as mesh_lib
    from sxmc_tpu.parallel import toys_sharded
    from sxmc_tpu.pdf.stack import PdfStack
    from sxmc_tpu.stats.mle import MLE

    from test_torch_pdf import make_data, make_stack_inputs

    assert len(jax.devices()) == 8
    out = {}
    # --- meshes
    for nd in (1, 2, 4, 8):
        devs = jax.devices()[:nd]
        out[f"mesh_make_{nd}"] = np.asarray([
            _shape_or(lambda: mesh_lib.make_mesh(*s, devices=devs), 3)
            for s in MESH_SHAPES])
        out[f"mesh_auto_{nd}"] = np.asarray([
            _shape_or(lambda: mesh_lib.auto_mesh(*a, devices=devs), 3)
            for a in AUTO])
    out["mesh_local_8"] = np.asarray([
        _shape_or(lambda: mesh_lib.local_mesh(c), 2) for c in LOCAL_CHAINS])
    for n, pc in PLE:
        for pi in range(pc):
            out[f"mesh_ple_{n}_{pi}_{pc}"] = np.asarray(
                mesh_lib.process_local_experiments(n, pi, pc), np.int64)

    # --- event-sharded NLL
    mcmc = MCMC(*make_stack_inputs("sxmc_tpu"))
    data = make_data(nev=NLL_NEV)
    rb = mcmc.stack.compute_read_bins(data)
    mesh = mesh_lib.make_mesh(event=8)
    f = nll_sharded.event_sharded_nll(mesh, mcmc.static)
    vals = []
    for p in NLL_POINTS:
        theta = jnp.asarray(p)
        lut, norms = mcmc.stack.evaluate(theta[mcmc.nsources:], rb)
        vals.append(float(f(theta, nll_sharded.shard_lut(mesh, lut), norms)))
    out["nll_values"] = np.asarray(vals, np.float32)

    # --- bin-sharded build and eval
    bmesh = bin_sharded.make_bin_mesh()
    stack = PdfStack(*_stack_args(bin_fixture("sxmc_tpu")))
    for k, tv in enumerate(BIN_THETAS):
        h, n = bin_sharded.bin_sharded_histograms(
            bmesh, stack, jnp.asarray([tv], jnp.float32))
        out[f"bin_hists_{k}"] = np.asarray(h)
        out[f"bin_norms_{k}"] = np.asarray(n)
    wstack = PdfStack(*_stack_args(bin_fixture("sxmc_tpu", weighted=True)))
    h, n = bin_sharded.bin_sharded_histograms(
        bmesh, wstack, jnp.asarray([BIN_WEIGHTED_THETA], jnp.float32))
    out["bin_w_hists"], out["bin_w_norms"] = np.asarray(h), np.asarray(n)
    stack.set_data(bin_eval_data())
    h, n = bin_sharded.bin_sharded_histograms(
        bmesh, stack, jnp.asarray([BIN_EVAL_THETA], jnp.float32))
    out["bin_lut"] = np.asarray(bin_sharded.bin_sharded_eval(
        bmesh, h, n, stack._read_bins, stack.bin_volume))

    # --- sharded toys
    srcs, sigs, obs = toy_model("sxmc_tpu")
    mle = MLE(srcs, sigs, [], obs)
    batch = make_fake_dataset_batch(jax.random.PRNGKey(3), mle.signals, [],
                                    obs, NTOYS, poisson=True,
                                    stack=mle.stack)
    out["toys_batch"] = np.asarray(batch, np.float32)
    trb = np.asarray(mle.stack.compute_read_bins(batch))
    tmesh = mesh_lib.make_mesh(exp=8)
    rv = np.full(NTOYS, TOY_R, np.float32)
    out["toys_dnll"], out["toys_rhat"] = toys_sharded.sharded_toy_dnll(
        tmesh, mle, rv, trb, 0, tuple(mle._free_rates), mle.maxiter)
    out["toys_pull_r"], out["toys_pull_err"] = \
        toys_sharded.sharded_pull_batch(tmesh, mle, trb,
                                        tuple(mle._free_rates), mle.maxiter)

    # --- the event-sharded chain's posterior
    for tag, syst in (("fixed", False), ("syst", True)):
        obs1, systs, srcs, sigs = chain_fixture("sxmc_tpu", syst)
        data = make_fake_dataset(jax.random.PRNGKey(2), sigs, systs, [obs1],
                                 poisson=False)
        mc = MCMC(srcs, sigs, systs, [obs1])
        ls = chain_sharded.run_sharded_chain(
            mc, data, nsteps=CHAIN_STEPS, burnin_fraction=CHAIN_BURNIN,
            seed=12)
        out[f"chain_{tag}_data"] = np.asarray(data, np.float32)
        out[f"chain_{tag}_mean"] = np.asarray(
            [ls.column(n).mean() for n in mc.parameter_names])
        out[f"chain_{tag}_std"] = np.asarray(
            [ls.column(n).std() for n in mc.parameter_names])
    np.savez(os.path.join(HERE, "reference.npz"), **out)
    print("wrote", os.path.join(HERE, "reference.npz"), len(out), "arrays")


def _stack_args(fixture):
    signals, obs, systs = fixture
    return signals, obs, systs


def _shape_or(make, ndim: int):
    """The mesh's axis sizes, or -1s where making it raised ValueError."""
    try:
        m = make()
    except ValueError:
        return [-1] * ndim
    return list(m.devices.shape)


if __name__ == "__main__":
    main()
