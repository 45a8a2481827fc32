"""Kernels B1/B3/B4: plain versions against the JAX Pallas kernels, and
(on a card) the CUDA kernels B1, B2, B3, B4 (diagonal and tril) and B5,
single, batched and experiment-grouped, against their plain versions.

The JAX side runs as its own CPU tests run it: a PdfStack built under
``force_pallas_interpret`` takes the per-segment Pallas path, kernels
in interpret mode, at a tiny size.  Tolerances:
  * histograms exact (integer counts, the same float32 bin math);
  * NLL |d| <= 1e-3 absolute (XLA's CPU log vs torch's, compensated
    float32 pairs vs float64 sums; far below the 0.5 dNLL intervals
    resolve);
  * segment trajectories: identical accept decisions, parameters within
    1e-6 relative (XLA may contract a proposal into an FMA, an ulp that
    the chain carries along), NLL history within the same 1e-3.

The ``cuda`` cases need an NVIDIA Hopper card and skip elsewhere; run
them there with ``python -m pytest tests/test_torch_kernels.py -m
cuda``.  This module imports jax only inside the JAX-side fixture, so
it also collects where jax is not installed.
"""

import numpy as np
import pytest
import torch

from sxmc_tpu_torch.mcmc.metropolis import MCMC, initial_state
from sxmc_tpu_torch.ops import kernels

from test_torch_pdf import make_data, make_stack_inputs
from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)

# Small shapes: one intra-op thread is as fast, and pytest workers that
# share the cores do not oversubscribe them (with one thread per core
# in every worker these tests ran ten times slower under xdist).
torch.set_num_threads(1)

NLL_TOL = 1e-3  # absolute; see the module docstring
NSTEPS = 12


def _port_mcmc(device, n_mc=3000):
    srcs, sigs, systs, obs = make_stack_inputs("sxmc_tpu_torch", n_mc=n_mc)
    mcmc = MCMC(srcs, sigs, systs, obs, device=device)
    mcmc.stack.set_data(make_data())
    return mcmc


def _streams(npar, n=NSTEPS, seed=17):
    rng = np.random.default_rng(seed)
    noise = rng.normal(0, 1, (n, npar)).astype(np.float32)
    log_u = np.log(rng.uniform(0, 1, n)).astype(np.float32)
    return noise, log_u


THETAS = [[0.0, 0.0], [0.011, -0.006]]
PARAMS = [[1.0, 1.0, 1.0, 0.0, 0.0], [1.2, 0.85, 1.05, 0.011, -0.006],
          [-0.1, 1.0, 1.0, 0.0, 0.0]]


@pytest.fixture(scope="module")
def jax_side():
    pytest.importorskip("jax")
    from sxmc_tpu.mcmc.metropolis import MCMC as JaxMCMC
    from sxmc_tpu.pdf.stack import force_pallas_interpret

    srcs, sigs, systs, obs = make_stack_inputs("sxmc_tpu")
    with force_pallas_interpret():
        mcmc = JaxMCMC(srcs, sigs, systs, obs)
    assert mcmc.stack.supports_fused
    mcmc.stack.set_data(make_data())
    return mcmc


@pytest.fixture(scope="module")
def port():
    return _port_mcmc("cpu")


@pytest.mark.parametrize("theta", THETAS)
def test_plain_histogram_matches_pallas(jax_side, port, theta):
    theta = np.asarray(theta, np.float32)
    jh, jn = jax_side.stack.histograms(theta)
    th, tn = port.stack.histograms(theta)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))


@pytest.mark.parametrize("params", PARAMS)
def test_plain_fused_nll_matches_pallas(jax_side, port, params):
    import jax.numpy as jnp

    p = np.asarray(params, np.float32)
    js = jax_side.stack
    jhi, jlo = js.fused_nll_pair(jnp.asarray(p), js._read_bins,
                                 js.device_data, jax_side.static)
    thi, tlo = port.stack.fused_nll_pair(torch.as_tensor(p),
                                         port.stack.read_bins, port.nll_spec)
    want = float(np.float64(jhi) + np.float64(jlo))
    got = float(thi.double() + tlo.double())
    if params[0] < 0:
        assert float(thi) == float(jhi) == float(np.float32(1e18))
    assert abs(got - want) <= NLL_TOL, (got, want)


def test_plain_segment_matches_pallas(jax_side, port):
    import jax.numpy as jnp
    from sxmc_tpu.mcmc import metropolis as jm

    js = jax_side.stack
    p0, nll0, w0 = jm.initial_state(jax_side, js._read_bins,
                                    js.device_data, allow_fused=True)
    noise, log_u = _streams(port.nparameters)
    js_s, js_n, js_a = js.fused_segment(
        p0, nll0, w0, js._read_bins, js.device_data, jnp.asarray(noise),
        jnp.asarray(log_u), jax_side.static)
    nll0_t = torch.as_tensor(np.asarray([float(nll0[0]), float(nll0[1])],
                                        np.float32))
    t_s, t_n, t_a = port.stack.fused_segment(
        torch.tensor(np.asarray(p0)), nll0_t,
        torch.tensor(np.asarray(w0)), port.stack.read_bins,
        torch.as_tensor(noise), torch.as_tensor(log_u), port.nll_spec)
    np.testing.assert_array_equal(t_a.numpy(), np.asarray(js_a)[:, 0])
    # XLA may contract a proposal's cur + noise * w into an FMA (about
    # an ulp, carried along the chain; tests/test_fused_segment.py
    # allows its own kernel 3e-7); the port never contracts.
    np.testing.assert_allclose(t_s.numpy(), np.asarray(js_s), rtol=1e-6,
                               atol=1e-7)
    got = t_n.double().sum(1).numpy()
    want = np.asarray(js_n, np.float64).sum(1)
    np.testing.assert_allclose(got, want, rtol=0, atol=NLL_TOL)
    assert 0 < t_a.sum() < NSTEPS  # the walk both moved and stayed


def test_plain_debug_segment_accepts_all(port):
    st = port.stack
    params, nll0, width = initial_state(port, st.read_bins)
    noise, log_u = (torch.as_tensor(x) for x in _streams(port.nparameters))
    s, n, a = st.fused_segment(params, torch.stack(nll0), width,
                               st.read_bins, noise, log_u, port.nll_spec,
                               debug_mode=True)
    assert bool((a == 1).all())
    # Every proposal is taken: the walk is cur + noise * width, step by step.
    want = params + torch.cumsum(noise * torch.clamp_min(width, 0.0), 0)
    torch.testing.assert_close(s, want, rtol=1e-5, atol=1e-6)


def test_wrapper_checks_inputs(port):
    st = port.stack
    with pytest.raises(TypeError):
        kernels.fused_nll(st.hist_spec, port.nll_spec,
                          st.samples, st.hist_init, st.read_bins,
                          torch.zeros(port.nparameters, dtype=torch.float64))
    with pytest.raises(ValueError):
        kernels.segmented_histogram(st.hist_spec, st.samples[:, :10],
                                    torch.zeros(2))


# ------------------------------------------------------------ on the card


@pytest.fixture(scope="module")
def cuda_pair():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return _port_mcmc("cuda"), torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("theta", THETAS)
def test_cuda_histogram_equals_plain(cuda_pair, theta):
    mcmc, dev = cuda_pair
    st = mcmc.stack
    th = torch.as_tensor(np.asarray(theta, np.float32), device=dev)
    got, got_norms = kernels.segmented_histogram(st.hist_spec, st.samples,
                                                 th)
    want, want_norms = kernels.segmented_histogram_plain(st.hist_spec,
                                                         st.samples, th)
    assert torch.equal(got, want) and torch.equal(got_norms, want_norms)
    assert torch.equal(got_norms, want.sum(dim=1))


@pytest.mark.cuda
@pytest.mark.parametrize("params", PARAMS)
def test_cuda_fused_nll_matches_plain(cuda_pair, params):
    mcmc, dev = cuda_pair
    st = mcmc.stack
    p = torch.as_tensor(np.asarray(params, np.float32), device=dev)
    hi, lo = kernels.fused_nll(st.hist_spec, mcmc.nll_spec,
                               st.samples, st.hist_init, st.read_bins, p)
    phi, plo = kernels.fused_nll_plain(st.hist_spec,
                                       mcmc.nll_spec,
                                       st.samples, st.hist_init,
                                       st.read_bins, p)
    assert abs(float(hi.double() + lo.double())
               - float(phi.double() + plo.double())) <= NLL_TOL


@pytest.mark.cuda
def test_cuda_segment_matches_plain(cuda_pair):
    mcmc, dev = cuda_pair
    st = mcmc.stack
    params, nll0, width = initial_state(mcmc, st.read_bins)
    noise, log_u = (torch.as_tensor(x, device=dev)
                    for x in _streams(mcmc.nparameters, n=200))
    nll0 = torch.stack(nll0)
    args = (st.hist_spec, mcmc.nll_spec, st.samples,
            st.hist_init, st.read_bins, params, nll0, width, noise, log_u)
    s, n, a = kernels.fused_segment(*args)
    ps, pn, pa = kernels.fused_segment_plain(*args)
    assert torch.equal(a, pa) and torch.equal(s, ps)
    assert (n.double().sum(1) - pn.double().sum(1)).abs().max() <= NLL_TOL


@pytest.mark.cuda
def test_cuda_segment_debug_mode_accepts_all(cuda_pair):
    mcmc, dev = cuda_pair
    st = mcmc.stack
    params, nll0, width = initial_state(mcmc, st.read_bins)
    noise, log_u = (torch.as_tensor(x, device=dev)
                    for x in _streams(mcmc.nparameters, n=50))
    args = (st.hist_spec, mcmc.nll_spec, st.samples,
            st.hist_init, st.read_bins, params, torch.stack(nll0), width,
            noise, log_u)
    s, n, a = kernels.fused_segment(*args, debug_mode=True)
    ps, pn, pa = kernels.fused_segment_plain(*args, debug_mode=True)
    assert bool((a == 1).all()) and torch.equal(a, pa)
    assert torch.equal(s, ps)
    assert (n.double().sum(1) - pn.double().sum(1)).abs().max() <= NLL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("rows", [3, 1])
def test_cuda_lut_eval_equals_plain(cuda_pair, rows):
    mcmc, dev = cuda_pair
    st = mcmc.stack
    hists, norms = st.histograms(torch.as_tensor([0.01, -0.002],
                                                 device=dev))
    rb = st.read_bins[:rows].contiguous()
    got = kernels.lut_eval(hists, norms, rb, st.bin_volume)
    want = kernels.lut_eval_plain(hists, norms, rb, st.bin_volume)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert kernels.launch_counts()["lut_eval"] > 0


@pytest.mark.cuda
def test_cuda_histogram_batched_equals_plain(cuda_pair):
    mcmc, dev = cuda_pair
    st = mcmc.stack
    th = torch.as_tensor(np.asarray(THETAS * 2, np.float32), device=dev)
    got = kernels.segmented_histogram_batched(st.hist_spec, st.samples, th)
    want = kernels.segmented_histogram_plain(st.hist_spec, st.samples, th)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    single = kernels.segmented_histogram(st.hist_spec, st.samples, th[1])
    assert all(torch.equal(g[1], s) for g, s in zip(got, single))


@pytest.mark.cuda
def test_cuda_fused_nll_batched_matches_plain(cuda_pair):
    mcmc, dev = cuda_pair
    st = mcmc.stack
    p = torch.as_tensor(np.asarray(PARAMS, np.float32), device=dev)
    args = (st.hist_spec, mcmc.nll_spec, st.samples,
            st.hist_init, st.read_bins, p)
    hi, lo = kernels.fused_nll_batched(*args)
    phi, plo = kernels.fused_nll_plain(*args)
    assert (hi.double() + lo.double() - phi.double()
            - plo.double()).abs().max() <= NLL_TOL


@pytest.mark.cuda
def test_cuda_segment_batched_matches_plain(cuda_pair):
    mcmc, dev = cuda_pair
    st = mcmc.stack
    nch = 4
    params, nll0, width = initial_state(mcmc, st.read_bins, nchains=nch)
    noise, log_u = _streams(mcmc.nparameters * nch, n=100)
    noise = torch.as_tensor(noise.reshape(100, nch, -1), device=dev)
    log_u = torch.as_tensor(np.log(np.random.default_rng(3).uniform(
        0, 1, (100, nch))).astype(np.float32), device=dev)
    args = (st.hist_spec, mcmc.nll_spec, st.samples,
            st.hist_init, st.read_bins, params,
            torch.stack(nll0, dim=-1), width, noise, log_u)
    s, n, a = kernels.fused_segment_batched(*args)
    ps, pn, pa = kernels.fused_segment_plain(*args)
    assert s.shape == (100, nch, mcmc.nparameters)
    assert torch.equal(a, pa) and torch.equal(s, ps)
    assert (n.double().sum(-1) - pn.double().sum(-1)).abs().max() <= NLL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("nch, nbins", [(kernels.MAXCHAINS, 12), (8, 1000)])
def test_cuda_segment_batched_regimes_match_plain(cuda_pair, nch, nbins):
    """The lock-step rebuild's two regimes: the most chains one launch
    takes (their histograms in the shared-memory replicas), and a
    histogram too large for the replicas (8 chains x 1,000 bins: every
    count a global atomic)."""
    _, dev = cuda_pair
    mcmc = MCMC(*make_stack_inputs("sxmc_tpu_torch", nbins=nbins),
                device=dev)
    mcmc.stack.set_data(make_data())
    st = mcmc.stack
    params, nll0, width, noise, log_u = _chains_inputs(mcmc, nch, 60)
    args = (st.hist_spec, mcmc.nll_spec, st.samples, st.hist_init,
            st.read_bins, params, nll0, width, noise, log_u)
    s, n, a = kernels.fused_segment_batched(*args)
    ps, pn, pa = kernels.fused_segment_plain(*args)
    assert s.shape == (60, nch, mcmc.nparameters)
    assert torch.equal(a, pa) and torch.equal(s, ps)
    assert 0 < float(a.sum()) < a.numel()
    assert (n.double().sum(-1) - pn.double().sum(-1)).abs().max() <= NLL_TOL


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["histogram", "segment", "batched",
                                  "blocked_batched"])
def test_cuda_wide_layout_matches_plain(cuda_pair, form):
    """The binning's general case: two observables and a shift of the
    truth field that both resolutions read (counts bit-exact,
    trajectories identical, |dNLL| <= NLL_TOL)."""
    _, dev = cuda_pair
    mcmc = MCMC(*make_stack_inputs("sxmc_tpu_torch", wide=True),
                device=dev)
    mcmc.stack.set_data(make_data(wide=True))
    st = mcmc.stack
    hs = st.hist_spec
    assert hs.nobs == 2 and hs.nload == 3
    if form == "histogram":
        th = torch.as_tensor(np.asarray(
            [[0.0, 0.0, 0.0, 0.0], [0.004, 0.7, 0.013, -0.004],
             [-0.02, -1.3, -0.05, 0.02]], np.float32), device=dev)
        got = kernels.segmented_histogram_batched(hs, st.samples, th)
        want = kernels.segmented_histogram_plain(hs, st.samples, th)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        single = kernels.segmented_histogram(hs, st.samples, th[1])
        assert all(torch.equal(g[1], s) for g, s in zip(got, single))
        return
    nch = 1 if form == "segment" else 8
    sub = (4,) if form == "blocked_batched" else ()
    params, nll0, width, noise, log_u = _chains_inputs(mcmc, nch, 60,
                                                       sub=sub)
    args = (hs, mcmc.nll_spec, st.samples, st.hist_init, st.read_bins,
            params, nll0, width, noise, log_u)
    name = {"segment": "fused_segment", "batched": "fused_segment_batched",
            "blocked_batched": "blocked_segment_batched"}[form]
    s, n, a = getattr(kernels, name)(*args)
    plain = (kernels.blocked_segment_plain if sub
             else kernels.fused_segment_plain)
    ps, pn, pa = plain(*args)
    assert torch.equal(a, pa) and torch.equal(s, ps)
    assert 0 < float(a.sum()) < a.numel()
    assert (n.double().sum(-1) - pn.double().sum(-1)).abs().max() <= NLL_TOL


def _chains_inputs(mcmc, nch, n, sub=()):
    """A chain start for 1 or nch chains and streams of n steps (with
    the blocked ``(M + 1,)`` axis ``sub``) on the card."""
    dev = mcmc.device
    params, nll0, width = initial_state(mcmc, mcmc.stack.read_bins,
                                        nchains=nch)
    lead = (nch,) if nch > 1 else ()
    rng = np.random.default_rng(29 + nch)
    noise = torch.as_tensor(rng.normal(0, 1, (n,) + sub + lead + (
        mcmc.nparameters,)).astype(np.float32), device=dev)
    log_u = torch.as_tensor(np.log(rng.uniform(0, 1, (n,) + sub + lead))
                            .astype(np.float32), device=dev)
    return params, torch.stack(nll0, dim=-1), width, noise, log_u


@pytest.mark.cuda
@pytest.mark.parametrize("nch", [1, 4])
def test_cuda_segment_tril_matches_plain(cuda_pair, nch):
    mcmc, dev = cuda_pair
    st = mcmc.stack
    params, nll0, width, noise, log_u = _chains_inputs(mcmc, nch, 100)
    # Correlated scales with a zero row: source c stays pinned.
    low = torch.tril(torch.full(width.shape[-1:] * 2, 0.3, device=dev), -1)
    tril = torch.diag_embed(width.clamp_min(0)) + low * width.clamp_min(
        0)[..., :, None]
    tril[..., 2, :] = 0.0
    tril = tril.contiguous()
    args = (st.hist_spec, mcmc.nll_spec, st.samples, st.hist_init,
            st.read_bins, params, nll0, tril, noise, log_u)
    name = "fused_segment_tril_batched" if nch > 1 else "fused_segment_tril"
    kern = getattr(kernels, name)
    before = kernels.launch_counts()[name]
    s, n, a = kern(*args)
    ps, pn, pa = kernels.fused_segment_plain(*args)
    assert kernels.launch_counts()[name] == before + 1
    assert torch.equal(a, pa) and torch.equal(s, ps)
    assert (n.double().sum(-1) - pn.double().sum(-1)).abs().max() <= NLL_TOL
    assert 0 < float(a.sum()) < a.numel()
    assert bool((s[..., 2] == params[..., 2]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("nch", [1, 4])
def test_cuda_blocked_segment_matches_plain(cuda_pair, nch):
    mcmc, dev = cuda_pair
    st = mcmc.stack
    params, nll0, width, noise, log_u = _chains_inputs(mcmc, nch, 60,
                                                       sub=(4,))
    args = (st.hist_spec, mcmc.nll_spec, st.samples, st.hist_init,
            st.read_bins, params, nll0, width, noise, log_u)
    name = "blocked_segment_batched" if nch > 1 else "blocked_segment"
    kern = getattr(kernels, name)
    before = kernels.launch_counts()[name]
    s, n, a = kern(*args)
    ps, pn, pa = kernels.blocked_segment_plain(*args)
    assert kernels.launch_counts()[name] == before + 1
    assert a.shape == ((60, nch) if nch > 1 else (60,))
    assert torch.equal(a, pa) and torch.equal(s, ps)
    assert (n.double().sum(-1) - pn.double().sum(-1)).abs().max() <= NLL_TOL
    assert 0 < float(a.sum()) < a.numel()
    # Debug mode takes every one of the M + 1 moves.
    s, n, a = kern(*args, debug_mode=True)
    ps, pn, pa = kernels.blocked_segment_plain(*args, debug_mode=True)
    assert bool((a == 1).all()) and torch.equal(s, ps)


@pytest.fixture(scope="module")
def cuda_weighted(cuda_pair):
    """The card fixture's fit with every signal weighted (log-normal,
    sigma 0.3): the weighted forms of B1, B3 and B4."""
    mcmc, dev = cuda_pair
    srcs, sigs, systs, obs = make_stack_inputs("sxmc_tpu_torch")
    rng = np.random.default_rng(8)
    for sig in sigs:
        sig.histogram.weights = rng.lognormal(0, 0.3, sig.n_mc).astype(
            np.float32)
    wm = MCMC(srcs, sigs, systs, obs, device=dev)
    wm.stack.set_data(make_data())
    assert wm.stack.hist_spec.weighted
    return wm, dev


def _within_ties(got, want):
    """Float64 weight sums rounded once: equal but on a rounding tie,
    where the two float32 values are an ulp apart."""
    ulp = torch.abs(torch.nextafter(want, torch.full_like(want, np.inf))
                    - want)
    return bool((torch.abs(got - want) <= ulp).all())


@pytest.mark.cuda
def test_cuda_weighted_histograms_equal_plain(cuda_weighted):
    mcmc, dev = cuda_weighted
    st = mcmc.stack
    th = torch.as_tensor(np.asarray(THETAS * 2, np.float32), device=dev)
    for name, theta in (("segmented_histogram", th[1]),
                        ("segmented_histogram_batched", th)):
        before = kernels.launch_counts()[name + "_weighted"]
        got = getattr(kernels, name)(st.hist_spec, st.samples, theta)
        want = kernels.segmented_histogram_plain(st.hist_spec, st.samples,
                                                 theta)
        assert kernels.launch_counts()[name + "_weighted"] == before + 1
        assert all(_within_ties(g, w) for g, w in zip(got, want))


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["batched", "tril", "tempered"])
def test_cuda_weighted_and_tempered_segments_match_plain(cuda_pair,
                                                         cuda_weighted,
                                                         form):
    """B4's weighted forms (4 chains: diagonal, tril, tempered) and its
    unweighted tempered form against their plain versions."""
    for mcmc, dev in (cuda_weighted, cuda_pair)[:2 if form == "tempered"
                                                else 1]:
        st = mcmc.stack
        params, nll0, width, noise, log_u = _chains_inputs(mcmc, 4, 100)
        beta = None
        if form == "tril":
            width = torch.diag_embed(width.clamp_min(0)).contiguous()
        if form == "tempered":
            beta = torch.as_tensor([1.0, 0.5, 0.25, 0.125], device=dev)
            width = width / torch.sqrt(beta)[:, None]
        name = {"batched": "fused_segment_batched",
                "tril": "fused_segment_tril_batched",
                "tempered": "fused_segment_tempered"}[form]
        args = (st.hist_spec, mcmc.nll_spec, st.samples, st.hist_init,
                st.read_bins, params, nll0, width)
        tail = (noise, log_u)
        got = (getattr(kernels, name)(*args, beta, *tail) if beta is not None
               else getattr(kernels, name)(*args, *tail))
        ps, pn, pa = kernels.fused_segment_plain(*args, *tail, beta=beta)
        s, n, a = got
        assert torch.equal(a, pa) and torch.equal(s, ps)
        assert (n.double().sum(-1) - pn.double().sum(-1)).abs().max() \
            <= NLL_TOL


def _grouped_inputs(mcmc, nexp, cpe, n, sub=(), tril=False):
    """Experiment-grouped inputs on the card: the read bins of nexp
    datasets of different sizes, padded ``(nexp, nsig, nev)``, and a
    start and streams of n steps (with the blocked ``(M + 1,)`` axis
    ``sub``) for nexp * cpe chains around the means."""
    from sxmc_tpu_torch.parallel.ensemble import pad_datasets

    dev = mcmc.device
    nch = nexp * cpe
    rb = mcmc.stack.compute_read_bins(pad_datasets(
        [make_data(seed=40 + e, nev=400 - 37 * e) for e in range(nexp)]))
    # Every chain at the means with its experiment's NLL (B3 per
    # experiment: a batch may exceed B3-batched's caps).
    params, _, width = initial_state(mcmc, rb[0])
    params, width = (x.expand(nch, -1).contiguous() for x in (params, width))
    nll0 = torch.stack([torch.stack(initial_state(mcmc, rb[e])[1])
                        for e in range(nexp) for _ in range(cpe)])
    rng = np.random.default_rng(31)
    noise = torch.as_tensor(rng.normal(0, 1, (n,) + sub + (
        nch, mcmc.nparameters)).astype(np.float32), device=dev)
    log_u = torch.as_tensor(np.log(rng.uniform(0, 1, (n,) + sub + (nch,)))
                            .astype(np.float32), device=dev)
    if tril:
        w = width.clamp_min(0)
        low = torch.tril(torch.full(w.shape[-1:] * 2, 0.2, device=dev), -1)
        width = (torch.diag_embed(w) + low * w[..., :, None]).contiguous()
    return rb, params, nll0, width, noise, log_u


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["diagonal", "tril", "weighted", "blocked"])
def test_cuda_grouped_segments_match_plain(cuda_pair, cuda_weighted, form):
    """The experiment-grouped forms of B4 (diagonal, tril, weighted) and
    B5, 3 experiments x 2 chains, against their plain versions; and each
    experiment's chains decide as the batched form on its read bins."""
    mcmc, dev = cuda_weighted if form == "weighted" else cuda_pair
    st = mcmc.stack
    blocked = form == "blocked"
    rb, params, nll0, width, noise, log_u = _grouped_inputs(
        mcmc, 3, 2, 80, sub=(3,) if blocked else (), tril=form == "tril")
    name = {"diagonal": "fused_segment_grouped",
            "tril": "fused_segment_tril_grouped",
            "weighted": "fused_segment_grouped",
            "blocked": "blocked_segment_grouped"}[form]
    counted = name + ("_weighted" if form == "weighted" else "")
    args = (st.hist_spec, mcmc.nll_spec, st.samples, st.hist_init, rb,
            params, nll0, width, noise, log_u)
    before = kernels.launch_counts()[counted]
    s, n, a = getattr(kernels, name)(*args)
    plain = (kernels.blocked_segment_grouped_plain if blocked
             else kernels.fused_segment_grouped_plain)
    ps, pn, pa = plain(*args)
    assert kernels.launch_counts()[counted] == before + 1
    assert torch.equal(a, pa) and torch.equal(s, ps)
    assert (n.double().sum(-1) - pn.double().sum(-1)).abs().max() <= NLL_TOL
    assert 0 < float(a.sum()) < a.numel()
    batched = getattr(kernels, {"tril": "fused_segment_tril_batched",
                                "blocked": "blocked_segment_batched"}.get(
        form, "fused_segment_batched"))
    ax = 2 if blocked else 1
    for e in range(3):
        c = slice(2 * e, 2 * e + 2)

        def part(t, dim=0):
            return t.narrow(dim, 2 * e, 2).contiguous()

        bs, _, ba = batched(st.hist_spec, mcmc.nll_spec, st.samples,
                            st.hist_init, rb[e], part(params), part(nll0),
                            part(width), part(noise, ax), part(log_u, ax))
        assert torch.equal(ba, a[:, c]) and torch.equal(bs, s[:, c])


@pytest.mark.cuda
def test_cuda_grouped_batch_splits_into_launches(cuda_pair):
    """5 experiments x 8 chains exceed one launch's 32 chains: two
    launches of whole experiments (4, then 1), equal to the plain
    version."""
    mcmc, dev = cuda_pair
    st = mcmc.stack
    rb, params, nll0, width, noise, log_u = _grouped_inputs(mcmc, 5, 8, 40)
    args = (st.hist_spec, mcmc.nll_spec, st.samples, st.hist_init, rb,
            params, nll0, width, noise, log_u)
    before = kernels.launch_counts()["fused_segment_grouped"]
    s, n, a = kernels.fused_segment_grouped(*args)
    ps, pn, pa = kernels.fused_segment_grouped_plain(*args)
    assert kernels.launch_counts()["fused_segment_grouped"] == before + 2
    assert s.shape == (40, 40, mcmc.nparameters)
    assert torch.equal(a, pa) and torch.equal(s, ps)
    assert (n.double().sum(-1) - pn.double().sum(-1)).abs().max() <= NLL_TOL
