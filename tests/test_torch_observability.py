"""Trace plots and the profiler context of the port's observability
layer: ``python -m sxmc_tpu_torch.time_plot`` (the JAX package's
``time_plot``, reference bin/time_plot) on a saved likelihood space,
``observability.plot_traces``, and ``observability.profile`` (a Chrome
trace of a block, nothing without a directory).  ``--profile`` through
the CLI: ``test_torch_plots.py``."""

import json

import numpy as np
import torch

from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)

torch.set_num_threads(1)


def test_time_plot_and_plot_traces(tmp_path, capsys):
    """``python -m sxmc_tpu_torch.time_plot lspace outdir [params]``: a
    panel per parameter and the NLL, from a saved likelihood space."""
    from sxmc_tpu_torch import time_plot
    from sxmc_tpu_torch.observability import plot_traces
    from sxmc_tpu_torch.stats.likelihood import LikelihoodSpace

    rng = np.random.default_rng(5)
    samples = rng.normal(1.0, 0.1, (200, 3)).astype(np.float32)
    ls = LikelihoodSpace.from_arrays(samples, rng.normal(0.0, 1.0, 200),
                                     ["signal1", "signal2", "scale_0"])
    lspace = tmp_path / "fit_0.npz"
    ls.save(str(lspace))
    assert time_plot.main([str(lspace), str(tmp_path / "traces")]) == 0
    png = tmp_path / "traces" / "traces.png"
    assert png.stat().st_size > 0
    assert f"time_plot: wrote {png}" in capsys.readouterr().out
    one = plot_traces(LikelihoodSpace.load(str(lspace)),
                      str(tmp_path / "traces"), names=["signal1"],
                      suffix="_signal1")
    assert one.endswith("traces_signal1.png")


def test_profile_context(tmp_path):
    """``observability.profile``: nothing without a directory; a Chrome
    trace of the block with one (CPU activity here)."""
    from sxmc_tpu_torch.observability import profile

    with profile(None) as prof:
        assert prof is None
    with profile(str(tmp_path / "p")):
        torch.ones(8).sum()
    (trace,) = (tmp_path / "p").glob("trace_*.json")
    assert json.loads(trace.read_text())["traceEvents"]
