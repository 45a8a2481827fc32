"""sxmc_tpu_torch — the PyTorch/CUDA port of sxmc_tpu.

Unbinned maximum-likelihood signal extraction with binned PDFs built
from Monte-Carlo samples, on-the-fly systematics and adaptive
Metropolis, running on NVIDIA Hopper cards through hand-written CUDA
kernels (``csrc/``), or on the CPU through their plain PyTorch
versions.  The JAX package ``sxmc_tpu`` beside it is the reference;
this package imports no jax.

Entry points: ``python -m sxmc_tpu_torch.cli config.json out/`` (with
``--sharded``, or ``--num-processes N`` for an ensemble spread over
processes), ``python -m sxmc_tpu_torch.ops.autotune``, and the library.
"""

__version__ = "0.1.0"

from sxmc_tpu_torch.pdf.evalhist import EvalHist, PdfError  # noqa: F401
from sxmc_tpu_torch.utils import ConfigError, FitError  # noqa: F401
