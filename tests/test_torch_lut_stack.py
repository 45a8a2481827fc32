"""``PdfStack.evaluate`` / ``evaluate_batch`` (B1, then B2) against the
JAX package's stack on its Pallas path in interpret mode (split from
test_torch_lut.py, whose docstring states the tolerances)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from test_torch_lut import _assert_lut
from test_torch_pdf import make_data, make_stack_inputs
from test_torch_pdf import jax_compiles_unoptimised  # noqa: F401 (autouse)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def split_stacks():
    """The test stack with both systematics (fixed or not, the stack is
    the same: signals a and b dynamic, c static) and one with no
    systematic at all (every row static: B2 is the only kernel)."""
    from sxmc_tpu.pdf.stack import PdfStack as JaxStack, \
        force_pallas_interpret
    from sxmc_tpu_torch.pdf.stack import PdfStack

    out = {}
    for name, keep in (("dyn", True), ("static", False)):
        _, jsig, jsyst, jobs = make_stack_inputs("sxmc_tpu")
        _, tsig, tsyst, tobs = make_stack_inputs("sxmc_tpu_torch")
        if not keep:
            jsyst, tsyst = [], []
        with force_pallas_interpret():
            j = JaxStack(jsig, jobs, jsyst)
        t = PdfStack(tsig, tobs, tsyst, "cpu")
        j.set_data(make_data())
        t.set_data(make_data())
        out[name] = (j, t)
    return out


@pytest.mark.parametrize("name,theta", [("dyn", [0.0, 0.0]),
                                        ("dyn", [0.013, -0.004]),
                                        ("static", [])])
def test_evaluate_matches_pallas_interpret(split_stacks, name, theta):
    j, t = split_stacks[name]
    theta = np.asarray(theta, np.float32)
    jl, jn = j.evaluate(jnp.asarray(theta))
    tl, tn = t.evaluate(torch.as_tensor(theta))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    _assert_lut(tl.numpy(), jl)
    if name == "static":
        assert t._ndyn == 0 and t.hist_spec is None


def test_evaluate_batch_matches_pallas_interpret(split_stacks):
    j, t = split_stacks["dyn"]
    thetas = np.asarray([[0.0, 0.0], [0.011, -0.006], [-0.02, 0.004]],
                        np.float32)
    jl, jn = j.evaluate_batch(jnp.asarray(thetas))
    tl, tn = t.evaluate_batch(torch.as_tensor(thetas))
    assert tl.shape == (3, t.nsignals, make_data().shape[0])
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    _assert_lut(tl.numpy(), jl)
    # Each chain's rows are that chain's single evaluation.
    for c in range(3):
        lut, norms = t.evaluate(torch.as_tensor(thetas[c]))
        assert torch.equal(norms, tn[c])
        _assert_lut(tl[c].numpy(), lut.numpy())
