"""sxmc_tpu_torch.ops.autotune's cache: persisted B1 grid verdicts with
the reference's 10% hysteresis (pdfz.cpp:622-814, 712-719), the cases
of tests/test_autotune_cache.py on the port's key (the JAX key plus the
chain count and the form) and grids (blocks, slots)."""

import os

import pytest
import torch

from sxmc_tpu_torch.ops import autotune

torch.set_num_threads(1)

RULE = (528, 0)  # sx_hist_grid's (blocks, slots) in these cases


@pytest.fixture()
def tmp_cache(tmp_path, monkeypatch):
    p = str(tmp_path / "autotune.json")
    monkeypatch.setenv("SXMC_TPU_TORCH_AUTOTUNE_CACHE", p)
    # Isolate from the shipped verdicts (test_torch_autotune_shipped.py):
    # these tests pin the cache mechanics on a bare environment.
    monkeypatch.setattr(autotune, "shipped_path",
                        lambda: str(tmp_path / "no_shipped.json"))
    return p


def test_default_without_cache(tmp_cache):
    assert autotune.tuned_grid("segmented", 1000, 29, 4_900_000, 1, False,
                               RULE) == RULE


def test_record_and_lookup(tmp_cache):
    res = {(132, 0): 1e-3, (264, 0): 8e-4, (528, 0): 6.5e-4}
    got = autotune.record_tuning("segmented", 1000, 29, 4_900_000, 1, False,
                                 res, heuristic=(264, 0), card_name="card")
    assert got == (528, 0)
    assert os.path.exists(tmp_cache)
    assert autotune.tuned_grid("segmented", 1000, 29, 4_900_000, 1, False,
                               (264, 0)) == (528, 0)
    # Sample counts in the same power-of-two bucket share the verdict.
    assert autotune.tuned_grid("segmented", 1000, 29, 5_000_000, 1, False,
                               (264, 0)) == (528, 0)
    # Another shape, chain count or form: untouched.
    for args in ((1000, 2, 4_900_000, 1, False),
                 (1000, 29, 4_900_000, 8, False),
                 (1000, 29, 4_900_000, 1, True)):
        assert autotune.tuned_grid("segmented", *args, (264, 0)) == (264, 0)


def test_hysteresis_keeps_heuristic(tmp_cache):
    # Best is only 6% better than the heuristic: not recorded over it.
    res = {(132, 0): 1e-3, (264, 8): 8e-4, (528, 0): 7.5e-4}
    assert autotune.record_tuning("x", 10, 1, 100, 1, False, res,
                                  heuristic=(264, 8), card_name="c") is None
    assert autotune.tuned_grid("x", 10, 1, 100, 1, False, (264, 8)) == \
        (264, 8)


def test_corrupt_cache_is_ignored(tmp_cache):
    with open(tmp_cache, "w") as f:
        f.write("{not json")
    assert autotune.load_cache() == {}
    assert autotune.tuned_grid("a", 1, 1, 1, 1, False, (4, 1)) == (4, 1)
