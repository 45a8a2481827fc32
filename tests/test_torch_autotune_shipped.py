"""The shipped B1 verdicts (sxmc_tpu_torch/data/autotune_h100.json): the
cases of tests/test_autotune_shipped.py against the H100 file.  The file
is ``python -m sxmc_tpu_torch.ops.autotune --record``'s output on an
H100 (its header names the card and the power limit); it must exist,
load under the user cache and drive ``tuned_grid`` for the recorded
shapes."""

import json
import os

import torch

from sxmc_tpu_torch.ops import autotune

torch.set_num_threads(1)


def _shipped():
    with open(autotune.shipped_path()) as f:
        return json.load(f)


def test_shipped_file_exists_and_is_wellformed():
    p = autotune.shipped_path()
    assert os.path.exists(p), (
        "sxmc_tpu_torch/data/autotune_h100.json missing: run `python -m "
        "sxmc_tpu_torch.ops.autotune --record` on an H100 and commit it")
    shipped = _shipped()
    assert "H100" in shipped["card"] and shipped["card"].endswith(" W")
    assert shipped["verdicts"], "shipped cache is empty"
    for key, rec in shipped["verdicts"].items():
        kind, total_nbins, nseg, bucket, nch, form = key.split(":")
        assert kind in ("global", "segmented"), key
        assert (kind == "global") == (nseg == "1"), key
        assert int(total_nbins) > 0 and int(nseg) > 0 and int(nch) >= 1
        assert int(bucket) & (int(bucket) - 1) == 0 and form in ("u", "w")
        assert rec["blocks"] >= 1, (key, rec)
        assert rec["slots"] == 0 or rec["slots"] & (rec["slots"] - 1) == 0
        # Every verdict records the measurements that justified it.
        assert rec["seconds"] > 0 and rec["heuristic_seconds"] > 0, rec
        if (rec["blocks"], rec["slots"]) != (rec["heuristic_blocks"],
                                             rec["heuristic_slots"]):
            assert rec["seconds"] <= 0.9 * rec["heuristic_seconds"], rec


def test_load_cache_surfaces_shipped(monkeypatch, tmp_path):
    monkeypatch.setenv(autotune._CACHE_ENV,
                       str(tmp_path / "nonexistent.json"))
    cache = autotune.load_cache()
    for k, v in _shipped()["verdicts"].items():
        assert cache[k] == v


def test_tuned_grid_uses_shipped_bench_shape(monkeypatch, tmp_path):
    """The 29-segment bench shape and the reference example's layout
    resolve to their recorded grids (not the bare heuristic marker)."""
    monkeypatch.setenv(autotune._CACHE_ENV,
                       str(tmp_path / "nonexistent.json"))
    verdicts = _shipped()["verdicts"]
    for key in ("segmented:1000:29:4194304:1:u", "segmented:10:2:524288:1:u",
                "segmented:10:2:524288:8:u", "global:1000:1:524288:1:u"):
        kind, total, nseg, bucket, nch, form = key.split(":")
        got = autotune.tuned_grid(kind, int(total), int(nseg), int(bucket),
                                  int(nch), form == "w", (-1, -1))
        assert got == (verdicts[key]["blocks"], verdicts[key]["slots"])


def test_user_cache_overrides_shipped(monkeypatch, tmp_path):
    user = tmp_path / "user.json"
    key = sorted(_shipped()["verdicts"])[0]
    user.write_text(json.dumps({"card": "another card", "verdicts": {
        key: {"blocks": 7, "slots": 2}}}))
    monkeypatch.setenv(autotune._CACHE_ENV, str(user))
    assert autotune.load_cache()[key] == {"blocks": 7, "slots": 2}
