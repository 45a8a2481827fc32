"""The benchmark's own checks on the CPU: what it imports, its manifest,
and its plain reference and roofline arithmetic on cases worked by hand.

    python -m pytest benchmark/ -q
"""

import ast
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from benchmark import reference, roofline

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "sxmc_tpu"}
PROGRAM = "sxmc_tpu_torch"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def top_level_imports(path: Path):
    """The top-level name (before the first dot) of every absolute
    import in ``path``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def modules():
    return sorted(BENCH.rglob("*.py"))


def test_no_module_imports_jax_or_the_jax_package():
    assert modules()
    for path in modules():
        bad = top_level_imports(path) & FORBIDDEN
        assert not bad, f"{path} imports {bad}"


def test_top_level_names_compare_whole(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import sxmc_tpu_torch.ops\nfrom sxmc_tpu.x import y\n"
                 "import jaxlib as j\n")
    assert top_level_imports(f) & FORBIDDEN == {"sxmc_tpu", "jaxlib"}
    assert PROGRAM in top_level_imports(f)


@pytest.mark.parametrize("name", ["reference.py", "compare.py",
                                  "roofline.py", "tables.py", "trace.py"])
def test_reference_side_imports_nothing_of_the_program(name):
    assert PROGRAM not in top_level_imports(BENCH / name)


def test_manifest_keeps_the_contract():
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["benchmark"]
    assert 1 <= man["run_seconds"] <= 51
    cells = {w["name"]: w for w in man["workloads"]}
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [c["name"] for c in man["configs"]] + list(cells) + list(e2e) \
        + [m["name"] for m in man["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in man["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert c["file"].startswith("benchmark/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert "assumed" in cfg and cfg["source"] == c["source"]
    for w in cells.values():
        assert w["chips"] == 1 and len(w["why"]) <= 200
        traffic = json.loads(
            (BENCH / "workloads" / f"{w['traffic']}.json").read_text())
        assert (BENCH / "loops" / f"{traffic['loop']}.py").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()
    for m in man["end_to_end"]:
        assert UNIT.match(m["unit"]) and 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in man["per_layer"]:
        assert UNIT.match(m["unit"])
        assert (BENCH / "metrics" / f"{m['name']}.py").is_file()
        assert m["moves"] in e2e
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
    for w in cells:
        reported = [m for m in man["end_to_end"]
                    if w in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(w in m["workloads"] for m in man["per_layer"])


GOLDEN = {
    "fit": {"nsteps": 100, "burnin_fraction": 0.2, "signal_name": "a",
            "signals": ["a"], "observables": ["x"], "cuts": []},
    "pdfs": {"observables": {"x": {"field": "x", "bins": 2, "min": 0.0,
                                   "max": 1.0}},
             "systematics": {"s": {"type": "shift", "observable_field": "x",
                                   "mean": [0.0], "sigma": [0.1]}}},
    "signals": {"a": {"dataset": 0, "systematics": ["s"], "rate": 10.0}},
}


def golden_model(dtype=torch.float32):
    lay = reference.Layout(GOLDEN)
    rows = torch.tensor([[0.1], [0.2], [0.3], [0.4], [0.5], [1.1], [-0.1]])
    return reference.Model(lay, {"a": (rows, ["x"])}, "cpu", dtype)


def test_reference_histogram_and_nll_by_hand():
    m = golden_model()
    counts, norm = m.histogram(0, [1.0, 0.0])
    assert counts.tolist() == [4.0, 1.0] and norm == 5.0
    # Shifted by 0.55: 0.65 0.75 0.85 0.95 in bin 1, -0.1 to 0.45 in bin 0.
    counts, norm = m.histogram(0, [1.0, 0.55])
    assert counts.tolist() == [1.0, 4.0] and norm == 5.0
    ev = m.events(np.array([[0.25, 0.0], [0.75, 0.0], [2.0, 0.0],
                            [0.25, 1.0]], np.float32))
    # Densities 1.6 and 0.4 (out of domain and other tags add nothing);
    # w = rate * nexpected * norm / n_mc = 1 * 10 * 5 / 7.
    w = 10.0 * 5.0 / 7.0
    want = -(np.log(w * 1.6) + np.log(w * 0.4)) + w
    assert m.nll([1.0, 0.0], ev) == pytest.approx(want, rel=1e-12)
    assert m.nll([-1.0, 0.0], ev) == reference.BARRIER
    lo = golden_model(torch.bfloat16)
    assert lo.nll([1.0, 0.0], ev) == pytest.approx(want, rel=1e-2)


def test_reference_initial_widths_and_retune():
    lay = reference.Layout(GOLDEN)
    sf = 2.4 ** 2 / 2
    w = lay.initial_widths()
    assert w[0] == pytest.approx(0.1 * np.sqrt(10.0) / 10.0 * sf)
    assert w[1] == pytest.approx(0.1 * 0.1 * sf)
    x = np.array([[1.0, 0.0], [3.0, 0.0]])
    new = reference.retune(w, x, lay.fixed, lay.nfloat)
    assert new[0] == pytest.approx(sf * 1.0) and new[1] == w[1]
    assert reference.contour_upper(np.array([1.0, 2.0, 3.0]),
                                   np.array([0.0, 0.4, 0.6]), 0.683) == 2.0


def test_roofline_counts_by_hand():
    m = golden_model()
    byts, flops = roofline.step_work(m, [4], nchains=2)
    # 7 rows x 1 field, 4 events x (x, tag), 2 chains x 2 bins written.
    assert byts == 4.0 * (7 + 4 * 2 + 2 * 2)
    # Per row and chain: shift 1 + binning 5 + count 1; per event 3 + 2.
    assert flops == 2 * (7 * 7) + 2 * 4 * 5
    assert roofline.least_seconds(3.35e12, 1.0) == pytest.approx(1.0)
