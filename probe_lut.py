"""Probe of kernel B2 (the LUT gather) and its host path on one H100.

    python3 probe_lut.py [--json PATH]

from the root of a checkout, on a machine with one Hopper card.  It
builds ``probe_lut.cu`` (variants of B2's body) into ``build/probe_lut/``
and the package's kernels, and prints one JSON line a section:

  * ``variants``: at 16 table rows on 2 read-bin rows x 1,464 events x
    10 bins, 2 x 1M events x 1,000 bins and 16 rows on 2 x 1M x 1,000,
    each body of ``probe_lut.cu`` (a staged table row-major, the L1
    form, a bin-major staged table, and a stream that stores the read
    bins with no lookup), with plain and streaming stores, each block
    writing one table row or every row that shares its read-bin row:
    card ms (torch.profiler) on the best of a few grids, each output
    checked bit for bit against ``lut_eval_plain`` (but the stream's);
  * ``grid``: the package's B2 (``kernels.LutPlan``) at 1, 2, 3, 4, 6
    and 8 blocks an SM at those shapes and the example's (2 x 1,464 x
    10): card ms and the grid;
  * ``host``: microseconds a call back to back (the host clock, medians
    of three rounds, in turns) of the plan's call, ``torch.gather`` over
    the same table, ``torch.empty`` of the output, ``empty_like`` of a
    one-element tensor expanded to it, the stream read by
    ``torch.cuda.current_stream(dev).cuda_stream`` and by
    ``torch._C._cuda_getCurrentRawStream``, and an empty kernel launched
    in a C loop by the runtime and by ``cuLaunchKernel``.

The port launches the plan's form and grid; this script only measures.
Compare numbers only within one call: the card and its power limit are
printed beside them.
"""

import argparse
import ctypes
import json
import os
import statistics
import subprocess
import sys
import time

import chip_smoke as cs

HERE = os.path.dirname(os.path.abspath(__file__))
MODES = {"rows": 0, "l1": 1, "bins": 2, "stream": 3}
# (table rows, read-bin rows, events, bins)
SHAPES = [(2, 2, 1464, 10), (16, 2, 1464, 10), (2, 2, 1_000_000, 1000),
          (16, 2, 1_000_000, 1000)]


class ProbePlan(ctypes.Structure):
    _fields_ = [("rb", ctypes.c_void_p), ("nev", ctypes.c_longlong),
                ("rows", ctypes.c_int), ("k", ctypes.c_int),
                ("group", ctypes.c_int), ("total", ctypes.c_int),
                ("bin_volume", ctypes.c_float)]


def build(kernels) -> ctypes.CDLL:
    out = os.path.join(HERE, "build", "probe_lut")
    os.makedirs(out, exist_ok=True)
    lib = os.path.join(out, "libprobe_lut.so")
    cmd = [kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
           "-shared", "-o", lib, os.path.join(HERE, "probe_lut.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode:
        cs.fail(f"nvcc failed:\n{proc.stdout}{proc.stderr}")
    dll = ctypes.CDLL(lib)
    P, I = ctypes.c_void_p, ctypes.c_int
    dll.probe_launch.argtypes = [I, I, I, I, P, P, P, P, P]
    dll.probe_occupancy.argtypes = [I, I, I, I, P]
    dll.probe_launch_loop.argtypes = [I, I, P]
    cs.check(dll.probe_plan_size() == ctypes.sizeof(ProbePlan),
             "ProbePlan differs between C and Python")
    return dll


def inputs(torch, nseg, rows, nev, total, seed=9):
    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(seed)
    counts = torch.randint(0, 5000, (nseg, total), generator=gen,
                           device=dev).to(torch.float32)
    rb = torch.randint(-2, total, (rows, nev), generator=gen, device=dev,
                       dtype=torch.int32)
    return counts, counts.sum(dim=1), rb


def variants(torch, kernels, dll, stream) -> dict:
    nsm = torch.cuda.get_device_properties(0).multi_processor_count
    out = {}
    for nseg, rows, nev, total in SHAPES[1:]:
        counts, norms, rb = inputs(torch, nseg, rows, nev, total)
        want = kernels.lut_eval_plain(counts, norms, rb, 0.01)
        buf = torch.empty_like(want)
        k = nseg // rows
        res = {}
        for name, mode in MODES.items():
            for cs_ in (0, 1):
                for group in sorted({1, k}):
                    plan = ProbePlan(rb.data_ptr(), nev, rows, k, group,
                                     total, 0.01)
                    gy = rows * -(-k // group)
                    occ = ctypes.c_int(0)
                    dll.probe_occupancy(mode, cs_, group, total,
                                        ctypes.byref(occ))
                    tiles = -(-(nev // 4) // 512)
                    grids = {max(1, min(tiles, -(-nsm * b // gy)))
                             for b in (1, 2, 4) if b <= occ.value}
                    best = None
                    for gx in sorted(grids | {tiles}):
                        def launch(gx=gx, plan=plan, mode=mode, cs_=cs_):
                            return dll.probe_launch(
                                mode, cs_, gx, gy, ctypes.byref(plan),
                                counts.data_ptr(), norms.data_ptr(),
                                buf.data_ptr(), stream)
                        cs.check(launch() == 0, f"probe {name} launch")
                        torch.cuda.synchronize()
                        if name != "stream":
                            cs.lut_equal(torch, buf, want)
                        ms = cs.device_ms(torch, launch, 30, ("probe_lut",))
                        if best is None or ms < best[0]:
                            best = (ms, gx)
                    key = (f"{name}, {'streaming' if cs_ else 'plain'} "
                           f"stores, {group} row(s) a block")
                    res[key] = {"card_ms": best[0], "grid": [best[1], gy]}
        out[f"{nseg} x {nev} x {total}"] = res
        del want, buf
    return out


def grid(torch, kernels) -> dict:
    out = {}
    for nseg, rows, nev, total in SHAPES:
        counts, norms, rb = inputs(torch, nseg, rows, nev, total)
        want = kernels.lut_eval_plain(counts, norms, rb, 0.01)
        res = {}
        for bps in (1, 2, 3, 4, 6, 8):
            plan = kernels.LutPlan(rb, 0.01, blocks_per_sm=bps)
            cs.lut_equal(torch, plan(counts, norms), want)
            res[bps] = {"card_ms": cs.device_ms(
                torch, lambda plan=plan: plan(counts, norms), 50,
                ("sx_eval_lut_kernel",)),
                "grid": plan.form(nseg, total)["grid"]}
        out[f"{nseg} x {nev} x {total}"] = res
    return out


def host(torch, kernels, dll) -> dict:
    dev = torch.device("cuda")
    counts, norms, rb = inputs(torch, *SHAPES[0])
    plan = kernels.LutPlan(rb, 0.01)
    idx = rb.clamp(0, 9).to(torch.int64)
    like = torch.empty(1, device=dev).expand(2, rb.shape[1])
    raw = torch._C._cuda_getCurrentRawStream
    stream = raw(0)
    calls = {
        "plan call": lambda: plan(counts, norms),
        "torch.gather": lambda: torch.gather(counts, 1, idx),
        "torch.empty": lambda: torch.empty((2, rb.shape[1]),
                                           dtype=torch.float32, device=dev),
        "empty_like of the expanded template": lambda: torch.empty_like(
            like),
        "torch.cuda.current_stream(dev).cuda_stream":
            lambda: torch.cuda.current_stream(dev).cuda_stream,
        "torch._C._cuda_getCurrentRawStream": lambda: raw(0),
    }

    def per_call(fn, reps=3000):
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        t = (time.perf_counter() - t0) / reps * 1e6
        torch.cuda.synchronize()
        return t

    def loop(driver, n=5000):
        dll.probe_launch_loop(100, driver, stream)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        cs.check(dll.probe_launch_loop(n, driver, stream) == 0,
                 "launch loop failed")
        t = (time.perf_counter() - t0) / n * 1e6
        torch.cuda.synchronize()
        return t

    runs = {}
    order = list(calls) + list(calls)[::-1]
    for _ in range(3):
        for name in order:
            runs.setdefault(name, []).append(per_call(calls[name]))
        for name, driver in (("empty kernel, runtime launch", 0),
                             ("empty kernel, cuLaunchKernel", 1)):
            runs.setdefault(name, []).append(loop(driver))
    return {name: statistics.median(v) for name, v in runs.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--json", help="also write the sections to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        cs.fail("torch.cuda.is_available() is False")
    from sxmc_tpu_torch.ops import kernels

    smi = cs.run(["nvidia-smi", "--query-gpu=name,power.limit",
                  "--format=csv,noheader"])
    kernels.build()
    dll = build(kernels)
    stream = torch._C._cuda_getCurrentRawStream(0)
    out = {"variants": variants(torch, kernels, dll, stream),
           "grid": grid(torch, kernels),
           "host": host(torch, kernels, dll)}
    for name, sec in out.items():
        print(json.dumps({name: sec, "card": smi}), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(dict(out, card=smi), f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
