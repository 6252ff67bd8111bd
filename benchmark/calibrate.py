"""The readings the limits of ``correct`` are set from, in one process:

- the program, on each of ``--seeds``: one whole job of every kind of the
  cell (the cell's own sizes and load), its sampled outputs against the
  float64 reference;
- the control, on each of ``--control-seeds``: the reference computed in
  the next precision below the configuration's (a bfloat16 linearisation
  for float32) put in the program's place, against the same float64
  reference;
- the witness, on each of ``--witness-seeds``: the reference wholly in
  the configuration's own precision, against the float64 reference;
- the program with a fault of ``benchmark/faults.py`` planted under the
  timed path, for each of ``--faults`` on each of ``--fault-seeds``.

    python3 -m benchmark.calibrate --workload <cell> --seeds 1,2,3 \\
        --control-seeds 4,5,6 [--witness-seeds 7,8] \\
        [--faults half_left_out --fault-seeds 9,10] [--set gap_fraction=0.1]

prints one JSON line per reading: each number of ``compare.numbers``,
the share of pixel-windows over each threshold of ``compare.LADDER`` and
each window's median state gap.  ``--set key=value`` (a JSON value)
overrides a key of the workload for every reading.  The benchmark's own
runs do not run it.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time

#: the control of each precision a configuration states: the precision
#: of the reference's solve and of its operator's value and Jacobian.
#: Wholly in bfloat16 the reference's normal equations (inverse
#: variances up to 1.6e5 beside prior information of order 1) lose
#: positive definiteness and its Cholesky gives NaN, which is no
#: reading; so the control linearises in bfloat16 and solves in float32.
CONTROL_DTYPE = {"float32": ("float32", "bfloat16")}


def _spec(name, overrides):
    from . import harness

    spec = harness.cell(name)
    overrides = overrides or {}
    return (harness._merge(spec["config"], overrides.get("config")),
            harness._merge(spec["workload"], overrides.get("workload")))


def _summary(done, work) -> dict:
    import numpy as np

    from . import compare

    values = compare.numbers(done, work.get("share_over"))
    x = [float(np.median(compare._gap(p["x"], r["x"])))
         for p, r in done]
    return {**values, "share_ladder": compare.share_ladder(done),
            "window_medians": x,
            "limits_pass": compare.judge(values, work.get("limits", {}))[0]}


def program_reading(name, seed, device, overrides=None,
                    fault=None) -> dict:
    import torch

    from . import faults, harness
    from .sink import HostSink

    config, work = _spec(name, overrides)
    t0 = time.perf_counter()
    scn = harness.scenario_class(config)(config, work, seed, device)
    sink = HostSink(scn.n_pad, len(scn.cfg.parameter_list), scn.n_valid,
                    pinned=device.type == "cuda")
    records = []
    plant = faults.planted(fault) if fault else contextlib.nullcontext([0])
    with plant as calls:
        harness.run_jobs(scn, sink, device, 0, 0.0, True, records,
                         max_jobs=scn.kinds)
    scn.reference_inputs()
    scn.release()
    done, failed = harness.pairs(scn, sink, torch.float64)
    trips = sorted({r["n_iterations"] for r in records})
    return {"side": "program" if fault is None else f"fault:{fault}",
            "seed": seed, **_summary(done, work), "failed": failed,
            "broken_solves": calls[0], "windows": len(sink.completed),
            "trips": trips, "seconds": time.perf_counter() - t0}


def control_reading(name, seed, device, overrides=None,
                    dtypes=None) -> dict:
    """The reference in ``dtypes`` (solve, linearisation; the control's
    by default) against the float64 reference."""
    import torch

    from . import harness

    config, work = _spec(name, overrides)
    dtypes = dtypes or CONTROL_DTYPE[config.get("precision", "float32")]
    solve, lin = (getattr(torch, d) for d in dtypes)
    t0 = time.perf_counter()
    scn = harness.scenario_class(config)(config, work, seed, device)
    scn.reference_inputs()
    scn.release()
    done = []
    for kind in range(scn.kinds):
        got = scn.reference(kind, solve, lin)
        ref = scn.reference(kind, torch.float64)
        done.extend(zip(got, ref))
    side = "control" if dtypes == CONTROL_DTYPE.get(
        config.get("precision", "float32")) else "witness"
    return {"side": side, "dtype": f"{solve}/{lin}", "seed": seed,
            **_summary(done, work), "windows": len(done),
            "seconds": time.perf_counter() - t0}


def _seeds(text):
    return [int(v) for v in text.split(",") if v]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--witness-seeds", default="")
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", default="")
    ap.add_argument("--set", action="append", default=[],
                    metavar="KEY=VALUE")
    args = ap.parse_args(argv)
    import torch

    device = torch.device("cuda", 0)
    over = {"workload": {k: json.loads(v) for k, v in
                         (kv.split("=", 1) for kv in args.set)}}
    config, _ = _spec(args.workload, over)
    own = config.get("precision", "float32")
    runs = [(program_reading, s, {}) for s in _seeds(args.seeds)]
    runs += [(control_reading, s, {}) for s in _seeds(args.control_seeds)]
    runs += [(control_reading, s, {"dtypes": (own, own)})
             for s in _seeds(args.witness_seeds)]
    runs += [(program_reading, s, {"fault": f})
             for f in args.faults.split(",") if f
             for s in _seeds(args.fault_seeds)]
    for fn, seed, kw in runs:
        reading = fn(args.workload, seed, device, over, **kw)
        print(json.dumps(dict(reading, set=over["workload"])), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
