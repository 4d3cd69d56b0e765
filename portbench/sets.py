"""Runs of cells, one process after another, with their results and spreads.

    python3 -m portbench.sets --out DIR RUN [RUN ...]

RUN is `workload:seed:seconds:trace`. Each run is `python3 -m portbench.run`
in a process of its own, waited for; its result line goes to DIR/runs.jsonl
with the run, its exit code and seconds, and the end of its standard error
to DIR/<n>.err. The summary prints, per workload and metric, the values in
order, the median and the spread: the distance between the first and third
quartiles (statistics.quantiles, n=4) over the median.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path


def spread(values):
    if len(values) < 2:
        return None
    q1, _, q3 = statistics.quantiles(values, n=4)
    med = statistics.median(values)
    return (q3 - q1) / abs(med) if med else None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", required=True)
    ap.add_argument("runs", nargs="+")
    args = ap.parse_args(argv)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    values = defaultdict(list)
    with open(out / "runs.jsonl", "a") as log:
        for n, spec in enumerate(args.runs):
            workload, seed, seconds, trace = spec.split(":")
            cmd = [sys.executable, "-m", "portbench.run", "--workload", workload, "--seed", seed,
                   "--seconds", seconds, "--trace", trace]
            t = time.perf_counter()
            p = subprocess.run(cmd, capture_output=True, text=True)
            secs = time.perf_counter() - t
            (out / f"{n}.err").write_text(p.stderr[-20000:])
            lines = p.stdout.strip().splitlines()
            try:
                res = json.loads(lines[-1]) if lines else None
            except json.JSONDecodeError:
                res = None
            log.write(json.dumps({"run": spec, "rc": p.returncode, "seconds": secs,
                                  "result": res}) + "\n")
            log.flush()
            checks = {k: v["value"] for k, v in (res or {}).get("checks", {}).items()}
            print(f"{spec} rc={p.returncode} {secs:.1f}s correct={None if res is None else res['correct']}"
                  f" {json.dumps({k: v['value'] for k, v in (res or {}).get('metrics', {}).items()})}"
                  f" checks={json.dumps(checks)}", flush=True)
            if p.returncode != 0:
                print(p.stderr[-3000:], flush=True)
            for k, v in (res or {}).get("metrics", {}).items():
                values[(workload, trace, k)].append(v["value"])
    for (workload, trace, k), vs in sorted(values.items()):
        print(f"{workload} trace={trace} {k}: median {statistics.median(vs)!r} "
              f"spread {spread(vs)!r} values {vs!r}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
