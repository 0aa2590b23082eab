"""The readings the check's limits are set from: the program's and the control's.

    python3 bench/readings.py --workload <cell> --seeds 1,2,3 [--seconds S] [--out FILE]

For each seed, in one process: the cell's pool from the seed, one call
to warm up, a window as long as a run's at the cell's own load (so the
certificates cover as many answers as a run's do), then the
check's numbers (``bench/judge.py``) for the program's answers and for
the control's on the same sample.  The control is the float64 reference
put in the program's place and computed in TF32 (``simplex64.solve(...,
control=True)``).  One JSON line a seed; the benchmark's own runs never
run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from bench import harness, judge  # noqa: E402
from bench.reference import simplex64  # noqa: E402


def control_numbers(sample, ref):
    """The check's numbers with the control's answers in the program's place."""
    ctl = simplex64.solve(sample["a"], sample["b"], sample["c"], control=True)
    status = ctl.status.to(torch.int32)
    infeas, mismatch, unresolved = judge.certificates(
        sample["a"], sample["b"], sample["c"], ctl.objective, ctl.x, status)
    out = dict(infeasibility=float("inf") if unresolved else infeas, objective_mismatch=mismatch)
    out.update(judge.compare(ctl.objective, ctl.x, status, ctl.iterations, ref))
    return out


def diagnostics(sample, ref):
    """Status counts and mismatches of the program's sample against the reference."""
    st = sample["status"].to(torch.int64)
    gap, xg = judge.gaps(sample["objective"], sample["x"], sample["status"], ref)
    return dict(answer_gap_max=float(gap.max()), x_gap_max=float(xg.max()),
                answer_gap_p50=judge.rank(gap, 0.5),
                program_status=torch.bincount(st.cpu(), minlength=6).tolist(),
                reference_status=torch.bincount(ref.status.cpu(), minlength=6).tolist(),
                pivots_differ=int((sample["iterations"].to(torch.int64) != ref.iterations).sum()))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=None,
                    help="the window; BENCHMARK.json's run_seconds by default")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    harness.set_cache_env()
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch as rt

    cell = harness.load_cell(args.workload)
    seconds = args.seconds or harness.load_json(harness.ROOT / "BENCHMARK.json")["run_seconds"]
    config = dict(cell.config, torch_dtype=getattr(torch, cell.config["dtype"]))
    generator = harness.load_module("generators", config["generator"])
    traffic = harness.load_module("traffic", cell.file["traffic"])
    dev = torch.device("cuda")
    device = harness.Device(torch, True)
    out = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        g = torch.Generator(device=dev).manual_seed(seed % (1 << 64))
        pool = traffic.make_pool(generator, config, cell.params, g, dev)
        keeper = harness.warm(device, rt, traffic, pool, seconds)
        _, calls = harness.window(device, rt, traffic, pool, seconds, keeper)
        numbers, sample, unresolved = judge.window(
            traffic, pool, [(c.entry, c.sol) for c in calls], seed, cell.file["sample"])
        del calls, pool, keeper
        device.release()
        ref = simplex64.solve(sample["a"], sample["b"], sample["c"])
        numbers.update(judge.against_reference(sample, ref))
        line = dict(workload=cell.name, seed=seed, unresolved=unresolved, program=numbers,
                    control=control_numbers(sample, ref), **diagnostics(sample, ref),
                    seconds=time.perf_counter() - t0)
        text = json.dumps(line)
        print(text, flush=True)
        if out:
            out.write(text + "\n")
            out.flush()
        del sample, ref
        device.release()
    return 0


if __name__ == "__main__":
    sys.exit(main())
