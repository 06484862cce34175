#!/usr/bin/env python3
"""Times two checkouts of the PyTorch port on one card, in turns.

    python scripts/compare_torch_trees.py --parent DIR [--pairs 2] [--warm-runs 3]

DIR holds another checkout of the repository, for example the parent
commit unpacked with ``git archive`` into a directory that .gitignore
lists. One worker process runs per turn, in pairs that alternate which
side goes first (parent, change, change, parent, ...), where "change" is
the checkout this script lies in. Each worker imports
``move2hear_tpu_torch`` from its checkout, builds that checkout's kernels
with its own ``ops/build.py``, and measures with this checkout's
``chip_smoke.py`` helpers:

- ``masked_mix_slice16`` at (16, 512, 32, 2) and ``overlap_add`` of
  (16, 32, 1023) frames, whole output (a call both checkouts' wrappers
  take): L2-cold and L2-hot device times, as chip_smoke.py phase 3 times
  them;
- the eval CLI at full width (chip_smoke.py phase 4's run): one cold run,
  then ``--warm-runs`` warm runs; env-steps/s over the episode loop and the
  kernels' launch counts.

Prints one line per turn, each checkout's values with their mean and
spread (max - min) beside it, in how many pairs the change's kernels and
warm eval were faster, and one JSON line. Fails without a GPU.
"""

import argparse
import importlib.util
import json
import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def worker(tree: str, warm_runs: int, run_dir: str) -> dict:
    import torch

    if not torch.cuda.is_available():
        sys.exit("compare_torch_trees: needs an NVIDIA GPU")
    cs = load_chip_smoke()
    sys.path.insert(0, tree)
    from move2hear_tpu_torch.ops import build, kernels

    if not os.path.abspath(kernels.__file__).startswith(os.path.abspath(tree)):
        sys.exit(f"compare_torch_trees: imported {kernels.__file__}, not from {tree}")
    build.build_all(("masked_mix_slice16", "overlap_add"))
    mm = cs.mm_inputs(torch, cs.MM_CASES["path"])
    (frames,) = cs.ola_inputs(torch, cs.OLA_CASES["B=16-whole"])
    times = {}
    for name, fn, args in (("masked_mix_slice16", kernels.masked_mix_slice16, mm),
                           ("overlap_add", kernels.overlap_add, (frames,))):
        times[name] = {
            "l2_cold_ms": cs.device_ms(fn, cs.l2_cold_copies(*args)),
            "l2_hot_ms": cs.device_ms(fn, [args]),
        }
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    try:
        results, _ = cs.run_eval(torch, kernels, run_dir, 1 + warm_runs)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)
    rates = [tm["env_steps"] / tm["loop_s"] for _, tm, _, _ in results]
    return {
        "tree": tree, "card": cs.card_line(), "kernels": times,
        "cold_env_steps_per_s": rates[0], "warm_env_steps_per_s": rates[1:],
        "launches": results[-1][0],
    }


def spread(values):
    return f"mean {sum(values) / len(values):.4f}, spread {max(values) - min(values):.4f}"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", required=True, help="the other checkout's root")
    ap.add_argument("--pairs", type=int, default=2)
    ap.add_argument("--warm-runs", type=int, default=3)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        run_dir = os.path.join(REPO, "_smoke_run", f"compare-{os.getpid()}")
        print(json.dumps(worker(args.worker, args.warm_runs, run_dir)), flush=True)
        return
    trees = {"parent": os.path.abspath(args.parent), "change": REPO}
    runs = []
    turns = [side for k in range(args.pairs)
             for side in (("parent", "change") if k % 2 == 0 else ("change", "parent"))]
    for turn, label in enumerate(turns):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--parent", trees["parent"],
             "--warm-runs", str(args.warm_runs), "--worker", trees[label]],
            capture_output=True, text=True, timeout=900,
        )
        if proc.returncode != 0:
            sys.exit(f"turn {turn} ({label}) failed, rc {proc.returncode}:\n"
                     f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        res["label"] = label
        runs.append(res)
        k = res["kernels"]
        print(f"turn {turn} {label}: masked_mix_slice16 L2-cold "
              f"{k['masked_mix_slice16']['l2_cold_ms'] * 1e3:.3f} us, L2-hot "
              f"{k['masked_mix_slice16']['l2_hot_ms'] * 1e3:.3f} us; overlap_add B=16 whole "
              f"L2-cold {k['overlap_add']['l2_cold_ms'] * 1e3:.3f} us, L2-hot "
              f"{k['overlap_add']['l2_hot_ms'] * 1e3:.3f} us; eval cold "
              f"{res['cold_env_steps_per_s']:.1f}, warm "
              f"{', '.join(f'{r:.1f}' for r in res['warm_env_steps_per_s'])} env-steps/s; "
              f"launches {res['launches']} ({res['card']})", flush=True)
    for label in ("parent", "change"):
        mine = [r for r in runs if r["label"] == label]
        for name in ("masked_mix_slice16", "overlap_add"):
            for key in ("l2_cold_ms", "l2_hot_ms"):
                us = [r["kernels"][name][key] * 1e3 for r in mine]
                print(f"{label} {name} {key[:-3]} us: {us} ({spread(us)})")
        warm = [w for r in mine for w in r["warm_env_steps_per_s"]]
        print(f"{label} eval warm env-steps/s: {warm} ({spread(warm)})")
    pairs = [{r["label"]: r for r in runs[i : i + 2]} for i in range(0, len(runs), 2)]
    for name in ("masked_mix_slice16", "overlap_add"):
        wins = sum(p["change"]["kernels"][name]["l2_cold_ms"] < p["parent"]["kernels"][name]["l2_cold_ms"]
                   for p in pairs)
        print(f"{name}: change faster L2-cold in {wins} of {len(pairs)} pairs")
    mean = lambda r: sum(r["warm_env_steps_per_s"]) / len(r["warm_env_steps_per_s"])
    wins = sum(mean(p["change"]) > mean(p["parent"]) for p in pairs)
    print(f"eval warm: change's mean above the parent's in {wins} of {len(pairs)} pairs")
    print(json.dumps({"turns": runs}), flush=True)


if __name__ == "__main__":
    main()
