"""Repeat pytest cases in fresh processes and count the runs that fail.

For an intermittent fault: each run is a new ``python -m pytest -p xdist -n 2
--dist loadfile`` over the given node ids, so each case starts in a fresh
worker process. ``--streams`` runs go side by side; ``--load FILE`` adds one
more stream that loops that test file for as long as the runs last, as
background load. Prints one line per failing run (with the failing ids) and a
JSON summary as the last line.

Usage: python scripts/repeat_cases.py --runs 1000 --streams 4
       [--load tests/test_torch_slice.py] NODEID [NODEID ...]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def pytest_cmd(args):
    return [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "xdist", "-n", "2",
            "--dist", "loadfile", "-p", "no:randomly", *args]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=1000)
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--load", default=None, help="a test file looped beside the runs")
    ap.add_argument("nodeids", nargs="+")
    a = ap.parse_args()
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    lock, done = threading.Lock(), threading.Event()
    state = {"next": 0, "passed": 0, "failed": 0, "fail_ids": {}}

    def stream():
        while True:
            with lock:
                if state["next"] >= a.runs:
                    return
                i = state["next"]
                state["next"] += 1
            p = subprocess.run(pytest_cmd(a.nodeids), cwd=ROOT, env=env, capture_output=True, text=True)
            with lock:
                if p.returncode == 0:
                    state["passed"] += 1
                else:
                    state["failed"] += 1
                    ids = sorted(set(re.findall(r"^FAILED (\S+)", p.stdout, re.M)))
                    for n in ids:
                        state["fail_ids"][n] = state["fail_ids"].get(n, 0) + 1
                    print(f"run {i}: rc {p.returncode} {ids}", flush=True)

    def load():
        n = 0
        while not done.is_set():
            subprocess.run(pytest_cmd([a.load]), cwd=ROOT, env=env, capture_output=True)
            n += 1
        state["load_runs"] = n

    t0 = time.time()
    loader = threading.Thread(target=load) if a.load else None
    if loader:
        loader.start()
    threads = [threading.Thread(target=stream) for _ in range(a.streams)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    done.set()
    if loader:
        loader.join()
    print(json.dumps({"runs": a.runs, "passed": state["passed"], "failed": state["failed"],
                      "fail_ids": state["fail_ids"], "load_runs": state.get("load_runs", 0),
                      "seconds": round(time.time() - t0, 1)}))


if __name__ == "__main__":
    main()
