"""Time two checkouts on one card in turns: ``chip_smoke.py``'s flash-kernel,
long-context and training phases of a base checkout (A) and of this one
(B), each run in a process of its own started from its checkout's root, in
the order A, B, B, A, so that a drift of the card over the call falls on
both alike.

    python -m cmw_rag_tpu_torch.scripts.compare_trees BASE_ROOT \\
        [--phases flash,long_context,training] [--out FILE]

BASE_ROOT is another checkout of the repository (for example the parent
commit, ``git archive <commit> chip_smoke.py cmw_rag_tpu_torch | tar -x -C
build/base``); each checkout builds its own kernels into its own
``build/``. A phase that fails in either checkout fails the run (its gates
are the phase's own). Prints, per run, a line ``{"tree": "A" or "B",
"run": i, "card": ..., "summary": {...}}`` with the readings a comparison
reads (the flash kernel's ms per shape, the long-context stages' ms per
query, the backward kernels' ms per shape, the training step's host and
busy ms and its first-step gates),
then one line with every run's summary; ``--out`` keeps the phases' whole
reports, one JSON line a run. The phases' own log lines go to stderr.
Needs a card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[2]
PHASES = ("flash", "long_context", "training")

_CHILD = """
import json, sys, torch
sys.path.insert(0, ".")
import chip_smoke as c
from cmw_rag_tpu_torch.scripts.shipping import card
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
line = card()
def plain(x):
    if isinstance(x, dict):
        return {(k if isinstance(k, str) else "/".join(map(str, k))): plain(v)
                for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x if isinstance(x, (int, float, str, bool, type(None))) else str(x)
out = {name: plain(getattr(c, name + "_phase")(line)) for name in PHASES}
print("COMPARE_RESULT " + json.dumps({"card": line, "phases": out}), flush=True)
"""


def run_tree(root: Path, phases: list[str]) -> dict:
    """One process from ``root`` running ``phases``; → its result line."""
    code = f"PHASES = {phases!r}\n" + _CHILD
    proc = subprocess.run([sys.executable, "-c", code], cwd=root,
                          capture_output=True, text=True)
    sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
    if proc.returncode != 0:
        raise RuntimeError(f"{root}: phases {phases} failed "
                           f"({proc.returncode})")
    for line in proc.stdout.splitlines():
        if line.startswith("COMPARE_RESULT "):
            return json.loads(line[len("COMPARE_RESULT "):])
    raise RuntimeError(f"{root}: no result line")


def summary(phases: dict) -> dict:
    """The readings a comparison of two trees reads, from one run."""
    out = {}
    flash = phases.get("flash")
    if flash:
        out["flash_ms"] = {case: r["ms"] for case, r in flash.items()}
    lc = phases.get("long_context")
    if lc:
        out["long_context_stages"] = lc["stages"]
    tr = phases.get("training")
    if tr:
        out["backward_ms"] = {k: r["ms"] for k, r in tr["kernels"].items()
                              if k.startswith("flash_attention_bwd_")}
        steps = tr["train"]["steps"]
        out["train_step"] = {k: steps[k] for k in (
            "host_ms_per_step", "device_busy_ms_per_step", "idle_share",
            "flash_share_of_busy")}
        out["train_first_step"] = tr["train"]["first_step"]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("base", type=Path, help="root of the base checkout (A)")
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--out", type=Path, default=None,
                    help="also write every run's result here as JSON lines")
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    for p in phases:
        if p not in PHASES:
            ap.error(f"unknown phase {p}")
    trees = {"A": args.base.resolve(), "B": HERE}
    runs = []
    for i, tree in enumerate("ABBA"):
        res = run_tree(trees[tree], phases)
        row = {"tree": tree, "run": i, "root": str(trees[tree]), **res}
        runs.append(row)
        print(json.dumps({"tree": tree, "run": i, "card": res["card"],
                          "summary": summary(res["phases"])}), flush=True)
    if args.out:
        args.out.write_text("".join(json.dumps(r) + "\n" for r in runs))
    print(json.dumps({"summary": [{"tree": r["tree"], "run": r["run"],
                                   **summary(r["phases"])} for r in runs]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
