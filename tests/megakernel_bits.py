"""Whether two checkouts' decoder-layer megakernels give the same bits, on a
card: for a change that should move no float (a refactor of their device
code), before any change that may.

    python tests/megakernel_bits.py save FILE [--root ROOT]
    python tests/megakernel_bits.py compare FILE_A FILE_B

``save`` runs the megakernels of the checkout ROOT (this one by default)
at the card tests' cases (``tests/test_torch_cuda_kernels.py``
``MEGA_ROWS``: 1 to 32 rows, both routes, bf16 and int8 pages; Dh 64 and
128; splits of 64 and 128 positions; and ``noattn`` at splits of 64),
each launched twice, and keeps the outputs and the pools and scale planes
as the launches left them. ``compare`` prints the cases and those whose
tensors differ in any bit, and exits 1 if one does. Needs a card.
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys
from pathlib import Path

import torch


def save(root: Path, path: Path) -> int:
    sys.path[:0] = [str(root), str(root / "tests")]
    for name in [m for m in sys.modules if m.startswith("cmw_rag_tpu_torch")]:
        del sys.modules[name]          # the checkout's own package
    import test_torch_cuda_kernels as T
    from cmw_rag_tpu_torch.ops import paged_attention as PA

    card = torch.device("cuda", 0)
    out = {}
    for split, (kv8, s, route), dh, ablate in itertools.product(
            (64, 128), T.MEGA_ROWS, (64, 128), ("", "noattn")):
        if ablate and split == 128:
            continue
        PA.ATTN_SPLIT = split
        args, pools, lens_t, kw, _ = T._mega_case(card, s, dh, route, kv8,
                                                  seed=s * 7 + dh)
        got = T._mega_call(args, pools, lens_t, kw, kv8, ablate=ablate)
        again = T._mega_call(args, pools, lens_t, kw, kv8, ablate=ablate)
        torch.cuda.synchronize()
        out[f"{split}-{kv8}-{s}-{route}-{dh}-{ablate}"] = [
            got.cpu(), again.cpu()] + [p.cpu() for p in pools]
    torch.save(out, path)
    print(json.dumps({"root": str(root), "saved": len(out)}), flush=True)
    return 0


def compare(path_a: Path, path_b: Path) -> int:
    a, b = torch.load(path_a), torch.load(path_b)
    differ = sorted(k for k in a.keys() | b.keys()
                    if k not in a or k not in b
                    or not all(torch.equal(x, y) for x, y in zip(a[k], b[k])))
    print(json.dumps({"cases": len(a.keys() | b.keys()), "differ": differ}),
          flush=True)
    return 1 if differ else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("save", "compare"))
    ap.add_argument("files", type=Path, nargs="+")
    ap.add_argument("--root", type=Path,
                    default=Path(__file__).resolve().parents[1])
    args = ap.parse_args(argv)
    if args.mode == "save":
        return save(args.root.resolve(), args.files[0])
    return compare(*args.files[:2])


if __name__ == "__main__":
    sys.exit(main())
