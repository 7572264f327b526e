"""Time the grouped-conv kernels of two checkouts on one card, in turns.

    python3 compare_conv.py OLD_DIR NEW_DIR
        [--out chiprun_out/compare_conv.json]

Each turn runs ``chip_smoke.check_grouped_conv`` (the ``[conv]`` phase of
``chip_smoke.py``: forward, dX and dW at the six main-path geometries, each
held to its plain version and timed with CUDA events beside the library
call and the bound) of one checkout, in a process started in that checkout,
so that each turn times the kernels built from its own sources. Turns A, B,
B, A put both versions on the same card under the same conditions. Prints
the card, then one line per turn and kernel (bf16, summed over the six
geometries), and writes every row of every turn to ``--out``. Needs a CUDA
card; each checkout needs its own ``chip_smoke.py``. It sits beside
``chip_smoke.py`` at the root of the checkout, outside the package, since
it drives that script.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

from ste_gan_torch.device import card_line

_TURN = r"""
import json, torch, torch.nn.functional as F
import chip_smoke
from ste_gan_torch.ops import build, grouped_conv as gc
if not torch.cuda.is_available():
    raise SystemExit("no CUDA card")
# As chip_smoke.main: the plain versions' f32 convs in full f32.
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
build.build_all()
rows, summary = chip_smoke.check_grouped_conv(torch, gc, F)
print("COMPARE_CONV " + json.dumps({"rows": rows, "summary": summary}))
"""


def run_turn(checkout: Path) -> dict:
    """``check_grouped_conv`` of ``checkout``, in a process of its own."""
    out = subprocess.run([sys.executable, "-c", _TURN], cwd=checkout,
                         capture_output=True, text=True, timeout=1800)
    for line in out.stdout.splitlines():
        if line.startswith("COMPARE_CONV "):
            return json.loads(line[len("COMPARE_CONV "):])
    raise SystemExit(f"{checkout}: the [conv] phase failed (exit "
                     f"{out.returncode}):\n{out.stdout[-4000:]}\n"
                     f"{out.stderr[-4000:]}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("old", type=Path, help="checkout A")
    ap.add_argument("new", type=Path, help="checkout B")
    ap.add_argument("--out", type=Path,
                    default=Path("chiprun_out/compare_conv.json"))
    args = ap.parse_args(argv)
    card = card_line()
    print(f"[compare] {card}", flush=True)
    dirs = {"A": args.old.resolve(), "B": args.new.resolve()}
    turns = []
    for n, which in enumerate("ABBA"):
        res = run_turn(dirs[which])
        turns.append({"turn": n, "checkout": which, "dir": str(dirs[which]),
                      **res})
        for name, agg in res["summary"].items():
            print(f"[compare] turn {n} {which} {name}: kernel "
                  f"{agg['ms']:.4f} ms, bound {agg['bound_ms']:.4f} ms, "
                  f"library {agg['library_ms']:.4f} ms, plain "
                  f"{agg['plain_ms']:.4f} ms", flush=True)
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps({"card": card, "turns": turns}, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
