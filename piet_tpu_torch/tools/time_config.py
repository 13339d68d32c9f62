"""Time ONE benchmark config on the card and print a JSON line.

Port of ``tools/time_config.py``: the A/B lever for the renderer's knobs.
The port's frame reads one knob from the environment, ``PIET_PAIR``
(entry pairing on the entries route), and takes its route from
``--fine-impl``: run this twice with different settings and diff the
reported ms.  Uses ``piet_tpu_torch.bench``'s graphed, sync-cost-
subtracted methodology and its capacity fit (imported, not copied).

Prints the card's name and power limit (nvidia-smi's line), then
``{"config", "ms_per_frame", "viewport", "env"}``, ``env`` being the
``PIET_*`` variables set.

Usage: python -m piet_tpu_torch.tools.time_config [config]
           [--fine-impl entries] [--cpu]
  config: tiger_4k (default), tiger_8x, circles_rects_1k, beziers_10k,
          glyph_page_5k, animated_clips
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from ..bench import CONFIGS, HEADLINE, bench_config
from ..cli import FINE_IMPL_NAMES, card_line
from ..renderer.renderer import check_device

#: name -> (scene maker, width, height): the benchmark's configs.
TABLE = {name: (make, w, h) for name, make, w, h in (HEADLINE, *CONFIGS)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m piet_tpu_torch.tools.time_config")
    ap.add_argument("config", nargs="?", default="tiger_4k",
                    choices=list(TABLE))
    ap.add_argument("--fine-impl", default="auto",
                    choices=list(FINE_IMPL_NAMES),
                    help="frame route: dense (auto, xla) or entries "
                         "(pallas)")
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    args = ap.parse_args(argv)
    dev = check_device("cpu" if args.cpu else "cuda")
    name = args.config
    make, w, h = TABLE[name]
    ms, _, _ = bench_config(name, make(), w, h, device=dev,
                            fine_impl=FINE_IMPL_NAMES[args.fine_impl])
    print(card_line(dev))
    print(json.dumps({
        "config": name,
        "ms_per_frame": round(ms, 3),
        "viewport": f"{w}x{h}",
        "env": {k: v for k, v in os.environ.items()
                if k.startswith("PIET_")},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
