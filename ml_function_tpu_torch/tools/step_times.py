"""Train-step times of two ``chip_smoke.py`` logs side by side.

    python3 -m ml_function_tpu_torch.tools.step_times BEFORE.log AFTER.log

``chip_smoke.py`` prints, for each model it trains at full width, a line
``<name> training at B=<b> (<what>): <host> ms a step, ...; device time per
step <device> ms (CUDA events, ...)``. This pairs the two logs' lines by
name, batch and description and prints both times of each and their
ratios (after over before), then the median ratio of each clock. Compare
two logs of one call: host-clock times move up to 2x between calls.
"""

from __future__ import annotations

import re
import statistics
import sys
from typing import Dict, Tuple

LINE = re.compile(r"^(.+? training at B=\d+ .*?): ([\d.]+) ms a step, .*?"
                  r"device time per step ([\d.]+) ms")


def step_times(path: str) -> Dict[str, Tuple[float, float]]:
    """Each train-step line's (host ms, device ms by events), by its key."""
    out = {}
    with open(path, errors="replace") as f:
        for line in f:
            m = LINE.match(line.strip())
            if m:
                out[m.group(1)] = (float(m.group(2)), float(m.group(3)))
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if len(argv) != 2:
        print(__doc__)
        return 2
    before, after = (step_times(p) for p in argv)
    ratios = {"host": [], "device": []}
    for key in before:
        if key not in after:
            continue
        (hb, db), (ha, da) = before[key], after[key]
        ratios["host"].append(ha / hb)
        ratios["device"].append(da / db)
        print(f"{key}: host {hb:.3f} -> {ha:.3f} ms ({ha / hb:.3f}), "
              f"events {db:.4f} -> {da:.4f} ms ({da / db:.3f})")
    if not ratios["host"]:
        print("no train-step line in both logs")
        return 1
    print(f"{len(ratios['host'])} steps; median ratio, after over before: host clock "
          f"{statistics.median(ratios['host']):.3f}, events "
          f"{statistics.median(ratios['device']):.3f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
