#!/usr/bin/env python3
"""`chip_smoke.py` with every line it says prefixed by the seconds since the
start (`@ <s> [phase] ...`), to see where the script's time limit goes:

    python3 smoke_timeline.py 2>&1 | tee chiprun_out/smoke_timed.log

The gap before a line is the time its phase took to print it. The kernels
line and the last line are prefixed too, so this run is for reading, not
for the contract that `chip_smoke.py` keeps."""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import chip_smoke  # noqa: E402

if __name__ == "__main__":
    t0 = time.time()
    say = chip_smoke.say
    chip_smoke.say = lambda msg: say(f"@{time.time() - t0:8.1f} {msg}")
    chip_smoke.main()
