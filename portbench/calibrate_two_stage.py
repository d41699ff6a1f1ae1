"""``calibrate.py`` for the cells of ``drivers/train_two_stage.py`` (a loss
of the configuration's own and a fixed projection beside the weights),
whose sides ``calibrate.train_sides`` cannot reach:

    python3 portbench/calibrate_two_stage.py --workload eta_taobao.train_long --seeds 1,2,3 [--sides program,control,half]

The same sides, lines and summary as ``calibrate.py``; each side from the
driver's ``sides``.
"""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from portbench import calibrate  # noqa: E402
from portbench.lib import spec  # noqa: E402
from portbench.lib.trace import Tracer  # noqa: E402


def two_stage_sides(cell, seed, device, sides):
    driver = spec.load_module("drivers", cell.traffic["driver"]).Driver(cell, seed, device, Tracer(False))
    return driver.sides(sides)


if __name__ == "__main__":
    calibrate.train_sides = two_stage_sides
    sys.exit(calibrate.main())
