"""Phases of ``chip_smoke.py`` alone, on one NVIDIA GPU.

    python3 -m transmogrifai_tpu_torch.experiments.smoke_phases
        [fleet] [direct-cost]

Run from the root of a checkout (``chip_smoke.py`` beside the package).
Builds the kernels first, then, in the order given:

* ``fleet``: the (fleet) phase (``chip_smoke.Fleet``) with every kernel's
  launch count zeroed before it and read after it, and its checks of the
  counted launches (``Fleet.after``);
* ``direct-cost``: the Titanic check train (``chip_smoke.Titanic``: every
  launch of the three sweep kernels held to plain) with ``node_hist``
  also held to its direct formula at each shape's first launch (``A``)
  and without (``B``), in turns A B B A; prints each train's seconds.

Prints the card's name and power limit last.
"""
from __future__ import annotations

import os
import subprocess
import sys
import tempfile
import time


def _fleet(cs, tmp):
    import torch

    from ..histeng import kernels as HK
    from ..ops import forest as F
    kernels = HK.KERNELS + F.KERNELS
    fleet = cs.Fleet(tmp)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    fleet.run()
    torch.cuda.synchronize()
    counts = {k.name: k.launches for k in kernels}
    print(f"launches, fleet: { {k: v for k, v in counts.items() if v} }")
    fleet.after(counts)
    print(f"(fleet) alone in {time.perf_counter() - t0:.3f} s")


def _direct_cost(cs, tmp):
    import torch
    titanic = cs.Titanic(tmp)
    for arm in ("A", "B", "B", "A"):
        wf = titanic.workflow()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with cs._KernelChecks(keep_heaviest=True, direct_per_shape=True,
                              direct=(arm == "A")):
            wf.train()
            torch.cuda.synchronize()
        print(f"direct-cost: arm {arm} ("
              f"{'with' if arm == 'A' else 'without'} the direct formula) "
              f"{time.perf_counter() - t0:.3f} s", flush=True)


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("smoke_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    phases = {"fleet": _fleet, "direct-cost": _direct_cost}
    names = (argv if argv is not None else sys.argv[1:]) or ["fleet"]
    unknown = [n for n in names if n not in phases]
    if unknown:
        print(f"smoke_phases: unknown phase(s) {unknown}; choose from "
              f"{sorted(phases)}", file=sys.stderr)
        return 2
    cs.phase_build()
    tmp = tempfile.mkdtemp(prefix="smoke_phases_")
    for name in names:
        os.makedirs(os.path.join(tmp, name))
        phases[name](cs, os.path.join(tmp, name))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
