"""Phases of ``chip_smoke.py`` alone, on one NVIDIA GPU.

    python3 -m transmogrifai_tpu_torch.experiments.smoke_phases
        [fleet] [direct-cost[:TRAIN]] [direct-class[:TRAIN]] [resume]
        [parquet-cli] [plan]

Run from the root of a checkout (``chip_smoke.py`` beside the package).
Builds the kernels first, then, in the order given:

* ``fleet``: the (fleet) phase (``chip_smoke.Fleet``) with every kernel's
  launch count zeroed before it and read after it, and its checks of the
  counted launches (``Fleet.after``);
* ``direct-cost[:TRAIN]``: a check train (``titanic``, the default,
  ``titanic_wcv``, ``leads``, ``leads_stage`` or ``tickets``: every launch
  of the sweep kernels held to plain) with ``node_hist`` also held to its
  direct formula at each shape's first launch (``A``) and without
  (``B``), in turns A B B A; prints each train's seconds;
* ``direct-class[:TRAIN]``: the same check train (``leads`` by default)
  with ``node_hist`` held to its direct formula at each shape's first
  launch (``A``) and at each (codes width, T) class's first launch
  (``B``), in turns A B B A;
* ``resume``: (t)'s ``default_binary`` train against its fixture, then
  the (resume) phase (``chip_smoke.Resume``, ``_resume_paths``): each arm
  with the launch counts zeroed before it and read after it;
* ``parquet-cli``: (titanic)'s counted train against its fixture, then
  the (parquet) and (cli) phases (``chip_smoke.Parquet``, ``Cli``) as the
  script runs them, each path with the launch counts zeroed before it and
  read after it;
* ``plan``: (titanic)'s counted train against its fixture, then the
  (plan) phase (``chip_smoke.PlanPhase``, ``_plan_paths``) as the script
  runs it.

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


def _check_workflows(cs, tmp, train: str):
    """A maker of fresh workflows of the check train ``train`` (its
    records built once)."""
    if train == "titanic":
        return cs.Titanic(tmp).workflow
    if train == "titanic_wcv":
        wcv = cs.TitanicWCV(cs.Titanic(tmp))
        return lambda: wcv.workflow()[0]
    if train in ("leads", "leads_stage"):
        leads = cs.Leads()
        return lambda: leads.workflow(train)[0]
    if train == "tickets":
        tickets = cs.Tickets()
        return lambda: tickets.workflow()[0]
    raise ValueError(f"no check train {train!r}")


def _direct_cost(cs, tmp, train: str = "titanic"):
    import torch
    make = _check_workflows(cs, tmp, train)
    for arm in ("A", "B", "B", "A"):
        wf = make()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with cs._KernelChecks(keep_heaviest=True, direct_per_shape=True,
                              direct=(arm == "A")):
            wf.train()
            torch.cuda.synchronize()
        print(f"direct-cost {train}: arm {arm} ("
              f"{'with' if arm == 'A' else 'without'} the direct formula) "
              f"{time.perf_counter() - t0:.3f} s", flush=True)


def _direct_class(cs, tmp, train: str = "leads"):
    import torch
    make = _check_workflows(cs, tmp, train)
    for arm in ("A", "B", "B", "A"):
        wf = make()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with cs._KernelChecks(keep_heaviest=True, direct_per_shape=True,
                              direct_per_class=(arm == "B")) as checks:
            wf.train()
            torch.cuda.synchronize()
        print(f"direct-class {train}: arm {arm} (the direct formula at "
              f"each {'shape' if arm == 'A' else '(codes width, T) class'}"
              f"'s first launch, {len(checks.direct_shapes)} held) "
              f"{time.perf_counter() - t0:.3f} s", flush=True)


def _counted(cs, tmp):
    """The script's settings for its counted paths, and its ``run_path``:
    zero every count, drive the path, read the counts, each of the path's
    kernels launched."""
    import torch

    from ..histeng import kernels as HK
    from ..ops import forest as F
    kernels = HK.KERNELS + F.KERNELS
    os.environ["TG_FAST_GRIDS"] = "0"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.SAVE_DIR = os.path.join(tmp, "saved")
    os.makedirs(cs.SAVE_DIR)

    def run_path(name, phase, path_kernels):
        for k in kernels:
            k.launches = 0
        phase()
        torch.cuda.synchronize()
        counts = {k.name: k.launches for k in kernels}
        idle = [k.name for k in path_kernels if counts[k.name] == 0]
        if idle:
            raise AssertionError(f"kernel(s) {idle} never launched on the "
                                 f"{name} path")
        print(f"launches, {name}: "
              f"{ {k: v for k, v in counts.items() if v} }")
        return counts
    return run_path


def _resume(cs, tmp):
    import torch
    run_path = _counted(cs, tmp)
    cs.train_against_fixture("default_binary")
    t0 = time.perf_counter()
    cs._resume_paths(cs.Resume(tmp, torch.device("cuda", 0)), run_path)
    print(f"(resume) alone in {time.perf_counter() - t0:.3f} s")


def _parquet_cli(cs, tmp):
    from ..histeng import kernels as HK
    from ..ops import forest as F
    run_path = _counted(cs, tmp)
    titanic = cs.Titanic(tmp)
    run_path("train titanic", titanic.train,
             (HK.HIST_MATMUL, HK.NODE_HIST, F.FOREST_PREDICT_CHAIN))
    _, pq_s = cs._parquet_paths(titanic, tmp, run_path)
    _, cli_s = cs._cli_paths(titanic, tmp, run_path)
    print(f"(parquet) alone in {pq_s:.3f} s, (cli) alone in {cli_s:.3f} s")


def _plan(cs, tmp):
    from ..histeng import kernels as HK
    from ..ops import forest as F
    run_path = _counted(cs, tmp)
    titanic = cs.Titanic(tmp)
    run_path("train titanic", titanic.train,
             (HK.HIST_MATMUL, HK.NODE_HIST, F.FOREST_PREDICT_CHAIN))
    _, secs = cs._plan_paths(titanic, run_path)
    print(f"(plan) alone in {secs:.3f} s")


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("smoke_phases: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    phases = {"fleet": _fleet, "direct-cost": _direct_cost,
              "direct-class": _direct_class, "resume": _resume,
              "parquet-cli": _parquet_cli, "plan": _plan}
    names = (argv if argv is not None else sys.argv[1:]) or ["fleet"]
    unknown = [n for n in names if n.split(":")[0] not in phases]
    if unknown:
        print(f"smoke_phases: unknown phase(s) {unknown}; choose from "
              f"{sorted(phases)}", file=sys.stderr)
        return 2
    cs.phase_build()
    tmp = tempfile.mkdtemp(prefix="smoke_phases_")
    for i, name in enumerate(names):
        phase, *arg = name.split(":")
        os.makedirs(os.path.join(tmp, str(i)))
        phases[phase](cs, os.path.join(tmp, str(i)), *arg)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
