"""Command line (counterpart of ``transmogrifai_tpu.cli``): the ``campaign``
subcommand only; ``op gen`` and the other subcommands wait (ROADMAP Queue
1 item 10).

    python -m transmogrifai_tpu_torch.cli campaign [--schedules N]
        [--seed S] [--scenario NAME] [--faults JSON] [--output DIR]
        [--no-minimize] [--device cuda:0|cpu]

A campaign failure prints its reproducer, which re-runs one schedule:
``TG_CHAOS=1 TG_FAULTS='<json>' python -m transmogrifai_tpu_torch.cli
campaign --scenario <s>`` (exit 1 when an oracle fires).
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Any, Dict, List, Optional


def run_campaign(schedules: int = 0, seed: Optional[int] = None,
                 scenario: Optional[str] = None,
                 faults_json: Optional[str] = None,
                 output: Optional[str] = None,
                 no_minimize: bool = False,
                 device=None) -> Dict[str, Any]:
    """Run a seeded chaos campaign on ``device`` (default: the CUDA
    device), or re-run one schedule as a reproducer.

    Repro mode: ``faults_json`` (or ``TG_CHAOS=1 TG_FAULTS='<json>'`` in
    the environment) together with ``scenario``; the one schedule runs and
    the process exits 1 when an invariant oracle fires. Otherwise
    ``schedules`` schedules (coverage singletons first), violations
    minimized to reproducers, the report JSON on stdout (and
    ``campaign_report.json`` under ``output``); exit 1 on a violation."""
    from .robustness.campaign import ChaosCampaign

    repro_blob = faults_json or (
        os.environ.get("TG_FAULTS")
        if os.environ.get("TG_CHAOS") and scenario else None)
    if repro_blob and not scenario:
        raise SystemExit(
            "campaign repro mode needs --scenario naming the harness "
            "the TG_FAULTS schedule runs against")
    eng = ChaosCampaign(
        seed=seed, device=device,
        scenarios=None if (repro_blob or scenario is None) else [scenario])
    try:
        if repro_blob:
            result = eng.run_schedule(
                {"scenario": scenario, "faults": json.loads(repro_blob)})
            print(json.dumps(result, indent=2, default=str))
            if result["violations"]:
                sys.exit(1)
            return result
        report = eng.run(count=schedules or None, minimize=not no_minimize)
        doc = report.to_json()
        print(json.dumps(doc, indent=2, default=str))
        if output:
            os.makedirs(output, exist_ok=True)
            path = os.path.join(output, "campaign_report.json")
            with open(path, "w") as fh:
                json.dump(doc, fh, indent=2, default=str)
            print(f"wrote {path}")
        if doc["violations"]:
            sys.exit(1)
        return doc
    finally:
        eng.close()


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m transmogrifai_tpu_torch.cli")
    sub = p.add_subparsers(dest="command", required=True)
    cp = sub.add_parser(
        "campaign", help="run a seeded chaos campaign: randomized "
                         "multi-fault schedules against real scenario "
                         "harnesses, invariant oracles and schedule "
                         "minimization")
    cp.add_argument("--schedules", type=int, default=0,
                    help="schedule budget (0 = TG_CAMPAIGN_SCHEDULES or "
                         "40; coverage singletons for every covered site "
                         "come first)")
    cp.add_argument("--seed", type=int, default=None,
                    help="campaign seed (default TG_CAMPAIGN_SEED or 0)")
    cp.add_argument("--scenario", default=None,
                    help="restrict to one scenario (train | sweep | serve "
                         "| serve_heal | stream | fleet | density | net | "
                         "transfer); required in repro mode")
    cp.add_argument("--faults", default=None,
                    help="repro mode: a TG_FAULTS-style JSON schedule run "
                         "once against --scenario (also read from "
                         "TG_CHAOS=1 TG_FAULTS=...)")
    cp.add_argument("--output", default=None,
                    help="directory for campaign_report.json")
    cp.add_argument("--no-minimize", action="store_true",
                    help="skip the minimization of violating schedules")
    cp.add_argument("--device", default=None,
                    help="cuda:0, cpu, ... (default: the CUDA device)")
    return p


def main(argv: Optional[List[str]] = None) -> None:
    a = build_parser().parse_args(argv)
    if a.command == "campaign":
        run_campaign(schedules=a.schedules, seed=a.seed,
                     scenario=a.scenario, faults_json=a.faults,
                     output=a.output, no_minimize=a.no_minimize,
                     device=a.device)


if __name__ == "__main__":
    main()
