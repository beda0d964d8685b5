"""Time this checkout's kernels and trains against another checkout's, in
turns, on one NVIDIA GPU.

    python3 transmogrifai_tpu_torch/ab_compare.py --parent DIR
        [--families gbt,gbt12,rf,dt,rfreg,gbtreg,rfmc,xgbmc] [--reps 5]
        [--out FILE]

DIR is another checkout of the repo (for example the parent commit,
``git archive`` unpacked into a git-ignored directory); ``--families ''``
times the kernels only; a family (any key of ``testing.SERVE_MODELS``)
that DIR's ``testing.py`` does not define is trained in this checkout's
turns only.
The two run in the order parent, change, change, parent; each turn runs
``profile_hist.py`` (the histogram, forest predict and leaf-sum
kernels at their main-path shapes, pass by pass) and ``profile_train --family F`` for each family (warm train
seconds, peak memory, device ms by kernel, device busy share), each in a
process of its own. Every JSON line they print is written to ``--out``
tagged with its turn; the summary printed at the end gives, per turn,
each kernel case's ms and each train's seconds, device busy share and
device ms of the two histogram kernels (kernel names that start with
``node_`` or ``hist_``, summed over the kernels ``profile_train`` lists)
and of the leaf sums (``leaf_sums_ms``).
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# run as a script, this file's directory would come first on the path and
# its modules (``types.py``, ...) would shadow the standard library's
if sys.path and os.path.abspath(sys.path[0] or ".") == HERE:
    sys.path.pop(0)
sys.path.insert(0, ROOT)

from transmogrifai_tpu_torch.profile_hist import kernel_name  # noqa: E402
from transmogrifai_tpu_torch.testing import SERVE_MODELS  # noqa: E402


def run(cmd, cwd) -> list:
    """Run ``cmd`` in ``cwd``; its JSON lines, or raise with its output."""
    proc = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"{cmd} in {cwd} exited {proc.returncode}:\n"
                           f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    return [json.loads(line) for line in proc.stdout.splitlines()
            if line.startswith("{")]


def kernel_ms(by_kernel: dict, prefix: str) -> float:
    """Device ms of the kernels whose bare name starts with ``prefix``."""
    return sum(v for k, v in by_kernel.items()
               if kernel_name(k).startswith(prefix))


def leaf_sums_ms(by_kernel: dict) -> float:
    """Device ms of the leaf-sum kernels: bare names holding ``sums_``, and
    ``combine_kernel``, the older name of their combine pass (their share of
    the pack pass, which the predicts share, is not counted)."""
    return sum(v for k, v in by_kernel.items()
               if "sums_" in kernel_name(k)
               or kernel_name(k) == "combine_kernel")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True)
    ap.add_argument("--families",
                    default="gbt,gbt12,rf,dt,rfreg,gbtreg,rfmc,xgbmc")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    families = [f for f in args.families.split(",") if f]
    unknown = sorted(set(families) - set(SERVE_MODELS))
    if unknown:
        ap.error(f"unknown families {unknown}")
    parent = os.path.abspath(args.parent)
    turns = [("parent", parent), ("change", ROOT), ("change", ROOT),
             ("parent", parent)]
    rows = []
    for i, (label, root) in enumerate(turns):
        tag = f"{i + 1}:{label}"
        for r in run([sys.executable, os.path.join(HERE, "profile_hist.py"),
                      "--root", root], ROOT):
            rows.append(dict(turn=tag, **r))
        with open(os.path.join(root, "transmogrifai_tpu_torch",
                               "testing.py")) as f:
            defined = f.read()
        for fam in (f for f in families if f'"{f}":' in defined):
            for r in run([sys.executable, "-m",
                          "transmogrifai_tpu_torch.profile_train",
                          "--family", fam, "--reps", str(args.reps)], root):
                rows.append(dict(turn=tag, **r))
    if args.out:
        with open(args.out, "w") as f:
            for r in rows:
                f.write(json.dumps(r) + "\n")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    for r in rows:
        if "case" in r:
            print(f"{r['turn']:9s} {r['case']:42s} {r['ms']:.4f} ms")
        else:
            k = r["device_ms_by_kernel"]
            print(f"{r['turn']:9s} train {r['family']:6s} "
                  f"{r['train_s']:.4f} s, busy {r['device_busy_ms']:.1f} ms "
                  f"({100 * r['device_busy_share']:.1f}%), node_hist "
                  f"{kernel_ms(k, 'node_'):.2f} ms, hist_matmul "
                  f"{kernel_ms(k, 'hist_'):.2f} ms, leaf sums "
                  f"{leaf_sums_ms(k):.4f} ms, peak "
                  f"{r['peak_mem_bytes'] / 2 ** 30:.3f} GiB")
    return 0


if __name__ == "__main__":
    sys.exit(main())
