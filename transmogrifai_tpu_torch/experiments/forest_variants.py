"""Time the forest kernel designs that were measured and not taken beside
the shipped ones (``csrc/forest_predict.cu``), on one NVIDIA GPU.

    python3 -m transmogrifai_tpu_torch.experiments.forest_variants
        [--runs 25] [--only variants|shipped|edits]

Predicts (``--only variants``, ``--only shipped``): shapes 65,536 rows x
64 codes, 32 bins, k 1, trees from ``testing.random_chain`` /
``random_heap`` with seed 0: the RF serve (slot chains, T 50, depth 12, W
256), the ``gbt12`` serve (chains, T 20, depth 12, W 256) and the GBT
serve (heaps, T 20, depth 6). Per shape: the first design (``base``,
``experiments/forest_variants.cu``), each with one change (``+smem
codes``, ``+packed``, ``+2 rows a thread``), all three at once; then the
shipped kernel (its public wrapper) and its descent at the launch shapes
of ``SHAPES_SWEPT`` (rows and trees a thread, rows a block; ``--only
shipped`` times these alone). Every result is checked bit for bit
against the plain version; each time is the median of ``--runs``
CUDA-event timings of one call after warm-up, beside the device ms of its
kernels (``torch.profiler``).

Edits (``--only edits``): each of ``EDITS`` is the shipped source with
one change (the text it replaces, and the text it puts there), built
into ``_build/variants/`` and timed through the public functions at
``profile_hist.py``'s predict and leaf-sum shapes, in turns with the
shipped source (shipped, each edit, each edit again in reverse, shipped);
the leaf sums of every edit but the diagnostics are checked bit for bit
against the shipped kernel's.

Prints the card's name and power limit, then one JSON line per (shape,
kernel).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from ..ops import cuda_build
from ..ops import forest as F
from ..ops.cuda_build import ptr
from .. import profile_hist as PH
from ..profile_hist import pass_ms, time_ms
from ..testing import random_chain, random_heap

_P, _I = ctypes.c_void_p, ctypes.c_int

VARIANT = cuda_build.CudaKernel(
    "forest_variant", "../experiments/forest_variants.cu",
    "transmogrifai_tpu/ops/forest.py:503", [_I] * 3 + [_P] * 6 + [_I] * 7
    + [_P])
SWEEP = cuda_build.CudaKernel(
    "forest_sweep", "../experiments/forest_variants.cu",
    "transmogrifai_tpu/ops/forest.py:503", [_I] * 3 + [_P] * 7 + [_I] * 7
    + [_P])

ROWS, CODES, BINS = 65536, 64, 32
#: (tag, T, depth, W; W None for heaps)
SHAPES = (("RF serve", 50, 12, 256), ("gbt12 serve", 20, 12, 256),
          ("GBT serve", 20, 6, None))
#: (tag, smem codes, packed, rows a thread)
VARIANTS = (("base", 0, 0, 1), ("+smem codes", 1, 0, 1),
            ("+packed", 0, 1, 1), ("+2 rows a thread", 0, 0, 2),
            ("all three", 1, 1, 2))
#: the packed design's launch shapes: (rows a thread, trees a thread,
#: rows a block; 0 the shipped planner's); it ships at (1, 4, 0)
SHAPES_SWEPT = ((1, 1, 0), (2, 1, 0), (1, 2, 0), (2, 2, 0), (1, 4, 0),
                (1, 2, 128), (1, 2, 256), (1, 4, 256))


def variant(tabs, leaf, depth, W, smem_codes, packed, rpt):
    """One variant on (codes, feat, bins[, base]); leaf (T, W_out)."""
    codes = tabs[0]
    dev = codes.device
    n, d = codes.shape
    T, W_out = leaf.shape
    out = torch.empty(n, dtype=torch.float32, device=dev)
    base = tabs[3] if len(tabs) == 4 else None
    VARIANT.launch(smem_codes, packed, rpt, ptr(codes), ptr(tabs[1]),
                   ptr(tabs[2]), ptr(base), ptr(leaf), ptr(out), n, d, T,
                   depth, W or 0, W_out, dev.index,
                   torch.cuda.current_stream(dev).cuda_stream)
    return out[:, None]


def swept(tabs, leaf, depth, W, rpt, tpt, block_rows):
    """The packed design at one launch shape; leaf (T, W_out)."""
    codes = tabs[0]
    dev = codes.device
    n, d = codes.shape
    T, W_out = leaf.shape
    out = torch.empty(n, dtype=torch.float32, device=dev)
    base = tabs[3] if len(tabs) == 4 else None
    words = ctypes.c_longlong()
    SWEEP.entry("forest_sweep_workspace", [
        _I, _I, _I, ctypes.POINTER(ctypes.c_longlong)])(
            T, depth, W or 0, ctypes.byref(words))
    rec = torch.empty(words.value, dtype=torch.int32, device=dev)
    SWEEP.launch(rpt, tpt, block_rows, ptr(codes), ptr(tabs[1]),
                 ptr(tabs[2]), ptr(base), ptr(leaf), ptr(out), ptr(rec), n,
                 d, T, depth, W or 0, W_out, dev.index,
                 torch.cuda.current_stream(dev).cuda_stream)
    return out[:, None]



# ---------------------------------------------------------------------------
# Edits of the shipped source, timed and not taken
# ---------------------------------------------------------------------------

#: the shipped leaf sums' adds: peers matched once per (tree, 32 rows)
#: after the descent, a warp per (tree, stat), shuffle rounds
_MATCH_ONCE = """    for (int tt = 0; tt < ntt; ++tt)
      s_peers[tt * R + q] = __match_any_sync(
          0xffffffffu, q < nr ? s_ids[tt * R + q] : 0xffffu);
"""
_ROUNDS = """        float a = write ? acc[id * k] : 0.f;
        const int rounds = __reduce_max_sync(0xffffffffu, __popc(peers));
        unsigned m = peers;
        for (int r = 0; r < rounds; r += 4) {  // four shuffles in flight
          float x[4];
          unsigned mm = m;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            x[u] = __shfl_sync(0xffffffffu, v, mm ? __ffs(mm) - 1 : lane);
            mm &= mm - 1;
          }
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (m) a += x[u];
            m &= m - 1;
          }
        }
        if (write) acc[id * k] = a;
"""
_PEERS_READ = """        const unsigned peers = s_peers[tt * R + g + lane];
"""
_ADD_LOOP = "for (int p = warp; p < ntt * k; p += R >> 5) {"
_DESCENT = """        descend(tr, tree, row, base, depth, W, lc, slot);
#pragma unroll
        for (int u = 0; u < kTrees; ++u)
          if (tt + u < ntt)"""

#: (name, [(shipped text, its replacement)], checked against the shipped
#: leaf sums bit for bit)
EDITS = (
    # the first timed adds: the lowest lane of a leaf's group walks its
    # peers' stats in shared memory, one dependent load and add a peer
    ("adds: lowest lane walks its peers in shared memory",
     [(_ROUNDS, """        if (write) {
          const float* s = s_aug + g * k + c;
          float a = acc[id * k];
          for (unsigned m = peers; m; m &= m - 1)
            a += s[(__ffs(m) - 1) * k];
          acc[id * k] = a;
        }
""")], True),
    # __match_any_sync in the adds, once per (tree, stat, 32 rows)
    ("adds: peers matched per (tree, stat)",
     [(_MATCH_ONCE, ""),
      (_PEERS_READ, """        const unsigned peers = __match_any_sync(0xffffffffu, id);
""")], True),
    # one shuffle a round, none in flight
    ("adds: one shuffle a round",
     [(_ROUNDS, """        float a = write ? acc[id * k] : 0.f;
        const int rounds = __reduce_max_sync(0xffffffffu, __popc(peers));
        unsigned m = peers;
        for (int r = 0; r < rounds; ++r) {
          const float x = __shfl_sync(0xffffffffu, v,
                                      m ? __ffs(m) - 1 : lane);
          if (m) a += x;
          m &= m - 1;
        }
        if (write) acc[id * k] = a;
""")], True),
    ("code loads in flight: 4",
     [("constexpr int kStageLoads = 8;", "constexpr int kStageLoads = 4;")],
     True),
    ("code loads in flight: 1",
     [("constexpr int kStageLoads = 8;", "constexpr int kStageLoads = 1;")],
     True),
    ("leaf-sum tiles within 74 KB (three blocks an SM)",
     [("constexpr int kSumTarget = 113 * 1024;",
       "constexpr int kSumTarget = 74 * 1024;")], True),
    ("leaf-sum tiles within 150 KB (one block an SM)",
     [("constexpr int kSumTarget = 113 * 1024;",
       "constexpr int kSumTarget = 150 * 1024;")], True),
    ("combine: 16 chunk loads in flight",
     [("  for (int ch = 1; ch < n_chunks; ++ch) "
       "s += part[(long long)ch * m + i];",
       """#pragma unroll 16
  for (int ch = 1; ch < n_chunks; ++ch)
    s += __ldg(part + (long long)ch * m + i);""")], True),
    # the earlier column loop: one kernel for up to four columns, each add
    # (and count) behind a runtime test, issued for all four whatever k is
    ("predict: four columns behind a runtime count",
     [("""      case 1: err = go(predict_kernel<1>, done[0]); break;
      case 2: err = go(predict_kernel<2>, done[1]); break;
      case 3: err = go(predict_kernel<3>, done[2]); break;
      default: err = go(predict_kernel<4>, done[3]); break;""",
       """      default: err = go(predict_kernel<4>, done[3]); break;"""),
      ("""  for (int i = q; i < KC * slices; i += R) { // the pack pass's slices""",
       """  const int kc = min(KC, k - k0);
  for (int i = q; i < KC * slices; i += R) { // the pack pass's slices"""),
      ("""          for (int c = 0; c < KC; ++c) {
            const float v = __ldg(lv + c);""",
       """          for (int c = 0; c < KC; ++c) if (c < kc) {
            const float v = __ldg(lv + c);"""),
      ("""    for (int c = 0; c < KC; ++c)
      out[(row0 + q) * k + k0 + c] =""",
       """    for (int c = 0; c < KC; ++c)
      if (c < kc) out[(row0 + q) * k + k0 + c] =""")], True),
    ("diagnostic: predict with no Inf count",
     [("""            acc[c] += v;
            hit[c] += isinf(v);""", """            acc[c] += v;""")], True),
    # diagnostics: what the adds and the descent take
    ("diagnostic: no adds",
     [(_ADD_LOOP, "for (int p = warp; p < 0; p += R >> 5) {")], False),
    ("diagnostic: no descent (leaf ids from the row)",
     [(_DESCENT, """#pragma unroll
        for (int u = 0; u < kTrees; ++u)
          slot[u] = (q * 37 + tt + u + row[u]) % W_out;
#pragma unroll
        for (int u = 0; u < kTrees; ++u)
          if (tt + u < ntt)""")], False),
)

_KERNELS = ("FOREST_PREDICT_HEAP", "FOREST_PREDICT_CHAIN",
            "FOREST_LEAF_SUMS_HEAP", "FOREST_LEAF_SUMS_CHAIN")


def edited(name: str, changes) -> dict:
    """The shipped kernels built from the source with ``changes``:
    {module attribute: CudaKernel}."""
    src = (cuda_build.CSRC_DIR / "forest_predict.cu").read_text()
    for old, new in changes:
        if src.count(old) != 1:
            raise ValueError(f"edit {name!r} no longer applies")
        src = src.replace(old, new)
    slug = "".join(ch if ch.isalnum() else "_" for ch in name)[:48]
    path = cuda_build.BUILD_DIR / "variants" / f"{slug}.cu"
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(src)
    rel = os.path.relpath(path, cuda_build.CSRC_DIR)
    return {a: cuda_build.CudaKernel(getattr(F, a).name, rel,
                                     getattr(F, a).replaces,
                                     getattr(F, a).argtypes)
            for a in _KERNELS}


def run_edits(runs: int) -> None:
    """The shipped source and each edit in turns, at profile_hist.py's
    predict and leaf-sum shapes."""
    shipped = {a: getattr(F, a) for a in _KERNELS}
    kernels = {"shipped": shipped}
    for name, changes, _ in EDITS:
        kernels[name] = edited(name, changes)
    cuda_build.build([next(iter(k.values())).source
                      for k in kernels.values()])
    rng = np.random.RandomState(3)
    c = {key: torch.from_numpy(v).cuda() for key, v in random_chain(
        rng, PH.ROWS, PH.CODES, 50, 12, 256, 1, PH.NODE_BINS).items()}
    aug = torch.from_numpy(rng.rand(PH.ROWS, 3).astype(np.float32)).cuda()

    def sums():
        return F.forest_leaf_sums_chain(c["codes"], c["feat"], c["bins"],
                                        c["base"], aug, n_bins=PH.NODE_BINS)
    want = sums()
    checked = {name: check for name, _, check in EDITS}
    names = list(kernels)
    for turn, name in enumerate(names + names[::-1]):
        for attr, k in kernels[name].items():
            setattr(F, attr, k)
        same = bool(torch.equal(sums(), want))
        if checked.get(name, True) and not same:
            raise AssertionError(f"{name}: leaf sums differ from the "
                                 f"shipped kernel's")
        for r in PH.profile_predict(runs) + PH.profile_leaf_sums(runs):
            print(json.dumps(dict(turn=turn + 1, kernel=name,
                                  bit_equal=same, **r)), flush=True)
    for attr, k in shipped.items():
        setattr(F, attr, k)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=25)
    ap.add_argument("--only", choices=("variants", "shipped", "edits"),
                    default=None, help="time only the first design's "
                    "variants, only the shipped kernel's launch shapes, or "
                    "only the edits of the shipped source")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("forest_variants: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    if args.only in (None, "edits"):
        run_edits(args.runs)
    if args.only == "edits":
        return 0
    rng = np.random.RandomState(0)
    for tag, T, depth, W in SHAPES:
        if W is None:
            f = random_heap(rng, ROWS, CODES, T, depth, 1, BINS)
            keys = ("codes", "feat", "bins")
        else:
            f = random_chain(rng, ROWS, CODES, T, depth, W, 1, BINS)
            keys = ("codes", "feat", "bins", "base")
        tabs = [torch.from_numpy(f[k]).to(dev) for k in keys]
        leaf = torch.from_numpy(f["leaf"]).to(dev)
        leaf1 = leaf[:, :, 0].contiguous()
        if W is None:
            want = F.forest_predict_plain(*tabs, leaf, depth=depth,
                                          n_bins=BINS)

            def shipped():
                return F.forest_predict_heap_cuda(*tabs, leaf, depth=depth,
                                                  n_bins=BINS)[0]
        else:
            want = F.forest_predict_chain_plain(*tabs, leaf, n_bins=BINS)

            def shipped():
                return F.forest_predict_chain_cuda(*tabs, leaf,
                                                   n_bins=BINS)[0]
        calls = []
        if args.only != "shipped":
            calls += [(name, lambda s=s, p=p, r=r: variant(
                tabs, leaf1, depth, W, s, p, r))
                for name, s, p, r in VARIANTS]
        if args.only != "variants":
            calls.append(("shipped", shipped))
            calls += [(f"packed, {r} rows x {u} trees a thread, "
                       f"{b or 'planned'} rows a block",
                       lambda r=r, u=u, b=b: swept(
                           tabs, leaf1, depth, W, r, u, b))
                      for r, u, b in SHAPES_SWEPT]
        for name, fn in calls:
            got = fn()
            torch.cuda.synchronize()
            print(json.dumps(dict(
                shape=tag, kernel=name,
                bit_equal=bool(torch.equal(got, want)),
                ms=time_ms(fn, args.runs),
                device_ms=sum(pass_ms(fn, args.runs).values()))), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
