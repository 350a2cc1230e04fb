"""Where the time of one ``embedding_bag`` launch goes, on the card.

    python3 tools/bag_phases.py

Builds four variants of ``src/repro_torch/kernels/csrc/embedding_bag.cu``
into ``build/bag_phases/`` (``nvcc``, one process each, all at once):
the kernel cut after its span search (``search``), without its row
gather (``no_gather``) and without its sum (``no_sum``), and the kernel
with a clock read by thread 0 of each block at each phase's end
(``trace``).  Then, at deepfm's and two-tower's ``embedding_bag`` shapes
(``chip_smoke.py``'s ``BAG_SHAPES``, 4,096 bags of 0..64 ids, weighted,
float32 and bfloat16), prints the kernel's time beside each variant's
(``chip_smoke.time_ms``) and the traced phases of one launch over its
blocks (p50, p90, max): search, stage (the first chunk's ids and
weights), gather (until the first chunk's rows have landed) and rest
(the first chunk's sum, then any later chunk's gather and sum).
The variants give wrong results and exist only to be timed.  Needs one
card; exits 2 without one.
"""
from __future__ import annotations

import ctypes
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "src"))
sys.path.insert(1, REPO)

SRC = os.path.join(REPO, "src", "repro_torch", "kernels", "csrc",
                   "embedding_bag.cu")
OUT = os.path.join(REPO, "build", "bag_phases")

# phase ends, in order: after the search's barrier, after the first
# chunk's staging barrier, after the barrier on its landed rows, after
# the sums (before the store)
_TRACE = [
    ("namespace {\n",
     "__device__ unsigned long long g_phase[1 << 16];\n"
     "extern \"C\" int phase_read(void* dst) {\n"
     "  return (int)cudaMemcpyFromSymbol(dst, g_phase, sizeof(g_phase));\n"
     "}\n"
     "extern \"C\" int phase_clear() {\n"
     "  void* p = nullptr;\n"
     "  cudaError_t e = cudaGetSymbolAddress(&p, g_phase);\n"
     "  return (int)(e ? e : cudaMemset(p, 0, sizeof(g_phase)));\n"
     "}\nnamespace {\n"),
    ("  for (int t = tid; t <= nb; t += kThreads) start[t] = LLONG_MAX;\n",
     "  unsigned long long* ph = g_phase + (blockIdx.x + gridDim.x * "
     "blockIdx.y) * 5 % (1 << 16);\n"
     "  if (tid == 0) ph[0] = clock64();\n"
     "  for (int t = tid; t <= nb; t += kThreads) start[t] = LLONG_MAX;\n"),
    ("  const long long lo = span[0], hi = span[1];\n",
     "  const long long lo = span[0], hi = span[1];\n"
     "  if (tid == 0) ph[1] = clock64();\n"),
    ("    stage(lo, size(0), 0);\n    __syncthreads();\n",
     "    stage(lo, size(0), 0);\n    __syncthreads();\n"
     "    if (tid == 0) ph[2] = clock64();\n"),
    ("      __syncthreads();                    // every thread's\n",
     "      __syncthreads();                    // every thread's\n"
     "      if (tid == 0 && c == 0) ph[3] = clock64();\n"),
    ("  if (active) out[(b0 + t)",
     "  if (tid == 0) ph[4] = clock64();\n  if (active) out[(b0 + t)"),
]
VARIANTS = {
    "search": [("  if (n_chunks > 0) {\n",
                "  if (false && n_chunks > 0) {\n")],
    "no_gather": [("    gather(size(0), 0);\n", ""),
                  ("      if (c + 1 < n_chunks) "
                   "gather(size(c + 1), q ^ 1);\n", "")],
    "no_sum": [("      sum(lo + c * chunk, size(c), q);\n", "")],
    "trace": _TRACE,
}
PHASES = ("search", "stage", "gather", "rest")


def build_variants() -> dict:
    """{variant: its ctypes library}, each compiled from the kernel's
    source with its edits; raises if an edit's anchor is gone."""
    from repro_torch.kernels import build
    os.makedirs(OUT, exist_ok=True)
    text = open(SRC).read()
    procs = {}
    for name, edits in VARIANTS.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise RuntimeError(f"{name}: the kernel's source no longer "
                                   f"holds {old!r}")
            src = src.replace(old, new)
        cu = os.path.join(OUT, f"{name}.cu")
        with open(cu, "w") as f:
            f.write(src)
        so = os.path.join(OUT, f"lib{name}.so")
        procs[name] = (so, subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-o",
             so, cu], stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    libs = {}
    for name, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log.decode()}")
        libs[name] = ctypes.CDLL(so)
    return libs


def launch(lib, table, ids, seg, b, w, plan):
    import torch
    from repro_torch.kernels.embedding_bag.embedding_bag import _ARGTYPES
    fn = lib.embedding_bag_launch
    fn.argtypes = _ARGTYPES
    out = torch.empty((b, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    err = fn(table.data_ptr(), table.element_size(), table.shape[0],
             table.shape[1], ids.data_ptr(), seg.data_ptr(),
             ids.element_size(), w.data_ptr(), ids.numel(), out.data_ptr(),
             b, plan.vec, plan.tile, plan.chunk, plan.slab, plan.grid_x,
             plan.grid_y, plan.threads, plan.smem,
             torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"launch failed: CUDA error {err}")
    return out


def phases(lib, table, ids, seg, b, w, plan) -> str:
    """One traced launch: each phase's microseconds over the blocks."""
    import numpy as np
    import torch
    if lib.phase_clear():
        raise RuntimeError("clearing the phase clocks failed")
    launch(lib, table, ids, seg, b, w, plan)
    torch.cuda.synchronize()
    buf = np.zeros(1 << 16, np.uint64)
    read = lib.phase_read
    read.argtypes = [ctypes.c_void_p]
    if read(buf.ctypes.data):
        raise RuntimeError("reading the phase clocks failed")
    blocks = min(plan.grid_x * plan.grid_y, (1 << 16) // 5)
    ph = buf[:blocks * 5].reshape(blocks, 5).astype(np.float64)
    ghz = torch.cuda.get_device_properties(0).clock_rate / 1e6
    ok = (ph > 0).all(1)            # a block of no ids stages nothing
    us = np.diff(ph[ok], axis=1) / ghz / 1e3
    return "; ".join(
        f"{name} {np.percentile(us[:, i], 50):.3f}/"
        f"{np.percentile(us[:, i], 90):.3f}/{us[:, i].max():.3f}"
        for i, name in enumerate(PHASES)) + (
        f" us (p50/p90/max over {int(ok.sum())} blocks with ids, clock "
        f"{ghz:.2f} GHz)")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("bag_phases: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from chip_smoke import BAG_BATCH, BAG_SHAPES, bag_inputs, card_line, \
        time_ms
    from repro_torch.kernels import build
    from repro_torch.kernels.embedding_bag import embedding_bag
    from repro_torch.kernels.embedding_bag.embedding_bag import bag_plan
    print(card_line())
    libs = build_variants()
    for v, d, what in BAG_SHAPES:
        table = torch.randn((v, d), device="cuda")
        ids, seg, w = bag_inputs(BAG_BATCH, v, d, seed=BAG_BATCH + d)
        for dtype in (torch.float32, torch.bfloat16):
            t, ww = table.to(dtype), w.to(dtype)
            plan = bag_plan(BAG_BATCH, d, t.element_size(),
                            ids.element_size(), build.sm_count(t.device))
            times = {"kernel": time_ms(
                lambda: embedding_bag(t, ids, seg, BAG_BATCH, ww))[0]}
            for name in ("search", "no_gather", "no_sum"):
                times[name] = time_ms(lambda: launch(
                    libs[name], t, ids, seg, BAG_BATCH, ww, plan))[0]
            print(f"{what}: V={v} d={d} B={BAG_BATCH} nnz={ids.numel()} "
                  f"{dtype} weighted, {plan}")
            print("  ms: " + ", ".join(f"{k} {x:.5f}"
                                       for k, x in times.items()))
            print("  phases: " + phases(libs["trace"], t, ids, seg,
                                        BAG_BATCH, ww, plan))
            del t, ww
        del table, ids, seg, w
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
