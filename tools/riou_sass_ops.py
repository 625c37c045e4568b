#!/usr/bin/env python3
"""SASS instructions of the operations the rotated IoU is built from, as
the port's rotated-IoU kernels compile them (``nvcc -fmad=false``,
``sm_90a``), on the machine with the card's toolkit.

    python3 tools/riou_sass_ops.py [OUT_DIR]

Compiles one probe kernel per operation (an IEEE float32 division, ``cosf``,
``sinf``, both of one angle, and a float add as the baseline) into a cubin,
disassembles it with ``cuobjdump -sass`` and prints, for each probe, the
instructions of its fast path less the baseline's (the loads, the index and
the store): the path from the entry to ``EXIT`` on which every forward
conditional branch is taken and every backward one is not — the branch
over the division's call of its subnormal and overflow path, and over the
trig functions' range reduction for |angle| >= 105615, which the boxes'
angles in [-pi/2, pi/2) never need.  Also the instructions to the first
``EXIT`` (slow paths placed before it included), the branches, and the
listing itself (also written to ``OUT_DIR/riou_sass_ops.txt`` when given).
chip_smoke.py's rotated-IoU operation counts take the division's and the
trig functions' weights from the fast paths.
"""

from __future__ import annotations

import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

PROBES = r'''
extern "C" __global__ void probe_base(const float* a, const float* b, float* o) {
  int i = threadIdx.x; o[i] = a[i] + b[i];
}
extern "C" __global__ void probe_div(const float* a, const float* b, float* o) {
  int i = threadIdx.x; o[i] = a[i] / b[i];
}
extern "C" __global__ void probe_cos(const float* a, const float* b, float* o) {
  int i = threadIdx.x; o[i] = cosf(a[i]) + b[i];
}
extern "C" __global__ void probe_sin(const float* a, const float* b, float* o) {
  int i = threadIdx.x; o[i] = sinf(a[i]) + b[i];
}
extern "C" __global__ void probe_cos_sin(const float* a, const float* b, float* o) {
  int i = threadIdx.x; o[i] = cosf(a[i]) * b[i] + sinf(a[i]);
}
'''
# instructions a probe adds to the baseline beyond the operation itself (the
# division takes the place of the baseline's add)
EXTRA = {"probe_div": -1, "probe_cos": 0, "probe_sin": 0, "probe_cos_sin": 1}


def _tool(name):
    return shutil.which(name) or f"/usr/local/cuda/bin/{name}"


def _fast_path(ins) -> int:
    """Instructions executed from the entry to EXIT when every forward
    conditional branch is taken and every backward one is not."""
    at = {a: k for k, (a, _) in enumerate(ins)}
    k, n = 0, 0
    while k < len(ins) and n < 10 * len(ins):
        a, op = ins[k]
        n += 1
        if re.match(r"(@!?U?P\d+ )?EXIT\b", op):
            return n
        m = re.match(r"(@!?U?P\d+ )?BRA (0x[0-9a-f]+)", op)
        if m and int(m.group(2), 16) > a:
            k = at[int(m.group(2), 16)]
            continue
        k += 1
    raise RuntimeError("no EXIT on the fast path")


def main() -> int:
    out_dir = Path(sys.argv[1]) if len(sys.argv) > 1 else None
    with tempfile.TemporaryDirectory() as d:
        src, cubin = Path(d) / "probes.cu", Path(d) / "probes.cubin"
        src.write_text(PROBES)
        subprocess.run([_tool("nvcc"), "-gencode", "arch=compute_90a,code=sm_90a",
                        "-O3", "-fmad=false", "-cubin", "-o", str(cubin),
                        str(src)], check=True)
        sass = subprocess.run([_tool("cuobjdump"), "-sass", str(cubin)],
                              capture_output=True, text=True, check=True).stdout
    funcs, cur = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            cur = funcs.setdefault(line.split("Function :")[1].strip(), [])
        elif cur is not None:
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?);", line)
            if m:
                cur.append((int(m.group(1), 16), m.group(2).strip()))
    to_exit = {name: next((k for k, (_, op) in enumerate(ins)
                           if re.match(r"(@!?U?P\d+ )?EXIT\b", op)), len(ins))
               for name, ins in funcs.items()}
    fast = {name: _fast_path(ins) for name, ins in funcs.items()}
    lines = []
    for name in ("probe_div", "probe_cos", "probe_sin", "probe_cos_sin"):
        ins = funcs[name]
        branches = [f"{a:#06x}: {op}" for a, op in ins[:to_exit[name]]
                    if re.search(r"\b(BRA|CALL|BSSY|BSYNC|RET)\b", op)]
        lines.append(
            f"{name}: fast path {fast[name] - fast['probe_base'] - EXTRA[name]}"
            f" instructions beyond the baseline ({fast[name]} against "
            f"{fast['probe_base']}); {to_exit[name] - to_exit['probe_base']}"
            f" to the first EXIT; branches {branches}")
    listing = "\n".join(f"--- {name}\n" + "\n".join(
        f"{a:#06x}  {op}" for a, op in ins) for name, ins in funcs.items())
    print("\n".join(lines))
    print(listing)
    if out_dir is not None:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "riou_sass_ops.txt").write_text(
            "\n".join(lines) + "\n" + listing + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
