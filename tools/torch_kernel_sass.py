"""What the port's kernels compile to on Hopper, from their SASS.

    python tools/torch_kernel_sass.py [--out sass.json]

Builds the kernel library (mageslam_tpu_torch/ops/_build.py; what ptxas
reports of each kernel is printed when this call builds it) and counts,
per kernel in `cuobjdump -sass` of it, the tensor-core instructions (IMMA,
BMMA, HMMA), POPC, and the global stores by width (STG.E.128 is a 16-byte
store). Then compiles three one-instruction probes for sm_90a, the distance
tile's candidate forms, and reports whether ptxas takes each and what it
becomes:
  - int8:     mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (the form the
              tile uses, csrc/hamming_tile.cuh);
  - b1 and:   mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc;
  - b1 xor:   the same with .xor.popc.
Needs nvcc and cuobjdump (the CUDA toolkit); no GPU is used.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from mageslam_tpu_torch.ops import _build  # noqa: E402

COUNTED = ("IMMA", "BMMA", "HMMA", "POPC", "STG", "STS", "LDS", "LDGSTS")

PROBE = r"""
extern "C" __global__ void probe(const unsigned* a, const unsigned* b, int* c) {
  const unsigned l = threadIdx.x;
  unsigned a0 = a[l], a1 = a[l + 32], a2 = a[l + 64], a3 = a[l + 96];
  unsigned b0 = b[l], b1 = b[l + 32];
  int d0 = 0, d1 = 0, d2 = 0, d3 = 0;
  asm volatile("mma.sync.aligned.FORM {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
               "{%8, %9}, {%0, %1, %2, %3};\n"
               : "+r"(d0), "+r"(d1), "+r"(d2), "+r"(d3)
               : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
  c[l] = d0 + d1 + d2 + d3;
}
"""
FORMS = {
    "int8": "m16n8k32.row.col.s32.s8.s8.s32",
    "b1 and": "m16n8k256.row.col.s32.b1.b1.s32.and.popc",
    "b1 xor": "m16n8k256.row.col.s32.b1.b1.s32.xor.popc",
}


def tool(name: str) -> str:
    path = os.path.join(os.path.dirname(_build._nvcc()), name)
    return path if os.path.exists(path) else name


def sass_counts(binary: str) -> dict[str, dict[str, int]]:
    """{kernel: {mnemonic: count}} from cuobjdump -sass of `binary`."""
    text = subprocess.run([tool("cuobjdump"), "-sass", binary], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = collections.Counter()
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if name and m:
            op = m.group(1)
            if op.split(".")[0] in COUNTED:
                out[name][op] += 1
    return {k: dict(sorted(v.items())) for k, v in out.items()}


def probe(form: str, workdir: str) -> dict:
    src = os.path.join(workdir, "probe.cu")
    cubin = os.path.join(workdir, "probe.cubin")
    with open(src, "w") as f:
        f.write(PROBE.replace("FORM", FORMS[form]))
    proc = subprocess.run([_build._nvcc(), "-cubin", "-gencode", "arch=compute_90a,code=sm_90a",
                           "-O3", "-o", cubin, src], capture_output=True, text=True)
    if proc.returncode != 0:
        return {"form": form, "accepted": False,
                "error": (proc.stdout + proc.stderr).strip().splitlines()[:3]}
    counts = sass_counts(cubin)
    return {"form": form, "ptx": f"mma.sync.aligned.{FORMS[form]}", "accepted": True,
            "sass": counts.get("probe", {})}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    path, _, log = _build.build()
    ptxas = [line.strip() for line in log.splitlines()
             if "Compiling entry" in line or "registers" in line or "spill" in line]
    for line in ptxas:
        print(f"[ptxas] {line}", flush=True)
    result = {"library": os.path.relpath(path, REPO), "ptxas": ptxas,
              "kernels": sass_counts(path)}
    for name, counts in result["kernels"].items():
        print(f"[sass] {name}: {counts}", flush=True)
    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as workdir:
        result["probes"] = [probe(form, workdir) for form in FORMS]
    for p in result["probes"]:
        print(f"[probe] {json.dumps(p)}", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
