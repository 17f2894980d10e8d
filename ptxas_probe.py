#!/usr/bin/env python3
"""What ptxas allocates to the consumer warpgroups of a 384-thread block
after ``setmaxnreg.inc 240``, and what it makes of the D 256 flash
backward's pass 1 at other part sizes.

    python3 ptxas_probe.py [--out DIR]

Compiles for ``sm_90a`` (``nvcc -cubin -Xptxas -v``, all builds started
together) and reads each kernel's ``-Xptxas -v`` lines, its C7512 warning
("wgmma.mma_async instructions are serialized due to insufficient
register resources") and, from ``cuobjdump -sass``, the highest register
its code touches (``R<n>``; a thread holds R0 .. R<n>):

* ``live``: a probe kernel of one producer and two consumer warpgroups
  (``__launch_bounds__(384, 1)``) whose consumers hold N f32 values live
  across a loop, N = 128 .. 224; built with the producer's
  ``setmaxnreg.dec 24`` and the consumers' ``setmaxnreg.inc 240`` (as the
  flash kernels do), without them, and at 256 threads a block (255
  registers at launch) for the same code under a higher cap;
* ``csrc/flash_attention.cu`` as it is (pass 1 in 16-row parts,
  ``Bwd256::QS``) and copies with 32- and 64-row parts (``hopper.cuh``
  given the 64 x 32 score product that 32-row parts take), for the D 256
  forward and both backward passes.

Writes every log to ``DIR`` (default a temporary directory) and prints one
line a kernel and build, then one JSON line.  Needs ``nvcc`` and
``cuobjdump`` (the CUDA toolkit), no card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import re
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "src" / "repro_torch" / "kernels" \
    / "csrc"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-cubin", "-Xptxas", "-v"]
LIVE_COUNTS = (128, 160, 192, 224)
PART_ROWS = (16, 32, 64)
QS_LINE = "static constexpr int QS = 16;"
# hopper.cuh has no 64 x 32 score product, which 32-row parts need: the
# copies get one, before the 64 x 64 one.
N32_AT = "// d (64 x 64, f32) (+)= A (64 x 16) * B (16 x 64), both from shared"
N32_SS = ("""// d (64 x 32, f32) (+)= A (64 x 16) * B (16 x 32), both from shared memory.
template <int TA, int TB, typename T>
__device__ __forceinline__ void wgmma_ss(float (&d)[16], uint64_t da,
                                         uint64_t db, int accumulate) {
#define REPRO_WG_SS(TY) \\
  asm volatile("{\\n.reg .pred p;\\nsetp.ne.b32 p, %18, 0;\\n" \\
               "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \\
               "{""" + ", ".join(f"%{i}" for i in range(16)) + """}, " \\
               "%16, %17, p, 1, 1, %19, %20;\\n}\\n" \\
               : """ + ", ".join(f'"+f"(d[{i}])' for i in range(16)) + """ \\
               : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB))
  if constexpr (std::is_same<T, __half>::value)
    REPRO_WG_SS("f16");
  else
    REPRO_WG_SS("bf16");
#undef REPRO_WG_SS
}

""")
# Kernels of flash_attention.cu read (the bf16 instantiations).
FLASH_KERNELS = ("flash_fwd_kernelI13__nv_bfloat16Li256",
                 "flash_bwd256_dkv_kernelI13__nv_bfloat16",
                 "flash_bwd256_dq_kernelI13__nv_bfloat16")

LIVE_SRC = r"""
// N f32 values live across a loop in each consumer thread.
template <int N>
__global__ void __launch_bounds__(THREADS, 1)
    live(const float* __restrict__ x, float* __restrict__ y, int n) {
  if (threadIdx.x < 128) {
#if SETMAXNREG
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
#endif
    return;
  }
#if SETMAXNREG
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
#endif
  float acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = x[i * 384 + threadIdx.x];
  for (int j = 0; j < n; ++j) {
    const float a = x[j + threadIdx.x];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = fmaf(acc[i], a, acc[(i + 1) % N]);
  }
#pragma unroll
  for (int i = 0; i < N; ++i) y[i * 384 + threadIdx.x] = acc[i];
}
""" + "".join(f"template __global__ void live<{n}>(const float*, float*, "
              f"int);\n" for n in LIVE_COUNTS)


def tool(name: str) -> str:
    found = shutil.which(name) or f"/usr/local/cuda/bin/{name}"
    if not Path(found).exists():
        raise SystemExit(f"{name} not found (PATH or /usr/local/cuda/bin)")
    return found


def ptxas_report(log: str) -> dict:
    """Per mangled kernel name: its ``-Xptxas -v`` lines and whether a
    C7512 warning names it."""
    out, fn = {}, ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1]
            out.setdefault(fn, {"ptxas": [], "c7512": False})
        elif "(C7512)" in line:
            name = line.rsplit("'", 2)[-2]
            out.setdefault(name, {"ptxas": [], "c7512": False})["c7512"] = True
        elif fn and ("registers" in line or "spill" in line):
            out[fn]["ptxas"].append(line.split(":", 1)[-1].strip()
                                    if "ptxas" in line else line.strip())
    return out


def sass_highest(sass: str) -> dict:
    """Per mangled kernel name: the highest R<n> its SASS touches."""
    out, fn = {}, ""
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            fn = m.group(1)
            out[fn] = -1
        elif fn:
            regs = [int(r) for r in re.findall(r"\bR(\d+)\b", line)]
            if regs:
                out[fn] = max(out[fn], *regs)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args()
    nvcc, cuobjdump = tool("nvcc"), tool("cuobjdump")
    out = args.out or Path(tempfile.mkdtemp(prefix="ptxas_probe_"))
    out.mkdir(parents=True, exist_ok=True)
    builds = {}  # name -> (source, extra flags)
    (out / "live.cu").write_text(LIVE_SRC)
    for name, threads, smr in (("live_setmaxnreg", 384, 1),
                               ("live_plain", 384, 0),
                               ("live_256threads", 256, 0)):
        builds[name] = (out / "live.cu",
                        [f"-DTHREADS={threads}", f"-DSETMAXNREG={smr}"])
    for rows in PART_ROWS:
        src = out / f"csrc_qs{rows}"
        shutil.copytree(CSRC, src, dirs_exist_ok=True)
        cu = src / "flash_attention.cu"
        text = cu.read_text()
        if QS_LINE not in text:
            raise SystemExit(f"{QS_LINE!r} not in flash_attention.cu")
        cu.write_text(text.replace(QS_LINE,
                                   f"static constexpr int QS = {rows};"))
        if rows == 32:
            cuh = src / "hopper.cuh"
            cuh.write_text(cuh.read_text().replace(N32_AT, N32_SS + N32_AT))
        builds[f"flash_qs{rows}"] = (cu, [])
    procs = {name: subprocess.Popen(
        [nvcc, *FLAGS, *extra, "-o", str(out / f"{name}.cubin"), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, (src, extra) in builds.items()}
    result, failed = {}, []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        (out / f"{name}.ptxas").write_text(log)
        if proc.returncode:
            failed.append(name)
            print(f"{name}: nvcc exit {proc.returncode}\n{log[-4000:]}")
            continue
        sass = subprocess.run([cuobjdump, "-sass", str(out / f"{name}.cubin")],
                              capture_output=True, text=True, check=True).stdout
        (out / f"{name}.sass").write_text(sass)
        rep, high = ptxas_report(log), sass_highest(sass)
        for fn, r in rep.items():
            if name.startswith("flash") and not any(k in fn for k in
                                                    FLASH_KERNELS):
                continue
            key = f"{name} {fn}"
            result[key] = dict(r, sass_highest=high.get(fn))
            print(f"{key} | {' | '.join(r['ptxas'])} | C7512 "
                  f"{'yes' if r['c7512'] else 'no'} | SASS highest register "
                  f"R{high.get(fn)}")
    print(f"logs in {out}")
    print(json.dumps({"kernels": result, "failed": failed}))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
