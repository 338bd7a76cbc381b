"""Registers, spills and blocks an SM of the port's CUDA kernels on the card.

    python -m ml_function_tpu_torch.tools.occupancy SOURCE KERNEL@THREADS@SMEM ...
        [--out occupancy.json]

``SOURCE`` names a file of ``ops/kernels/csrc`` (``cin_bwd`` for
``csrc/cin_bwd.cu``). Each further argument names one kernel of it as a C++
expression (a template instance too: ``dw_kernel<128>``), its threads a
block and its dynamic shared memory in bytes, also a C++ expression that
may call the source's own helpers (``rows_smem_bytes(128, 26)``). The tool
compiles a small file that includes the source, so that its kernels, which
live in an anonymous namespace, are in reach, and asks the CUDA runtime for
``cudaFuncGetAttributes`` (registers a thread, static shared memory, local
memory a thread, which is where spills go) and
``cudaOccupancyMaxActiveBlocksPerMultiprocessor`` at that block size and
shared memory. Needs ``nvcc`` and a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import subprocess
from pathlib import Path

from ..ops.kernels import _build

_QUERY = """
extern "C" int query_{i}(int* out) {{
  cudaFuncAttributes a;
  const size_t smem = static_cast<size_t>({smem});
  cudaError_t err = cudaFuncSetAttribute({kernel},
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err == cudaSuccess) err = cudaFuncGetAttributes(&a, {kernel});
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = a.numRegs;
  out[1] = static_cast<int>(a.sharedSizeBytes);
  out[2] = static_cast<int>(a.localSizeBytes);
  out[3] = static_cast<int>(smem);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      out + 4, {kernel}, {threads}, smem));
}}
"""


def query(source: str, specs: list) -> list:
    """[(kernel, threads, smem)] of ``csrc/<source>.cu`` → one dict each."""
    src = _build.CSRC / f"{source}.cu"
    code = f'#include "{src}"\n' + "".join(
        _QUERY.format(i=i, kernel=k, threads=t, smem=s) for i, (k, t, s) in enumerate(specs))
    digest = hashlib.sha256(code.encode() + src.read_bytes()).hexdigest()[:12]
    _build.BUILD.mkdir(exist_ok=True)
    cu = _build.BUILD / f"occupancy-{source}-{digest}.cu"
    so = cu.with_suffix(".so")
    cu.write_text(code)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
                    str(cu)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    out = []
    for i, (kernel, threads, smem) in enumerate(specs):
        vals = (ctypes.c_int * 5)()
        fn = getattr(lib, f"query_{i}")
        fn.argtypes = [ctypes.c_void_p]
        err = fn(ctypes.addressof(vals))
        if err:
            raise RuntimeError(f"occupancy query of {kernel} failed with CUDA error {err}")
        out.append({"kernel": kernel, "threads": int(threads), "smem_expr": smem,
                    "registers": vals[0], "static_smem_bytes": vals[1],
                    "local_bytes": vals[2], "dynamic_smem_bytes": vals[3],
                    "blocks_per_sm": vals[4],
                    "warps_per_sm": vals[4] * -(-int(threads) // 32)})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("source")
    ap.add_argument("specs", nargs="+", help="KERNEL@THREADS@SMEM")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    rows = query(args.source, [tuple(s.split("@")) for s in args.specs])
    for r in rows:
        print(f"{args.source}: {r['kernel']}: {r['registers']} registers, "
              f"{r['local_bytes']} B local (spills), {r['static_smem_bytes']} B static + "
              f"{r['dynamic_smem_bytes']} B dynamic shared memory, {r['threads']} threads: "
              f"{r['blocks_per_sm']} blocks ({r['warps_per_sm']} warps) an SM")
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
