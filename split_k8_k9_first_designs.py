"""Where the time of K8's and K9's first designs went, measured before
their redesign: each is built again with one cost taken out or changed by
a substitution in its source text, and every variant is timed, with its
registers (`nvcc -Xptxas -v`) and its result's digest. One JSON line.

- K8 (`brute_trace.cu`, one thread a ray, nine scalar shared reads and an
  IEEE `1.0f / det` a pair) on the four ray sets of the third 1080p
  Cornell frame: `rcp_approx` (the division as `__fdividef`), `vec_loads`
  (a triangle as three float4 reads of shared memory), `both`, and `k1`
  (K1's source of the same tree, on the same inputs).
- K9 (`microstep.cu`, the node table read with `__ldg` by `fetch`,
  `reduce` and `full`, a 1,024-thread `__syncthreads_or` a step), its five
  variants at 64 packets x 4096 steps: `smem_table` (`reduce` and `full`
  read the table from shared memory, as `onehot` does), `no_test` (the box
  test replaced by one compare of the record: the chain without the test),
  `barrier_alone` (no read and no test: the index arithmetic, the barrier
  and the successor), `no_barrier` (the any() as a warp vote).

Only `vec_loads` and `smem_table` keep the kernels' results; the rest are
for timing. The substitutions match the texts of those first designs, not
this tree's: point `--csrc` at the `capsaicin_tpu_torch/csrc` of a tree
that holds them (`git archive` of the commit before the redesign),

    python3 split_k8_k9_first_designs.py --csrc DIR [--iters 20]

from the root of this tree. GPU only. Builds under
`capsaicin_tpu_torch/_build/split/`. This tree's kernels are split by
`capsaicin_tpu_torch/tools/split_times.py`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import torch

from capsaicin_tpu_torch import kernels as K
from capsaicin_tpu_torch.tools.split_times import build_variants, registers, time_k1, time_k9
from capsaicin_tpu_torch.tools.stencil_times import session
from capsaicin_tpu_torch.tools.stream_times import frame_rays

K8_RCP = [("const float inv_det = det_ok ? 1.0f / det : 0.0f;",
           "const float inv_det = det_ok ? __fdividef(1.0f, det) : 0.0f;")]
K8_VEC = [
    ("__shared__ float s_tris[BRUTE_TILE * 9];", "__shared__ float4 s_tris[BRUTE_TILE * 3];"),
    ("s_tris[i] = tris[9 * base + i];",
     "reinterpret_cast<float*>(s_tris)[(i / 3) * 4 + i % 3] = tris[9 * base + i];"),
    ("const float* tr = s_tris + 9 * j;\n"
     "      const float v0x = tr[0], v0y = tr[1], v0z = tr[2];\n"
     "      const float e1x = tr[3], e1y = tr[4], e1z = tr[5];\n"
     "      const float e2x = tr[6], e2y = tr[7], e2z = tr[8];",
     "const float4 ta = s_tris[3 * j], tb = s_tris[3 * j + 1], tc = s_tris[3 * j + 2];\n"
     "      const float v0x = ta.x, v0y = ta.y, v0z = ta.z;\n"
     "      const float e1x = tb.x, e1y = tb.y, e1z = tb.z;\n"
     "      const float e2x = tc.x, e2y = tc.y, e2z = tc.z;"),
]
K8_VARIANTS = {"parent": [], "rcp_approx": K8_RCP, "vec_loads": K8_VEC,
               "both": K8_RCP + K8_VEC}

K9_SMEM = [
    ("  if (VARIANT == 2) {\n    for (int i = t;", "  if (VARIANT >= 2) {\n    for (int i = t;"),
    ("    if (VARIANT == 2) {\n#pragma unroll", "    if (VARIANT >= 2) {\n#pragma unroll"),
    ("    case 3: microstep_kernel<3><<<grid, block, 0, stream>>>(rays, nodes, steps, out); break;\n"
     "    case 4: microstep_kernel<4><<<grid, block, 0, stream>>>(rays, nodes, steps, out); break;",
     "    case 3: case 4: {\n"
     "      const int smem = MS_ROWS * MS_RECS * MS_KEEP * (int)sizeof(float);\n"
     "      cudaFuncSetAttribute(microstep_kernel<3>, cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
     "                           smem);\n"
     "      cudaFuncSetAttribute(microstep_kernel<4>, cudaFuncAttributeMaxDynamicSharedMemorySize,\n"
     "                           smem);\n"
     "      if (variant == 3)\n"
     "        microstep_kernel<3><<<grid, block, smem, stream>>>(rays, nodes, steps, out);\n"
     "      else\n"
     "        microstep_kernel<4><<<grid, block, smem, stream>>>(rays, nodes, steps, out);\n"
     "      break;\n"
     "    }"),
]
K9_NO_TEST = [("const bool hit = ms_aabb(b[0], b[1], b[2], b[3], b[4], b[5], ox, oy, oz, ix, iy, iz, tmin,\n"
               "                             t_best);", "const bool hit = b[0] + b[1] < 0.0f;")]
K9_NO_READ = [("const float4 lo = __ldg(reinterpret_cast<const float4*>(nodes + 8 * rec));\n"
               "      const float4 hi = __ldg(reinterpret_cast<const float4*>(nodes + 8 * rec + 4));",
               "const float4 lo = make_float4((float)(rec % 7) - 3.0f, (float)(rec % 5) - 2.0f, 0.0f,\n"
               "                                     0.0f), hi = lo;")]
K9_NO_BARRIER = [("const bool any_box = __syncthreads_or(hit);",
                  "const bool any_box = __any_sync(0xffffffffu, hit);")]
K9_VARIANTS = {"parent": [], "smem_table": K9_SMEM, "no_test": K9_NO_TEST,
               "barrier_alone": K9_NO_TEST + K9_NO_READ, "no_barrier": K9_NO_BARRIER}

KERNELS = {
    "k8": ("brute_trace.cu", None,
           {**{n: ([("src", *sub) for sub in v], []) for n, v in K8_VARIANTS.items()},
            "k1": ([], [], "static_trace.cu")}),
    "k9": ("microstep.cu", None,
           {n: ([("src", *sub) for sub in v], []) for n, v in K9_VARIANTS.items()}),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", required=True, help="the csrc directory of the first designs")
    ap.add_argument("--iters", type=int, default=20, help="timed calls after one warm-up")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    libs = build_variants(os.path.abspath(args.csrc), os.path.join(K.BUILD_ROOT, "split"),
                          KERNELS)
    stream = torch.cuda.current_stream().cuda_stream
    s = session()
    calls = frame_rays(s)
    result = {"device": smi, "k8": {}, "k9": {}}
    for (kernel, name), (lib, log) in libs.items():
        handle = ctypes.CDLL(lib)
        entry = {"registers": registers(log)}
        if kernel == "k9":
            entry.update(time_k9(handle, args.iters, stream))
        else:
            symbol = "static_trace" if name == "k1" else "brute_trace"
            entry.update(time_k1(handle, calls, s.accel.tris, args.iters, stream, symbol))
        result[kernel][name] = entry
        print(f"{kernel} {name}: {entry}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
