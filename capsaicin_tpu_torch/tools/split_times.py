"""Where the time of the first K1 (`static_trace.cu`) and K3
(`eaw_disocclusion.cu`) designs goes: each is built again with one cost
taken out or changed by a substitution in its source text, and every
variant is timed on the inputs of a 1080p Cornell frame (the third after a
reset, default options): K1 on the frame's four ray sets (primary closest,
direct shadow any-hit, bounce closest, NEE any-hit), K3 on the denoiser's
colour, geo and moments in float32 and bf16 storage. One JSON line, with
each variant's registers (`nvcc -Xptxas -v`) and its result's digest.

The variants of K1: `rcp_approx` (the IEEE `1.0f / det` as an approximate
reciprocal), `vec_loads` (a triangle as three float4 reads of shared
memory, not nine scalars), `early_u` (leave a triangle once det or u has
failed, before q, v and t: exact, the same results), `fmad` (built with
--fmad=true), `all` (the first three). Of K3: `intrinsics` (__powf,
__expf, __fdividef for the tap's transcendentals and divisions),
`clamp_bounds` (taps clamped into the image instead of skipped: no
branch), `both`, `no_moments` (the two moment sums left out). Only
`early_u` keeps K1's results; the rest are for timing.

The substitutions match the texts of those designs, so point `--csrc` at
the `capsaicin_tpu_torch/csrc` of a tree that has them:

    python3 -m capsaicin_tpu_torch.tools.split_times --csrc PATH [--iters 20]

GPU only. Builds under `capsaicin_tpu_torch/_build/split/`.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess

import torch

from capsaicin_tpu_torch import kernels as K
from capsaicin_tpu_torch.tools.stencil_times import device_ms, session, stencil_inputs
from capsaicin_tpu_torch.tools.stream_times import digest, frame_rays

NAMES = ("primary", "shadow", "bounce", "nee")

K1_VEC = [
    ("__shared__ float s_tris[STATIC_MAX_TRIS * 9];\n"
     "  for (int i = threadIdx.x; i < n_tris * 9; i += blockDim.x) s_tris[i] = tris[i];",
     "__shared__ float4 s_tris[STATIC_MAX_TRIS * 3];\n"
     "  for (int i = threadIdx.x; i < n_tris * 9; i += blockDim.x)\n"
     "    reinterpret_cast<float*>(s_tris)[(i / 3) * 4 + i % 3] = tris[i];"),
    ("const float* tr = s_tris + 9 * k;\n"
     "      const float v0x = tr[0], v0y = tr[1], v0z = tr[2];\n"
     "      const float e1x = tr[3], e1y = tr[4], e1z = tr[5];\n"
     "      const float e2x = tr[6], e2y = tr[7], e2z = tr[8];",
     "const float4 ta = s_tris[3 * k], tb = s_tris[3 * k + 1], tc = s_tris[3 * k + 2];\n"
     "      const float v0x = ta.x, v0y = ta.y, v0z = ta.z;\n"
     "      const float e1x = tb.x, e1y = tb.y, e1z = tb.z;\n"
     "      const float e2x = tc.x, e2y = tc.y, e2z = tc.z;"),
]
K1_RCP = [("det_ok ? 1.0f / det : 0.0f", "det_ok ? __fdividef(1.0f, det) : 0.0f")]
K1_EARLY = [("const float uu = (tvx * px + tvy * py + tvz * pz) * inv_det;",
             "const float uu = (tvx * px + tvy * py + tvz * pz) * inv_det;\n"
             "      if (!(det_ok && uu >= 0.0f)) continue;")]
K1_VARIANTS = {"parent": ([], []), "rcp_approx": (K1_RCP, []), "vec_loads": (K1_VEC, []),
               "early_u": (K1_EARLY, []), "fmad": ([], ["--fmad=true"]),
               "all": (K1_RCP + K1_VEC + K1_EARLY, [])}

# K3's substitutions: (header (eaw_common.cuh) or source, old, new)
K3_INTRINSICS = [
    ("hdr", "const float nw = powf(ndot, s_normal);", "const float nw = __powf(ndot, s_normal);"),
    ("hdr", "fabsf(c.w - t.w) / s_depth_r;", "__fdividef(fabsf(c.w - t.w), s_depth_r);"),
    ("hdr", "return nw * expf(-d);", "return nw * __expf(-d);"),
    ("src", "expf(-fabsf(cl - eaw_lum(tr, tgr, tb)) / s_luma)",
     "__expf(__fdividef(-fabsf(cl - eaw_lum(tr, tgr, tb)), s_luma))"),
]
K3_CLAMP = [
    ("src", "const int ty = y + dy;", "const int ty = min(max(y + dy, 0), height - 1);"),
    ("src", "const int tx = x + dx;", "const int tx = min(max(x + dx, 0), width - 1);"),
    ("src", "if (ty < 0 || ty >= height || tx < 0 || tx >= width) continue;\n", ""),
]
K3_NO_MOMENTS = [("src", "acc_m1 += w_full * eaw_load1(mom, 3 * t);", ""),
                 ("src", "acc_m2 += w_full * eaw_load1(mom, 3 * t + 1);", "")]
K3_VARIANTS = {"parent": [], "intrinsics": K3_INTRINSICS, "clamp_bounds": K3_CLAMP,
               "both": K3_INTRINSICS + K3_CLAMP, "no_moments": K3_NO_MOMENTS}

K1_ARGS = [K.vp, K.vp, K.f32, K.vp, K.vp, K.i32, K.i32, K.i32, K.vp, K.vp, K.vp, K.vp, K.vp,
           K.i32, K.vp]
K3_ARGS = [K.vp, K.vp, K.vp, K.vp, K.i32, K.i32, K.f32, K.f32, K.f32, K.i32, K.vp]


def substituted(text: str, subs) -> str:
    for old, new in subs:
        if text.count(old) != 1:
            raise ValueError(f"substitution not found exactly once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_variants(csrc: str, root: str) -> dict:
    """{(kernel, variant): (library path, nvcc -Xptxas -v output)}, every
    variant compiled at once."""
    shutil.rmtree(root, ignore_errors=True)
    jobs = {}
    with open(os.path.join(csrc, "eaw_common.cuh")) as f:
        common = f.read()
    for kernel, src, variants in (("k1", "static_trace.cu", K1_VARIANTS),
                                  ("k3", "eaw_disocclusion.cu", K3_VARIANTS)):
        with open(os.path.join(csrc, src)) as f:
            text = f.read()
        for name, spec in variants.items():
            subs, flags = spec if kernel == "k1" else (spec, [])
            d = os.path.join(root, f"{kernel}_{name}")
            os.makedirs(d)
            if kernel == "k3":  # the tap's transcendentals live in the header
                with open(os.path.join(d, "eaw_common.cuh"), "w") as f:
                    f.write(substituted(common, [s[1:] for s in subs if s[0] == "hdr"]))
                subs = [s[1:] for s in subs if s[0] == "src"]
            with open(os.path.join(d, src), "w") as f:
                f.write(substituted(text, subs))
            lib = os.path.join(d, "lib.so")
            nvcc_flags = [f for f in K.NVCC_FLAGS if not f.startswith("--fmad")] + (
                flags or ["--fmad=false"])
            cmd = [K.find_nvcc(), *nvcc_flags, "-Xptxas", "-v", "-shared", "-o", lib,
                   os.path.join(d, src)]
            jobs[(kernel, name)] = (lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                          stderr=subprocess.STDOUT, text=True))
    out = {}
    for key, (lib, proc) in jobs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {key}:\n{log}")
        out[key] = (lib, log)
    return out


def registers(log: str) -> list:
    return [int(r) for r in re.findall(r"Used (\d+) registers", log)]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", required=True, help="the csrc directory whose kernels to vary")
    ap.add_argument("--iters", type=int, default=20, help="timed calls after one warm-up")
    ap.add_argument("--only", choices=("k1", "k3"), help="one kernel's variants alone")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    libs = build_variants(os.path.abspath(args.csrc), os.path.join(K.BUILD_ROOT, "split"))
    s = session()
    calls = frame_rays(s)
    tris = s.accel.tris
    x = stencil_inputs(s)
    stream = torch.cuda.current_stream().cuda_stream
    result = {"device": smi, "k1": {}, "k3": {}}
    for (kernel, name), (lib, log) in libs.items():
        if args.only not in (None, kernel):
            continue
        handle = ctypes.CDLL(lib)
        entry = {"registers": registers(log)}
        if kernel == "k1":
            fn = handle.static_trace
            fn.argtypes, fn.restype = K1_ARGS, K.i32
            for set_name, (kind, o, d, tmin, tmax) in zip(NAMES, calls):
                n = o.shape[0]
                t, u, v = (torch.empty(n, device="cuda") for _ in range(3))
                prim = torch.empty(n, dtype=torch.int32, device="cuda")
                hit = torch.empty(n, dtype=torch.bool, device="cuda")
                any_hit = int(kind == "any")
                call = lambda: fn(K.ptr(o), K.ptr(d), tmin, K.ptr(tmax), K.ptr(tris),  # noqa: E731
                                  n, tris.shape[0], any_hit, K.ptr(t), K.ptr(u), K.ptr(v),
                                  K.ptr(prim), K.ptr(hit), 0, stream)
                if call() != 0:
                    raise RuntimeError(f"k1 {name}: launch failed")
                entry[set_name] = {"ms": device_ms(call, args.iters),
                                   "digest": digest(hit if any_hit else (t, u, v, prim))}
        else:
            for dt in (torch.float32, torch.bfloat16):
                fn = getattr(handle, "eaw_disocclusion" + K.STORAGE_SUFFIX[dt])
                fn.argtypes, fn.restype = K3_ARGS, K.i32
                a = [x[k].to(dt).contiguous() for k in ("color4", "geo", "moments")]
                out = torch.empty_like(a[0])
                h, w = a[0].shape[:2]
                call = lambda: fn(*map(K.ptr, a), K.ptr(out), h, w, *x["sig"],  # noqa: E731
                                  0, stream)
                if call() != 0:
                    raise RuntimeError(f"k3 {name}: launch failed")
                key = "bf16" if dt == torch.bfloat16 else "f32"
                entry[key] = {"ms": device_ms(call, args.iters),
                              "digest": digest(out.view(torch.int16) if key == "bf16" else out)}
        result[kernel][name] = entry
        print(f"{kernel} {name}: {entry}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
