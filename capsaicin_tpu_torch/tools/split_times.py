"""Where the time of a kernel's first design goes, measured before its
redesign: each is built again with one cost taken out or changed by a
substitution in its source text, and every variant is timed on the inputs
of a 1080p frame, with each variant's registers (`nvcc -Xptxas -v`) and
its result's digest. One JSON line.

- K1 (`static_trace.cu`, its first design) on the four ray sets of the
  third 1080p Cornell frame (primary closest, direct shadow any-hit,
  bounce closest, NEE any-hit): `rcp_approx` (the IEEE `1.0f / det` as an
  approximate reciprocal), `vec_loads` (a triangle as three float4 reads
  of shared memory, not nine scalars), `early_u` (leave a triangle once
  det or u has failed: exact), `fmad` (built with --fmad=true), `all` (the
  first three).
- K3 (`eaw_disocclusion.cu`, its first design) on the denoiser's colour,
  geo and moments in float32 and bf16: `intrinsics` (__powf, __expf,
  __fdividef for the tap's transcendentals and divisions), `clamp_bounds`
  (taps clamped into the image instead of skipped), `both`, `no_moments`
  (the two moment sums left out).
- K6 (`eaw_pair.cu`, its first design) on the denoiser's colour and geo at
  the pairs (1, 3) and (5, 7), float32 and bf16: `intrinsics` (as K3's, in
  the shared stage body), `centre_reads` (every tap of both stages reads
  the centre pixel's colour and geo: what is left without the taps'
  reads), `no_recompute` (stage A only on the tile's own 16x16 pixels, the
  halo holding the input colour: what is left without the halo's
  recompute), `no_stage_a` (the halo and tile hold the input colour: stage
  B alone), `intrinsics_no_recompute`.
- K11 (`stream_count.cu`, its first design) on the full colonnade's four
  1080p ray sets of the third `colonnade_stream` frame and the frame's own
  call (the bounce set in the 96-cell sorted order), blocks of 32 (8,192
  boxes): `nan_ptx` (the NaN-propagating min and max as one `min.NaN.f32`
  / `max.NaN.f32` each: exact), `no_test` (the box test replaced by one
  compare of the loaded box: the box reads alone), `no_reads` (every
  thread reads its boxes from a 128-box window that stays in L1: the test
  without the table's reads from L2), `nan_ptx_no_reads`.

Only `early_u` and `nan_ptx` keep the kernel's results; the rest are for
timing. The substitutions match the texts of those designs, so point
`--csrc` at the `capsaicin_tpu_torch/csrc` of a tree that has them, and
pick its kernels with `--only`:

    python3 -m capsaicin_tpu_torch.tools.split_times --csrc PATH --only k6 k11 [--iters 20]

Design runs of this tree's K6 and K11 (`--only k6d k11d`, `--csrc` this
tree's): the same sources with other tile constants substituted, or with
one cost taken out. K6 (`k6d`): 1,024, 768 or 512 threads a block (64, 85
or 128 registers), 512 threads two blocks an SM with a 100 KB region,
1,024 threads with a 220 KB region, each launched with the tile
`design_plan` chooses for its threads and region; and its split:
`no_stage_a`, `no_stage_b` (a stage left out), `a_reads_one_pixel` (stage
A's taps all read one pixel: no traffic beyond L1), `b_geo_one_pixel`
(stage B's geo taps likewise). K11 (`k11d`): 4, 8 or 16 sub-packets a
block, 2, 4 or 8 boxes a thread at once, 6 or 8 resident blocks an SM,
the full test where every axis straddles 0 (`no_straddle`) or where every
ray has one direction (`no_point`), and two splits: `no_boxes` (the
bounds alone) and `no_tests` (the bounds and the boxes' reads and loops,
no test). All but the splits keep the kernels' results (the digests say
so).

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

# K3's and K6's substitutions: (header (eaw_common.cuh) or source, old, new)
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

K6_INTRINSICS = K3_INTRINSICS[:3] + [
    ("hdr", "expf(-fabsf(cl - eaw_lum(tr, tgr, tb)) / s_l_eff)",
     "__expf(__fdividef(-fabsf(cl - eaw_lum(tr, tgr, tb)), s_l_eff))")]
K6_CENTRE = [("hdr", "const float4 tg = eaw_load4(geo, ty * width + tx);",
              "const float4 tg = eaw_load4(geo, y * width + x);"),
             ("hdr", "const float4 tc = color_at(tx, ty);", "const float4 tc = color_at(x, y);")]
K6_NO_RECOMPUTE = [("src", "if (gx >= 0 && gx < width && gy >= 0 && gy < height) {\n",
                    "if (gx >= 0 && gx < width && gy >= 0 && gy < height) {\n"
                    "      const int lx = i % span - halo, ly = i / span - halo;\n"
                    "      if (lx < 0 || lx >= EAW_TILE || ly < 0 || ly >= EAW_TILE) {\n"
                    "        eaw_mid[i] = col_at(gx, gy);\n"
                    "        continue;\n"
                    "      }\n")]
K6_NO_STAGE_A = [("src", "eaw_mid[i] = eaw_stage_pixel(col_at, geo, gx, gy, height, width,\n"
                  "                                   stride_a, use_variance, s_normal, s_depth,\n"
                  "                                   s_luma);",
                  "eaw_mid[i] = col_at(gx, gy);")]
K6_VARIANTS = {"parent": [], "intrinsics": K6_INTRINSICS, "centre_reads": K6_CENTRE,
               "no_recompute": K6_NO_RECOMPUTE, "no_stage_a": K6_NO_STAGE_A,
               "intrinsics_no_recompute": K6_INTRINSICS + K6_NO_RECOMPUTE}

# K11's: (header (stream_common.cuh) or source, old, new)
K11_NAN_PTX = [
    ("hdr", "return (a != a || b != b) ? __int_as_float(0x7fffffff) : fminf(a, b);",
     'float r;\n  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));\n  return r;'),
    ("hdr", "return (a != a || b != b) ? __int_as_float(0x7fffffff) : fmaxf(a, b);",
     'float r;\n  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));\n  return r;'),
]
K11_NO_TEST = [("src", "count += box_candidate(b, __ldg(boxes + 2 * k), __ldg(boxes + 2 * k + 1), tn) ? 1 : 0;",
                "const float4 lo = __ldg(boxes + 2 * k), hi = __ldg(boxes + 2 * k + 1);\n"
                "      tn = lo.x + hi.x;\n"
                "      count += (lo.w > 0.0f && tn <= b.tcap0) ? 1 : 0;")]
K11_NO_READS = [("src", "__ldg(boxes + 2 * k), __ldg(boxes + 2 * k + 1)",
                 "__ldg(boxes + 2 * (k & 127)), __ldg(boxes + 2 * (k & 127) + 1)")]
K11_VARIANTS = {"parent": [], "nan_ptx": K11_NAN_PTX, "no_test": K11_NO_TEST,
                "no_reads": K11_NO_READS, "nan_ptx_no_reads": K11_NAN_PTX + K11_NO_READS}

# Design runs of this tree's K6 and K11: the same source with other tile
# constants substituted, K6 launched with the tile `design_plan` gives its
# threads and shared-memory budget, K11 with the grid of its group.
# {variant: (substitutions, K6's (threads, budget) or K11's group)}


def define(name: str, old: int, new: int) -> tuple:
    """The source's `#define name old` set to `new`."""
    return ("src", f"#define {name} {old} ", f"#define {name} {new} ")


K6D_DEFAULT = (1024, 176 * 1024)
K6D_VARIANTS = {
    "t1024": ([], K6D_DEFAULT),
    "no_stage_a": ([("src", "k6_pass(stride_a, nx, ny)", "k6_pass(stride_a, 0, 0)")], K6D_DEFAULT),
    "no_stage_b": ([("src", "k6_pass(stride_b, tile_x, tile_y)", "k6_pass(stride_b, 0, 0)")],
                   K6D_DEFAULT),
    "a_reads_one_pixel": ([("src", "const int idx = in ? ty * width + tx : 0;",
                            "const int idx = 0;")], K6D_DEFAULT),
    "b_geo_one_pixel": ([("src", "const float4 tg = in ? eaw_load4(geo, ty * width + tx) : zero;",
                          "const float4 tg = in ? eaw_load4(geo, 0) : zero;")], K6D_DEFAULT),
    "t768": ([define("K6_THREADS", 1024, 768)], (768, 176 * 1024)),
    "t512": ([define("K6_THREADS", 1024, 512)], (512, 176 * 1024)),
    "t512_2blocks_100k": ([define("K6_THREADS", 1024, 512), define("K6_MIN_BLOCKS", 1, 2)],
                          (512, 100 * 1024)),
    "t1024_220k": ([], (1024, 220 * 1024)),
}
K11D_VARIANTS = {
    "g8_b4_m8": ([], 8),
    "no_boxes": ([("src", "  if (live) {", "  if (false) {")], 8),
    "no_tests": ([("src", "switch ((int)b[3].w) {", "switch (-1) {")], 8),
    "no_straddle": ([("src", "if (code == 26 && v[12] >= 0.0f) code = K11_STRADDLE;", "")], 8),
    "no_point": ([("src", "    if (v[3] == v[9] && v[4] == v[10] && v[5] == v[11])\n"
                   "      code = K11_POINT + (v[3] < 0.0f) + 2 * (v[4] < 0.0f) + "
                   "4 * (v[5] < 0.0f);\n", "")], 8),
    "g8_b2_m8": ([define("K11_BOXES", 4, 2)], 8),
    "g16_b4_m8": ([define("K11_GROUP", 8, 16)], 16),
    "g4_b4_m8": ([define("K11_GROUP", 8, 4)], 4),
    "g8_b8_m6": ([define("K11_BOXES", 4, 8), define("K11_MIN_BLOCKS", 8, 6)], 8),
    "g8_b4_m6": ([define("K11_MIN_BLOCKS", 8, 6)], 8),
}

# each kernel: its source, the header its variants change, {variant: (subs, extra flags)}
KERNELS = {
    "k1": ("static_trace.cu", None,
           {n: ([("src", *sub) for sub in subs], flags) for n, (subs, flags) in K1_VARIANTS.items()}),
    "k3": ("eaw_disocclusion.cu", "eaw_common.cuh", {n: (v, []) for n, v in K3_VARIANTS.items()}),
    "k6": ("eaw_pair.cu", "eaw_common.cuh", {n: (v, []) for n, v in K6_VARIANTS.items()}),
    "k11": ("stream_count.cu", "stream_common.cuh", {n: (v, []) for n, v in K11_VARIANTS.items()}),
    "k6d": ("eaw_pair.cu", None, {n: (v, []) for n, (v, _) in K6D_VARIANTS.items()}),
    "k11d": ("stream_count.cu", None, {n: (v, []) for n, (v, _) in K11D_VARIANTS.items()}),
}

K1_ARGS = [K.vp, K.vp, K.f32, K.vp, K.vp, K.i32, K.i32, K.i32, K.vp, K.vp, K.vp, K.vp, K.vp,
           K.i32, K.vp]
K3_ARGS = [K.vp, K.vp, K.vp, K.vp, K.i32, K.i32, K.f32, K.f32, K.f32, K.i32, K.vp]
K6_ARGS = [K.vp, K.vp, K.vp, K.i32, K.i32, K.i32, K.i32, K.i32, K.f32, K.f32, K.f32, K.i32, K.vp]
K11_ARGS = [K.vp, K.vp, K.f32, K.vp, K.vp, K.i32, K.i32, K.vp, K.i32, K.vp]
K6D_ARGS = K6_ARGS[:11] + [K.i32] * 5 + K6_ARGS[11:]
K11D_ARGS = K11_ARGS[:7] + [K.i32] + K11_ARGS[7:]
PAIRS = ((1, 3), (5, 7))


def substituted(text: str, subs) -> str:
    for old, new in subs:
        if text.count(old) != 1:
            raise ValueError(f"substitution not found exactly once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_variants(csrc: str, root: str, kernels) -> dict:
    """{(kernel, variant): (library path, nvcc -Xptxas -v output)} for the
    `kernels` named, every variant compiled at once."""
    shutil.rmtree(root, ignore_errors=True)
    jobs = {}
    for kernel in kernels:
        src, hdr, variants = KERNELS[kernel]
        with open(os.path.join(csrc, src)) as f:
            text = f.read()
        header = None
        if hdr is not None:
            with open(os.path.join(csrc, hdr)) as f:
                header = f.read()
        for name, (subs, flags) in variants.items():
            d = os.path.join(root, f"{kernel}_{name}")
            os.makedirs(d)
            for f in os.listdir(csrc):  # the headers the source includes
                if f.endswith(".cuh"):
                    shutil.copy(os.path.join(csrc, f), d)
            if hdr is not None:  # the variant's own copy of the header
                with open(os.path.join(d, hdr), "w") as f:
                    f.write(substituted(header, [s[1:] for s in subs if s[0] == "hdr"]))
            with open(os.path.join(d, src), "w") as f:
                f.write(substituted(text, [s[1:] for s in subs if s[0] == "src"]))
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


def time_k1(handle, calls, tris, iters, stream) -> dict:
    fn = handle.static_trace
    fn.argtypes, fn.restype = K1_ARGS, K.i32
    entry = {}
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
            raise RuntimeError("k1: launch failed")
        entry[set_name] = {"ms": device_ms(call, iters),
                           "digest": digest(hit if any_hit else (t, u, v, prim))}
    return entry


def time_stencil(handle, symbol, argtypes, cases, iters, stream) -> dict:
    """cases: {label: (inputs, extra C arguments)}, each in float32 and bf16."""
    entry = {}
    for dt in (torch.float32, torch.bfloat16):
        fn = getattr(handle, symbol + K.STORAGE_SUFFIX[dt])
        fn.argtypes, fn.restype = argtypes, K.i32
        for label, (inputs, extra) in cases.items():
            a = [x.to(dt).contiguous() for x in inputs]
            out = torch.empty_like(a[0])
            h, w = a[0].shape[:2]
            call = lambda: fn(*map(K.ptr, a), K.ptr(out), h, w, *extra, 0, stream)  # noqa: E731
            if call() != 0:
                raise RuntimeError(f"{symbol}: launch failed")
            key = f"{label}_{'bf16' if dt == torch.bfloat16 else 'f32'}"
            entry[key] = {"ms": device_ms(call, iters),
                          "digest": digest(out.view(torch.int16) if dt == torch.bfloat16 else out)}
    return entry


def design_plan(h: int, w: int, stride_a: int, stride_b: int, threads: int, budget: int):
    """K6's tile as `stencil.pair_plan` chooses it (the fewest rounds of
    items a thread over the card's waves, ties to the larger tile) for a
    build of `threads` threads a block whose region may take `budget`
    bytes: (tile, tiles a row, grid, shared bytes)."""
    from capsaicin_tpu_torch.ops import stencil

    sms = stencil.sm_count(torch.cuda.current_device())
    best = None
    for tx in range(4, 129, 4):
        for ty in range(4, 129, 4):
            nx, ny = tx + 4 * stride_b, ty + 4 * stride_b
            if nx * ny * stencil.PAIR_BYTES_PER_PIXEL > budget:
                continue
            items = (stencil.pair_items(stride_a, nx, ny), stencil.pair_items(stride_b, tx, ty))
            blocks = -(-w // tx) * -(-h // ty)
            cost = (-(-blocks // sms) * sum(-(-n // threads) for n in items), -tx * ty)
            if best is None or cost < best[0]:
                best = (cost, tx, ty, nx * ny * stencil.PAIR_BYTES_PER_PIXEL)
    _, tx, ty, shared = best
    return (tx, ty), -(-w // tx), -(-w // tx) * -(-h // ty), shared


def time_k6_design(handle, x, threads, budget, iters, stream) -> dict:
    """This tree's K6 built with other constants, at the pairs (1, 3) and
    (5, 7), float32 and bf16, launched with the tile `design_plan` gives
    `threads` and `budget`."""
    entry = {}
    for dt in (torch.float32, torch.bfloat16):
        fn = getattr(handle, "eaw_pair" + K.STORAGE_SUFFIX[dt])
        fn.argtypes, fn.restype = K6D_ARGS, K.i32
        c, g = x["color4"].to(dt).contiguous(), x["geo"].to(dt).contiguous()
        out = torch.empty_like(c)
        h, w = c.shape[:2]
        for a, b in PAIRS:
            tile, tiles_x, grid, shared = design_plan(h, w, a, b, threads, budget)
            call = lambda: fn(K.ptr(c), K.ptr(g), K.ptr(out), h, w, a, b, 1,  # noqa: E731
                              *x["sig"], grid, *tile, tiles_x, shared, 0, stream)
            if call() != 0:
                raise RuntimeError("k6d: launch failed")
            key = f"p{a}{b}_{'bf16' if dt == torch.bfloat16 else 'f32'}"
            entry[key] = {"ms": device_ms(call, iters), "tile": tile,
                          "digest": digest(out.view(torch.int16) if dt == torch.bfloat16 else out)}
    return entry


def colonnade_sets():
    """The full colonnade's stream structure at blocks of 32 and the four
    ray sets of the third `colonnade_stream` frame, plus the bounce set in
    the session's 96-cell sorted order: {name: (origins, dirs, tmin, tmax)}."""
    from capsaicin_tpu_torch.ops import bvh
    from capsaicin_tpu_torch.scene import build_scene
    from capsaicin_tpu_torch.scene.procedural import colonnade
    from capsaicin_tpu_torch.tools.stream_times import session as stream_session

    s = stream_session(build_scene(colonnade()))
    calls = frame_rays(s)
    sets = {name: (o, d, tmin, tmax) for name, (_, o, d, tmin, tmax) in zip(NAMES, calls)}
    o, d, tmin, tmax = sets["bounce"]
    order, _ = bvh.sort_rays_for_traversal(o, d, dead=tmax < tmin, dir_grid=4)
    sets["bounce_sorted"] = (o[order].contiguous(), d[order].contiguous(), tmin,
                             tmax[order].contiguous())
    return s.accel, sets


def time_k11(handle, sbvh, sets, iters, stream, group=None) -> dict:
    """K11 on each set; `group`: this tree's K11 (its grid argument) with
    that many sub-packets a block."""
    fn = handle.stream_count
    fn.argtypes, fn.restype = (K11_ARGS if group is None else K11D_ARGS), K.i32
    entry = {}
    for name, (o, d, tmin, tmax) in sets.items():
        n = o.shape[0]
        counts = torch.empty(-(-n // 128), dtype=torch.int32, device="cuda")
        grid = () if group is None else (-(-counts.shape[0] // group),)
        call = lambda: fn(K.ptr(o), K.ptr(d), tmin, K.ptr(tmax), K.ptr(sbvh.boxes),  # noqa: E731
                          n, sbvh.n_blocks, *grid, K.ptr(counts), 0, stream)
        if call() != 0:
            raise RuntimeError("k11: launch failed")
        entry[name] = {"ms": device_ms(call, iters), "digest": digest(counts)}
    return entry


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", required=True, help="the csrc directory whose kernels to vary")
    ap.add_argument("--iters", type=int, default=20, help="timed calls after one warm-up")
    ap.add_argument("--only", nargs="+", choices=tuple(KERNELS), default=("k1", "k3"),
                    help="the kernels whose variants to build and time")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    libs = build_variants(os.path.abspath(args.csrc), os.path.join(K.BUILD_ROOT, "split"),
                          args.only)
    stream = torch.cuda.current_stream().cuda_stream
    result = {"device": smi, **{k: {} for k in args.only}}
    if {"k1", "k3", "k6", "k6d"} & set(args.only):
        s = session()
        calls = frame_rays(s)
        tris = s.accel.tris
        x = stencil_inputs(s)
    if {"k11", "k11d"} & set(args.only):
        sbvh, sets = colonnade_sets()
    for (kernel, name), (lib, log) in libs.items():
        handle = ctypes.CDLL(lib)
        entry = {"registers": registers(log)}
        if kernel == "k1":
            entry.update(time_k1(handle, calls, tris, args.iters, stream))
        elif kernel == "k3":
            entry.update(time_stencil(handle, "eaw_disocclusion", K3_ARGS,
                                      {"full": ((x["color4"], x["geo"], x["moments"]), x["sig"])},
                                      args.iters, stream))
        elif kernel == "k6":
            entry.update(time_stencil(handle, "eaw_pair", K6_ARGS,
                                      {f"p{a}{b}": ((x["color4"], x["geo"]), (a, b, 1, *x["sig"]))
                                       for a, b in PAIRS}, args.iters, stream))
        elif kernel == "k6d":
            entry.update(time_k6_design(handle, x, *K6D_VARIANTS[name][1], args.iters, stream))
        elif kernel == "k11d":
            entry.update(time_k11(handle, sbvh, sets, args.iters, stream,
                                  group=K11D_VARIANTS[name][1]))
        else:
            entry.update(time_k11(handle, sbvh, sets, args.iters, stream))
        result[kernel][name] = entry
        print(f"{kernel} {name}: {entry}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
