"""Design runs of this tree's K6, K8, K9 and K11: each kernel is built
again with other constants, or with one cost taken out, by a substitution
in a copy of its source, and every variant is timed on the inputs of a
1080p frame, with each variant's registers (`nvcc -Xptxas -v`) and its
result's digest. One JSON line.

- K6 (`k6d`) on the denoiser's colour and geo at the pairs (1, 3) and
  (5, 7), float32 and bf16: 1,024, 768 or 512 threads a block (64, 85 or
  128 registers), 512 threads two blocks an SM with a 100 KB region, 1,024
  threads with a 220 KB region, each launched with the tile `design_plan`
  chooses for its threads and region; and its split: `no_stage_a`,
  `no_stage_b` (a stage left out), `a_reads_one_pixel` (stage A's taps all
  read one pixel: no traffic beyond L1), `b_geo_one_pixel` (stage B's geo
  taps likewise).
- K11 (`k11d`) on the full colonnade's four 1080p ray sets of the third
  `colonnade_stream` frame and the frame's own call (the bounce set in the
  96-cell sorted order), blocks of 32: 4, 8 or 16 sub-packets a block, 2, 4
  or 8 boxes a thread at once, 6 or 8 resident blocks an SM, the full test
  where every axis straddles 0 (`no_straddle`) or where every ray has one
  direction (`no_point`), and two splits: `no_boxes` (the bounds alone)
  and `no_tests` (the bounds and the boxes' reads and loops, no test).
- K8 (`k8d`) on the four ray sets of the third 1080p Cornell frame and on
  the 65,536-ray subsamples of the full colonnade's four sets
  (`tools/brute_times.py`): tiles of 256 (committed) or 128 triangles, 256
  with at most 32 registers (8 blocks an SM), and `tiled` (a scene that
  fits one tile, the Cornell box, takes the pipelined instance too).
- K9 (`k9d`), its five variants at 64 packets x 4096 steps: 8 rays a
  thread (committed), 4 or 16; `no_unroll` (the step loop not unrolled by
  2); `both_records` (full reads both successors' records before the any()
  and selects their floats after it); `no_test` (reduce's and full's box
  tests replaced by one compare of the record: the chain without the
  tests).

All but the splits keep the kernels' results (the digests say so). The
substitutions match this tree's sources:

    python3 -m capsaicin_tpu_torch.tools.split_times [--only k8d k9d] [--iters 20]

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
CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")

# The same source with other tile constants substituted, or one cost taken
# out: K6 launched with the tile `design_plan` gives its threads and
# shared-memory budget, K11 with the grid of its group.
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

# Design runs of this tree's K8 and K9
K8D_VARIANTS = {
    "t256": [],
    "t128": [define("BRUTE_TILE", 256, 128)],
    "t256_m8": [("src", "__global__ void __launch_bounds__(BRUTE_BLOCK) brute_trace_kernel(",
                 "__global__ void __launch_bounds__(BRUTE_BLOCK, 8) brute_trace_kernel(")],
    "tiled": [("src", "const bool one = n_tris <= BRUTE_TILE;", "const bool one = false;")],
}
K9D_TESTS = ("    bool hit = false;\n#pragma unroll\n    for (int j = 0; j < MS_RAYS; ++j)\n"
             "      hit |= ms_aabb(b, ox[j], oy[j], oz[j], ix[j], iy[j], iz[j], tmin[j], t_best[j]);")
K9D_VARIANTS = {
    "r8": [],
    "r4": [define("MS_RAYS", 8, 4)],
    "r16": [define("MS_RAYS", 8, 16)],
    "no_unroll": [("src", "#pragma unroll (VARIANT == 0 ? 1 : 2)\n", "")],
    "both_records": [
        ("src", "    const int rec_hit = ms_rec(k_hit), rec_miss = ms_rec(k_miss);",
         "    float b_hit[MS_KEEP], b_miss[MS_KEEP];\n    ms_read(s_nodes, k_hit, b_hit);\n"
         "    ms_read(s_nodes, k_miss, b_miss);"),
        ("src", "      ms_read_rec(s_nodes, any_box ? rec_hit : rec_miss, b);",
         "#pragma unroll\n      for (int c = 0; c < MS_KEEP; ++c) b[c] = any_box ? b_hit[c] : b_miss[c];")],
    "no_test": [("src", K9D_TESTS, "    const bool hit = b[0] + b[1] < 0.0f;")],
}

# each kernel: its source, the header its variants change, {variant: (subs, extra flags)}
KERNELS = {
    "k6d": ("eaw_pair.cu", None, {n: (v, []) for n, (v, _) in K6D_VARIANTS.items()}),
    "k11d": ("stream_count.cu", None, {n: (v, []) for n, (v, _) in K11D_VARIANTS.items()}),
    "k8d": ("brute_trace.cu", None, {n: (v, []) for n, v in K8D_VARIANTS.items()}),
    "k9d": ("microstep.cu", None, {n: (v, []) for n, v in K9D_VARIANTS.items()}),
}

K1_ARGS = [K.vp, K.vp, K.f32, K.vp, K.vp, K.i32, K.i32, K.i32, K.vp, K.vp, K.vp, K.vp, K.vp,
           K.i32, K.vp]
K6_ARGS = [K.vp, K.vp, K.vp, K.i32, K.i32, K.i32, K.i32, K.i32, K.f32, K.f32, K.f32,
           K.i32, K.i32, K.i32, K.i32, K.i32, K.i32, K.vp]  # and the grid, tile and shared bytes
K11_ARGS = [K.vp, K.vp, K.f32, K.vp, K.vp, K.i32, K.i32, K.i32, K.vp, K.i32, K.vp]
K9_ARGS = [K.vp, K.vp, K.i32, K.i32, K.i32, K.vp, K.i32, K.vp]
K9D_ARGS = K9_ARGS[:6] + [K.vp] + K9_ARGS[6:]  # and the scratch of the hits
PAIRS = ((1, 3), (5, 7))


def substituted(text: str, subs) -> str:
    for old, new in subs:
        if text.count(old) != 1:
            raise ValueError(f"substitution not found exactly once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


def build_variants(csrc: str, root: str, kernels: dict) -> dict:
    """{(kernel, variant): (library path, nvcc -Xptxas -v output)} for
    `kernels` ({kernel: (source, header, {variant: (subs, flags)})}, as
    KERNELS), every variant compiled at once. A variant's subs are ("src"
    or "hdr", old, new); a third item after its flags names another
    source of `csrc` to build as it is."""
    shutil.rmtree(root, ignore_errors=True)
    jobs = {}
    for kernel, (src, hdr, variants) in kernels.items():
        with open(os.path.join(csrc, src)) as f:
            text = f.read()
        header = None
        if hdr is not None:
            with open(os.path.join(csrc, hdr)) as f:
                header = f.read()
        for name, (subs, flags, *own) in variants.items():
            vsrc = own[0] if own else src  # a variant may build another source as it is
            if own:
                with open(os.path.join(csrc, vsrc)) as f:
                    text_v = f.read()
            else:
                text_v = text
            d = os.path.join(root, f"{kernel}_{name}")
            os.makedirs(d)
            for f in os.listdir(csrc):  # the headers the source includes
                if f.endswith(".cuh"):
                    shutil.copy(os.path.join(csrc, f), d)
            if hdr is not None:  # the variant's own copy of the header
                with open(os.path.join(d, hdr), "w") as f:
                    f.write(substituted(header, [s[1:] for s in subs if s[0] == "hdr"]))
            with open(os.path.join(d, vsrc), "w") as f:
                f.write(substituted(text_v, [s[1:] for s in subs if s[0] == "src"]))
            lib = os.path.join(d, "lib.so")
            nvcc_flags = [f for f in K.NVCC_FLAGS if not f.startswith("--fmad")] + (
                flags or ["--fmad=false"])
            cmd = [K.find_nvcc(), *nvcc_flags, "-Xptxas", "-v", "-shared", "-o", lib,
                   os.path.join(d, vsrc)]
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


def time_k1(handle, calls, tris, iters, stream, symbol="static_trace") -> dict:
    """K1 (or K8, whose C entry point takes the same arguments) on the four
    ray sets."""
    fn = getattr(handle, symbol)
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
            raise RuntimeError(f"{symbol}: launch failed")
        entry[set_name] = {"ms": device_ms(call, iters),
                           "digest": digest(hit if any_hit else (t, u, v, prim))}
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
        fn.argtypes, fn.restype = K6_ARGS, K.i32
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


def time_k11(handle, sbvh, sets, iters, stream, group: int) -> dict:
    """K11 on each set, built with `group` sub-packets a block."""
    fn = handle.stream_count
    fn.argtypes, fn.restype = K11_ARGS, K.i32
    entry = {}
    for name, (o, d, tmin, tmax) in sets.items():
        n = o.shape[0]
        counts = torch.empty(-(-n // 128), dtype=torch.int32, device="cuda")
        grid = -(-counts.shape[0] // group)
        call = lambda: fn(K.ptr(o), K.ptr(d), tmin, K.ptr(tmax), K.ptr(sbvh.boxes),  # noqa: E731
                          n, sbvh.n_blocks, grid, K.ptr(counts), 0, stream)
        if call() != 0:
            raise RuntimeError("k11: launch failed")
        entry[name] = {"ms": device_ms(call, iters), "digest": digest(counts)}
    return entry


def time_k9(handle, iters, stream, packets=64, design=False) -> dict:
    """K9's five variants at `packets` x 4096 steps; `design`: a build
    with the scratch argument of this tree's K9."""
    from capsaicin_tpu_torch.tools import microstep as msk

    fn = handle.microstep
    fn.argtypes, fn.restype = (K9D_ARGS if design else K9_ARGS), K.i32
    rays, nodes = msk.make_inputs(packets, device="cuda")
    out = torch.empty((packets, 1, 8, msk.LANES), device="cuda")
    scratch = (K.ptr(torch.empty(packets * msk.PACKET, dtype=torch.int32, device="cuda")),) * design
    entry = {}
    for v, variant in enumerate(msk.VARIANTS):
        call = lambda v=v: fn(K.ptr(rays), K.ptr(nodes), packets, msk.STEPS, v,  # noqa: E731
                              K.ptr(out), *scratch, 0, stream)
        if call() != 0:
            raise RuntimeError("k9: launch failed")
        entry[variant] = {"ms": device_ms(call, iters), "digest": digest(out)}
    return entry


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--csrc", default=CSRC, help="the csrc directory whose kernels to vary")
    ap.add_argument("--iters", type=int, default=20, help="timed calls after one warm-up")
    ap.add_argument("--only", nargs="+", choices=tuple(KERNELS), default=tuple(KERNELS),
                    help="the kernels whose variants to build and time")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    libs = build_variants(os.path.abspath(args.csrc), os.path.join(K.BUILD_ROOT, "split"),
                          {k: KERNELS[k] for k in args.only})
    stream = torch.cuda.current_stream().cuda_stream
    result = {"device": smi, **{k: {} for k in args.only}}
    if {"k6d", "k8d"} & set(args.only):
        s = session()
        calls = frame_rays(s)
        x = stencil_inputs(s)
    if "k11d" in args.only:
        sbvh, sets = colonnade_sets()
    if "k8d" in args.only:
        from capsaicin_tpu_torch.tools.brute_times import colonnade_subsets

        scene8, subsets = colonnade_subsets()
    for (kernel, name), (lib, log) in libs.items():
        handle = ctypes.CDLL(lib)
        entry = {"registers": registers(log)}
        if kernel == "k9d":
            entry.update(time_k9(handle, args.iters, stream, design=True))
        elif kernel == "k8d":
            entry.update(time_k1(handle, calls, s.accel.tris, args.iters, stream, "brute_trace"))
            colonnade = time_k1(handle, subsets, scene8.tris, 3, stream, "brute_trace")
            entry.update({f"colonnade_{k}": v for k, v in colonnade.items()})
        elif kernel == "k6d":
            entry.update(time_k6_design(handle, x, *K6D_VARIANTS[name][1], args.iters, stream))
        else:
            entry.update(time_k11(handle, sbvh, sets, args.iters, stream,
                                  group=K11D_VARIANTS[name][1]))
        result[kernel][name] = entry
        print(f"{kernel} {name}: {entry}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
