"""Per-step cost of a BVH walk on the card (kernel K9, `csrc/microstep.cu`):
the counterpart of the TPU microbenchmark tools/microstep.py.

A packet of 1024 rays takes `steps` steps of a synthetic node walk with no
leaf work, one variant of the step body at a time (see the kernel's
source): const, fetch, onehot, reduce, full. The output [P,1,8,128] is the
TPU kernel's `out`: per packet, the walk's integer accumulator (plus, in
`full`, a count of conditional increments), the same in every lane. The
plain version below is the same walk in torch and gives the same `out`.

    python -m capsaicin_tpu_torch.tools.microstep [--packets 64] [--steps 4096]

prints one JSON line per variant: ns per packet-step, and the device.
"""

from __future__ import annotations

import argparse
import ctypes
import json

import torch

from .. import kernels as K
from ..ops.traverse import _popcount

VARIANTS = ("const", "fetch", "onehot", "reduce", "full")
PACKET = 1024
N_ROWS = 512
LANES = 128
STEPS = 4096
RAYS_PER_THREAD = 8  # MS_RAYS in csrc/microstep.cu: a packet is 128 threads

K9 = K.register(K.Kernel(
    "microstep", "microstep",
    [K.vp, K.vp, K.i32, K.i32, K.i32, K.vp, K.vp],
    source="capsaicin_tpu_torch/csrc/microstep.cu",
    replaces="tools/microstep.py:32",
))


def make_inputs(n_packets: int, seed: int = 0, device="cpu"):
    """Rays [P,8,1024] (ox oy oz, 1/d xyz, tmin, t_best) and a node table
    [512,128] of boxes (lo xyz, hi xyz in each record's first six floats),
    drawn so that some boxes are hit and some are not."""
    g = torch.Generator().manual_seed(seed)
    rays = torch.rand((n_packets, 8, PACKET), generator=g) * 2.0 - 1.0
    rays[:, 3:6] = (torch.rand((n_packets, 3, PACKET), generator=g) * 2.0 - 1.0) * 4.0
    rays[:, 6] = 0.0
    rays[:, 7] = torch.rand((n_packets, PACKET), generator=g) * 2.0
    nodes = torch.rand((N_ROWS, LANES // 8, 8), generator=g) * 2.0 - 1.0
    lo = nodes[..., 0:3]
    nodes[..., 3:6] = lo + torch.rand(lo.shape, generator=g) * 0.5
    return rays.to(device), nodes.reshape(N_ROWS, LANES).to(device)


def _aabb(lo, hi, o, inv, tmin, t_best):
    t0 = (lo - o) * inv
    t1 = (hi - o) * inv
    t_near = torch.maximum(torch.maximum(torch.minimum(t0[0], t1[0]), torch.minimum(t0[1], t1[1])),
                           torch.minimum(t0[2], t1[2]))
    t_far = torch.minimum(torch.minimum(torch.maximum(t0[0], t1[0]), torch.maximum(t0[1], t1[1])),
                          torch.maximum(t0[2], t1[2]))
    return (t_near <= t_far) & (t_far >= tmin) & (t_near <= t_best)


def microstep_plain(variant: str, rays, nodes, steps: int = STEPS):
    """The plain version of K9: the walk of every packet in torch."""
    p = rays.shape[0]
    dev = rays.device
    o, inv = rays[:, 0:3].transpose(0, 1), rays[:, 3:6].transpose(0, 1)  # [3,P,1024]
    tmin, t_best = rays[:, 6], rays[:, 7]
    k = torch.full((p,), 2, dtype=torch.int64, device=dev)
    acc = torch.zeros(p, dtype=torch.int64, device=dev)
    ones = torch.zeros(p, dtype=torch.float32, device=dev)
    recs = nodes.reshape(N_ROWS * LANES // 8, 8)
    for step in range(steps):
        if variant == "const":
            acc += step
            k += 1
            continue
        b = recs[(k % N_ROWS) * (LANES // 8) + k % (LANES // 8)].T[:, :, None]  # [8,P,1]
        hit = _aabb(b[0:3], b[3:6], o, inv, tmin, t_best)
        if variant in ("reduce", "full"):
            any_box = hit.any(1)
            if variant == "full":
                ones += (any_box & (k % 64 == 0)).float()
                up = k >> _popcount(((~k) & (k + 1)) - 1)
                k = torch.where(any_box, 2 * k, torch.where(up <= 1, 1, up + 1))
                k = torch.where(k >= 8 * N_ROWS, k % N_ROWS + 2, k)
            else:
                k += 1
            acc += any_box.long()
        else:
            acc += k
            k += 1
    out = ones + acc.float()
    return out[:, None].expand(p, PACKET).reshape(p, 1, 8, LANES).contiguous()


def microstep(variant: str, rays, nodes, steps: int = STEPS):
    """K9 on CUDA tensors, its plain version on CPU tensors: rays
    [P,8,1024], nodes [512,128] float32 -> out [P,1,8,128]."""
    if K.on_cpu(rays):
        return microstep_plain(variant, rays, nodes, steps)
    dev = rays.device
    p = rays.shape[0]
    K.check_cuda(rays, "rays", torch.float32, (p, 8, PACKET), dev)
    K.check_cuda(nodes, "nodes", torch.float32, (N_ROWS, LANES), dev, align=16)
    out = torch.empty((p, 1, 8, LANES), dtype=torch.float32, device=dev)
    # each thread's count of steps with a hit, which keeps the tests of
    # const, fetch and onehot in the program; not read
    sink = torch.empty(p * PACKET // RAYS_PER_THREAD, dtype=torch.int32, device=dev)
    K9.launch(dev, K.ptr(rays), K.ptr(nodes), p, int(steps), VARIANTS.index(variant), K.ptr(out),
              K.ptr(sink))
    return out


def kernel_info(variant: str, device_index: int = 0) -> dict:
    """K9's build on a card for one variant, as `static.kernel_info` gives
    K1's: registers a thread, local (spilled) bytes a thread, static and
    dynamic shared bytes a block, resident blocks and warps an SM, SMs."""
    out = (ctypes.c_int * 6)()
    err = K.call("microstep_info", [K.i32, ctypes.POINTER(ctypes.c_int), K.i32],
                 VARIANTS.index(variant), out, device_index)
    if err != 0:
        raise RuntimeError(f"microstep_info: CUDA error {err}")
    info = dict(zip(("registers", "local_bytes", "shared_bytes", "dynamic_shared_bytes",
                     "ctas_per_sm", "sms"), out))
    info["warps_per_sm"] = info["ctas_per_sm"] * PACKET // RAYS_PER_THREAD // 32
    return info


def step_times(ms: float, packets: int, steps: int) -> dict:
    """ns_per_step: the call's time over packets x steps, as the TPU
    benchmark divides (it ran the packets one after another);
    ns_per_walk_step: over steps alone, one step of a packet's walk when
    all packets run at once (as they do while there are no more packets
    than SMs)."""
    return {"ns_per_step": ms * 1e6 / (packets * steps), "ns_per_walk_step": ms * 1e6 / steps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--packets", type=int, default=64)
    ap.add_argument("--steps", type=int, default=STEPS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("microstep measures the card: CUDA is not available")
    rays, nodes = make_inputs(args.packets, device="cuda")
    name = torch.cuda.get_device_name(0)
    for variant in VARIANTS:
        microstep(variant, rays, nodes, args.steps)  # warm-up (and build)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        iters = 5
        start.record()
        for _ in range(iters):
            microstep(variant, rays, nodes, args.steps)
        end.record()
        end.synchronize()
        ms = start.elapsed_time(end) / iters
        print(json.dumps({"variant": variant, **step_times(ms, args.packets, args.steps),
                          "ms": ms, "packets": args.packets, "steps": args.steps,
                          "device": name}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
