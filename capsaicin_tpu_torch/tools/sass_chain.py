"""The step loop of a kernel in its SASS: instructions a step, the issue
they need and the dependent latency of one step. One JSON line a kernel.

It disassembles the built kernel library (`cuobjdump -sass`, or a saved
listing with `--sass`), takes each function whose name holds `--kernel`,
and finds its step loop: the innermost backward branch whose body holds
the most box-test instructions (FMNMX). In that body it counts

- the instructions, and those that go to the float32 multiply-add pipe
  (FADD, FMUL, FFMA) and to the ALU pipe (FMNMX, FSETP, FSEL and the
  integer and predicate logic); `issue_clocks` is the larger of the two
  pipes' clocks for one warp a scheduler (the FMA pipe one warp
  instruction a clock, the ALU pipe one every two clocks: 16 lanes of each
  a scheduler);
- the dependent latency: the longest path through the body's register and
  predicate dependences, each instruction's result ready LATENCY clocks
  after its inputs, the loop-carried values ready at the body's start, as
  though issue were free.

Both are for one iteration, and also for one step: the box tests of a
step are 10 FMNMX a ray, so a body with F of them over R rays a thread
holds F / (10 R) steps. The latencies are assumptions (NVIDIA publishes
none): 4 clocks for float32 and integer arithmetic, 23 for a shared-memory
read or a shuffle, 10 for POPC, 20 for a barrier whose warps arrive
together. So `chain_clocks` is an estimate of the floor a step's
dependences set, and `issue_clocks` of the floor its issue sets, not
measurements.

    python3 -m capsaicin_tpu_torch.tools.sass_chain [--kernel microstep_kernel] [--rays 8] [--sass FILE]

Needs the CUDA toolkit's cuobjdump unless `--sass` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess

LATENCY = {"LDS": 23, "SHFL": 23, "POPC": 10, "FLO": 10, "BAR": 20, "S2R": 20, "S2UR": 20,
           "LDC": 20, "ULDC": 20, "LDG": 400}
DEFAULT_LATENCY = 4
FMA_PIPE = {"FADD", "FMUL", "FFMA"}
ALU_PIPE = {"FMNMX", "FSETP", "FSEL", "ISETP", "LOP3", "IADD3", "SEL", "PLOP3", "SHF", "LEA",
            "VIADD", "IMNMX", "P2R", "R2P", "PRMT"}
# opcodes whose first two operands are both written (a predicate and a register, or two)
TWO_DESTS = {"FSETP", "ISETP", "DSETP", "PLOP3", "LOP3"}
NO_DEST = {"STS", "STG", "ST", "STL", "BRA", "BSSY", "BSYNC", "EXIT", "NOP", "RET", "WARPSYNC",
           "CALL", "BPT", "YIELD"}
INSN = re.compile(r"/\*([0-9a-f]{4,6})\*/\s+(.*?)\s*;")
REG = re.compile(r"\b(U?R\d+|U?P\d)\b")


def functions(sass: str) -> dict:
    """{name: [(address, guard, opcode, [operands])]} of a cuobjdump listing."""
    out = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = part.split("\n", 1)
        insns = []
        for addr, text in INSN.findall(body):
            guard = None
            m = re.match(r"@(!?U?P\w+)\s+(.*)", text)
            if m:
                guard, text = m.group(1).lstrip("!"), m.group(2)
            opcode, _, rest = text.partition(" ")
            operands = [o.strip() for o in rest.split(",")] if rest.strip() else []
            insns.append((int(addr, 16), guard, opcode, operands))
        out[name.strip()] = insns
    return out


def _regs(operand: str, opcode: str):
    """The registers an operand names (a 64- or 128-bit one as its pair or
    quad)."""
    width = 4 if ".128" in opcode else 2 if (".64" in opcode or ".WIDE" in opcode) else 1
    regs = []
    for r in REG.findall(operand.replace(".reuse", "")):
        if r in ("PT", "UPT"):
            continue
        regs.append(r)
        if width > 1 and r[0] in "RU" and "P" not in r and "[" not in operand:
            prefix, n = re.match(r"(U?R)(\d+)", r).groups()
            regs += [f"{prefix}{int(n) + i}" for i in range(1, width)]
    if "[" in operand:  # an address: its registers are read whatever the width
        regs = [r for r in REG.findall(operand) if r not in ("PT", "UPT")]
    return [r for r in regs if r not in ("RZ", "URZ")]


def step_loop(insns):
    """The instructions of the innermost backward-branch body with the most
    FMNMX."""
    best = None
    for i, (addr, _, opcode, operands) in enumerate(insns):
        if opcode != "BRA" or not operands:
            continue
        target = int(operands[-1], 16)
        if target >= addr:
            continue
        body = [x for x in insns if target <= x[0] <= addr]
        key = (sum(x[2].startswith("FMNMX") for x in body), -len(body))
        if best is None or key > best[0]:
            best = (key, body)
    return best[1] if best else []


def analyse(body, rays: int) -> dict:
    ready, chain = {}, 0
    fma = alu = 0
    for _, guard, opcode, operands in body:
        base = opcode.split(".")[0]
        fma += base in FMA_PIPE
        alu += base in ALU_PIPE
        n_dest = 0 if base in NO_DEST else 2 if base in TWO_DESTS else 1
        if base == "BAR" and ".RED" not in opcode:
            n_dest = 0
        dests = [r for op in operands[:n_dest] for r in _regs(op, opcode)]
        srcs = [r for op in operands[n_dest:] for r in _regs(op, opcode)]
        if guard:
            srcs.append(guard)
        start = max([ready.get(r, 0) for r in srcs] + [0])
        if base == "BAR":  # a barrier waits for everything before it
            start = max([start] + list(ready.values()))
        done = start + LATENCY.get(base, DEFAULT_LATENCY)
        for r in dests:
            ready[r] = done
        chain = max(chain, done)
    fmnmx = sum(x[2].startswith("FMNMX") for x in body)
    steps = max(1.0, fmnmx / (10 * rays))
    issue = max(fma, 2 * alu)
    return {"instructions": len(body), "fma_pipe": fma, "alu_pipe": alu, "steps": steps,
            "instructions_per_step": len(body) / steps, "issue_clocks_per_step": issue / steps,
            "chain_clocks_per_step": chain / steps}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", default="microstep_kernel", help="part of the function names")
    ap.add_argument("--rays", type=int, default=8, help="rays a thread (10 FMNMX a ray-step)")
    ap.add_argument("--sass", help="a saved `cuobjdump -sass` listing instead of the library")
    args = ap.parse_args()
    if args.sass:
        with open(args.sass) as f:
            sass = f.read()
    else:
        from capsaicin_tpu_torch import kernels as K

        K.load()
        cuobjdump = os.path.join(os.path.dirname(K.find_nvcc()), "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", K.library_path()], capture_output=True,
                              text=True, check=True).stdout
    for name, insns in sorted(functions(sass).items()):
        if args.kernel in name:
            print(json.dumps({"function": name, **analyse(step_loop(insns), args.rays)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
