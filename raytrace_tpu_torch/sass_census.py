"""SASS census of the step kernel's instances, from the built library.

    python -m raytrace_tpu_torch.sass_census [--against DIR]
        [--instances "float bs3 2d_lat axi,float bs3 3d full" | all]

Builds this checkout's kernel (and, with --against, another checkout's,
as kernel_ab does), disassembles the library with `cuobjdump -sass` and,
for each named instance (the keys of ops/step_chunk.py::ptxas_usage,
without the body's "team<K>" suffix), finds the attempt loop (the widest
backward branch inside the function's widest one, the pass loop around
the attempts) and reports over its body:

- the instruction count by class (FP32, FP64, MUFU, conversions, branches
  and control, barriers, shared and global memory, integer and other);
- `chain_cycles`: the longest path through the body's register
  dependencies, each instruction weighted by a latency of its class
  (LATENCY below: Hopper's fixed-latency pipes, and a nominal figure for
  the variable-latency ones), and
- `inorder_cycles`: one warp issuing the body in address order, one
  instruction a cycle, each waiting for its operands: the single-warp time
  of the straight line;
- `loop_bytes`: the body's size in bytes (its first instruction's address
  to its last one's end), what one pass of the loop asks of the
  instruction caches, and `bytes_by_class`, the same by class;
- `inner_loop`: the instructions of the widest backward branch inside the
  body (0 where it has none). Where that is bs3's stage loop (its three
  right-hand sides through one copy), the walk is not the attempt's
  chain: the loop runs three times, and its stage selection branches to
  code outside its span. Take an attempt's chain from a build with the
  stages unrolled (the same operations), e.g. the parent's with
  --against.

Both walk the code in address order, slow paths included (a division's
or a sine's rarely taken branch), so they are estimates of the attempt's
critical path, to set against the measured cycles per attempt (time /
attempts x clocks.sm). Each record also holds `sha`, a digest of the
instance's whole SASS text (opcodes and operands), so that two checkouts'
instances can be seen to be the same code. Prints one line per instance
(`--instances all`: every instance of the library) and, with --against,
the instances whose SASS is the same in both checkouts and those that
differ, and a JSON record as the last line. Needs the CUDA toolkit's
cuobjdump (the machine with the card).
"""

import argparse
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys

DEFAULT = "float bs3 2d_lat axi,float bs3 3d full"

# cycles from issue to a dependent issue, by class (nominal)
LATENCY = {"fp32": 4, "fp64": 8, "mufu": 18, "conv": 6, "int": 4,
           "shared": 30, "global": 400, "barrier": 24, "control": 2,
           "other": 4}
_CLASS = (
    ("mufu", r"MUFU"),
    ("fp64", r"D(ADD|MUL|FMA|SETP|MNMX|SET)\b"),
    ("fp32", r"F(ADD|MUL|FMA|SETP|MNMX|SEL|CHK|SET|SWZADD)|FADD32I|FMUL32I"
             r"|FFMA32I"),
    ("conv", r"(F2F|F2I|I2F|F2FP|I2FP|FRND)"),
    ("barrier", r"BAR\b|BAR\."),
    ("control", r"(BRA|BSSY|BSYNC|CALL|RET|EXIT|WARPSYNC|BMOV|JMP|BREAK|"
                r"NOP|YIELD|VOTE)"),
    ("shared", r"(LDS|STS)\b"),
    ("global", r"(LDG|STG|LDL|STL|LD|ST)\b"),
    ("int", r"(IMAD|IADD3|ISETP|LOP3|SHF|LEA|IABS|IMNMX|POPC|FLO|SEL|"
            r"PRMT|P2R|R2P|PLOP3|MOV|S2R|CS2R|ULDC|LDC|UMOV|S2UR)"),
)
_INSN = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
                   r"\s*([^;]*);")


def classify(op):
    base = op.split(".")[0]
    for cls, pat in _CLASS:
        if re.match(pat + r"$", base) or re.match(pat, op):
            return cls
    return "other"


def parse(sass, keep=None):
    """{function name: [(address, predicate, opcode, operands)]}, over the
    functions whose name `keep` accepts (all without it)."""
    funcs, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m[1] if keep is None or keep(m[1]) else None
            if name:
                funcs[name] = []
            continue
        m = name and _INSN.search(line)
        if m:
            funcs[name].append((int(m[1], 16), (m[2] or "").strip(), m[3],
                                m[4].strip()))
    return funcs


def _regs(text):
    return re.findall(r"\b(U?R\d+|U?P\d)\b", text)


def widest_loop(insns):
    """(first, last) index of the widest backward branch's span, or
    None."""
    addr = {a: k for k, (a, *_rest) in enumerate(insns)}
    best = None
    for k, (a, _p, op, ops) in enumerate(insns):
        if op.startswith("BRA"):
            m = re.search(r"0x([0-9a-f]+)", ops)
            if m and int(m[1], 16) < a and int(m[1], 16) in addr:
                span = (addr[int(m[1], 16)], k)
                if best is None or span[1] - span[0] > best[1] - best[0]:
                    best = span
    return best


def loop_body(insns):
    """The attempt loop's instructions: the widest backward branch's span
    inside the widest one (the pass loop around fresh's right-hand side,
    the attempts and finish's), or the widest span where it holds
    none, or all of them where there is no backward branch."""
    outer = widest_loop(insns)
    if outer is None:
        return insns
    body = insns[outer[0]:outer[1] + 1]
    inner = widest_loop(body[:-1])
    return body[inner[0]:inner[1] + 1] if inner else body


def inner_loop(body):
    """Instructions of the widest loop inside the body (its own closing
    branch aside), 0 where there is none."""
    inner = widest_loop(body[:-1])
    return inner[1] - inner[0] + 1 if inner else 0


def census(body):
    counts = {}
    ready, chain, issue, t_chain = {}, 0, 0, 0
    for _a, pred, op, ops in body:
        cls = classify(op)
        counts[cls] = counts.get(cls, 0) + 1
        regs = _regs(ops)
        wide = op.startswith("D") or ".64" in op
        # the destination is the first operand of every class but stores,
        # branches and barriers; a predicate guard is a source
        has_dst = cls not in ("control", "barrier") and not re.match(
            r"(STG|STS|STL|ST)\b", op)
        dst = regs[:1] if has_dst else []
        srcs = regs[1:] if has_dst else regs
        if pred:
            srcs = srcs + _regs(pred)
        if wide:
            srcs = srcs + [f"R{int(r[1:]) + 1}" for r in srcs
                           if re.fullmatch(r"R\d+", r)]
        dep = max((ready.get(r, 0) for r in srcs), default=0)
        lat = LATENCY[cls]
        # dependency-only chain
        t_chain = dep + lat
        chain = max(chain, t_chain)
        # in-order issue: wait for the operands, one issue a cycle
        issue = max(issue + 1, max((ready.get(("i", r), 0) for r in srcs),
                                   default=0))
        for r in dst + ([f"R{int(d[1:]) + 1}" for d in dst
                         if wide and re.fullmatch(r"R\d+", d)]):
            ready[r] = t_chain
            ready[("i", r)] = issue + lat
    return counts, chain, issue


def code_bytes(body):
    """(bytes from the body's first instruction to its last one's end,
    {class: bytes}); an instruction is as wide as the address step
    between neighbours (16 bytes on Hopper)."""
    if not body:
        return 0, {}
    width = ((body[-1][0] - body[0][0]) // (len(body) - 1)
             if len(body) > 1 else 16)
    by_class = {}
    for _a, _p, op, _o in body:
        cls = classify(op)
        by_class[cls] = by_class.get(cls, 0) + width
    return body[-1][0] - body[0][0] + width, by_class


def instance_key(name):
    # the checkout's own naming (a child has that checkout on its path)
    from raytrace_tpu_torch.ops.step_chunk import ptxas_usage

    key = ptxas_usage(f"ptxas info : Compiling entry function '{name}'\n"
                      "ptxas info : Used 1 registers")
    return next(iter(key), None)


def run_census(lib_path, wanted):
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True).stdout

    def wants(name):
        key = instance_key(name)
        return key is not None and (
            wanted is None or re.sub(r" team\d+$", "", key) in wanted)

    out = {}
    for name, insns in parse(sass, wants).items():
        key = instance_key(name)
        body = loop_body(insns)
        counts, chain, inorder = census(body)
        size, size_by_class = code_bytes(body)
        text = "\n".join(f"{p} {op} {ops}" for _a, p, op, ops in insns)
        out[key] = dict(instructions=len(insns), loop=len(body),
                        by_class=counts, chain_cycles=chain,
                        inorder_cycles=inorder, loop_bytes=size,
                        bytes_by_class=size_by_class,
                        inner_loop=inner_loop(body),
                        sha=hashlib.sha256(text.encode()).hexdigest()[:16])
    return out


def _child(root, wanted):
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [root] + [q for q in sys.path
                            if os.path.abspath(q or ".") != here]
    from raytrace_tpu_torch.ops import step_chunk as sc

    sc.build()
    print(json.dumps(run_census(sc.library_path(), wanted)))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--against", help="root of another checkout")
    p.add_argument("--instances", default=DEFAULT)
    p.add_argument("--child", help=argparse.SUPPRESS)
    args = p.parse_args()
    wanted = (None if args.instances == "all"
              else set(args.instances.split(",")))
    if args.child:
        _child(os.path.abspath(args.child), wanted)
        return 0
    roots = {"this": os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))}
    if args.against:
        roots["other"] = os.path.abspath(args.against)
    procs = {k: subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", r,
         "--instances", args.instances], stdout=subprocess.PIPE, text=True)
        for k, r in roots.items()}
    record = {}
    for k, proc in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"census of {roots[k]} failed:\n{out}")
        record[k] = json.loads(out.strip().splitlines()[-1])
        for inst, c in sorted(record[k].items()):
            print(f"{k} {inst}: {c['loop']} instructions in the attempt loop "
                  f"({c['instructions']} in the kernel; the loop "
                  f"{c['loop_bytes']:,} bytes), "
                  + ", ".join(f"{cls} {n}" for cls, n in
                              sorted(c["by_class"].items()))
                  + f"; inner loop {c['inner_loop']} instructions; chain "
                    f"{c['chain_cycles']} cycles, in-order issue "
                    f"{c['inorder_cycles']} cycles", flush=True)
    if "other" in record:
        both = sorted(set(record["this"]) & set(record["other"]))
        same = [k for k in both
                if record["this"][k]["sha"] == record["other"][k]["sha"]]
        print(f"SASS the same in both checkouts: {len(same)} of {len(both)} "
              f"common instances; differ: "
              f"{sorted(set(both) - set(same)) or 'none'}; only here: "
              f"{sorted(set(record['this']) - set(both)) or 'none'}",
              flush=True)
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
