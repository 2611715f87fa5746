"""SASS census of the step kernel's instances, from the built library.

    python -m raytrace_tpu_torch.sass_census [--against DIR]
        [--instances "float bs3 2d_lat axi,float bs3 3d full" | all]

Builds this checkout's kernel (and, with --against, another checkout's,
as kernel_ab does), disassembles the library with `cuobjdump -sass` and,
for each named instance (the keys of ops/step_chunk.py::ptxas_usage,
without the body's "team<K>" or "group<G>" suffix; each of its bodies),
finds the attempt loop (the widest backward branch inside the function's
widest one, the pass loop around the attempts) and reports over its
body:

- the instruction count by class (FP32, FP64, MUFU, conversions, branches
  and control, barriers, shared memory with the warp shuffles, global
  memory, integer and other);
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
  --against;
- `calls`: the code that the attempt loop CALLs (an out-of-line
  right-hand side: rhs_3d_general of the one-thread general-field
  instances, rhs_ad of the AD ones, rhs_ad_group of the AD group body
  (a lane's value chain and tangent row, and its shuffles), placed after
  the kernel's code; not
  the math library's slow paths, SLOW_PATH_MAX), with its call sites in
  the loop and the census of its whole body as a chain of its own
  (`chain_cycles`, `inorder_cycles`, `bytes`, `by_class`);
- `helper_loop`: in a team-body instance, the census of the helpers'
  loop (the pieces of a right-hand side, every role's code in address
  order: its chain is the longest role's), and `rhs_per_attempt`, the
  right-hand sides warp 0 waits for in an attempt (its barriers / 2);
- `chain_cycles_total`: the attempt's chain with what it waits on
  outside the loop's own code: `chain_cycles` plus, for each call site,
  the callee's chain, plus `rhs_per_attempt` times the helper loop's
  chain. The latency floor (latency_floor) takes this one.

Both walk the code in address order, slow paths included (a division's
or a sine's rarely taken branch), so they are estimates of the attempt's
critical path, to set against the measured cycles per attempt (time /
attempts x clocks.sm). Each record also holds `sha`, a digest of the
instance's whole SASS text (opcodes and operands, its out-of-line
functions included), so that two checkouts' instances can be seen to be
the same code. Prints one line per instance
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
    ("shared", r"(LDS|STS|SHFL)\b"),
    ("global", r"(LDG|STG|LDL|STL|LD|ST)\b"),
    ("int", r"(IMAD|IADD3|ISETP|LOP3|SHF|LEA|IABS|IMNMX|POPC|FLO|SEL|"
            r"PRMT|P2R|R2P|PLOP3|MOV|S2R|CS2R|ULDC|LDC|UMOV|S2UR)"),
)
# a callee of fewer instructions is a slow path of the math library
# (call_census): those of the step kernel are 21-103 instructions, its
# out-of-line right-hand sides thousands
SLOW_PATH_MAX = 512
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


def loops(insns):
    """(first, last) index of every backward branch's span, the widest
    first."""
    addr = {a: k for k, (a, *_rest) in enumerate(insns)}
    spans = []
    for k, (a, _p, op, ops) in enumerate(insns):
        if op.startswith("BRA"):
            m = re.search(r"0x([0-9a-f]+)", ops)
            if m and int(m[1], 16) < a and int(m[1], 16) in addr:
                spans.append((addr[int(m[1], 16)], k))
    return sorted(spans, key=lambda s: s[0] - s[1])


def widest_loop(insns):
    """(first, last) index of the widest backward branch's span, or
    None."""
    spans = loops(insns)
    return spans[0] if spans else None


def _barrier_counter(insns):
    """count(span): the barriers in the span (first, last) of insns."""
    before = [0]
    for _a, _p, op, _o in insns:
        before.append(before[-1] + (classify(op) == "barrier"))
    return lambda span: before[span[1] + 1] - before[span[0]]


def pass_loop(insns):
    """The pass loop's span (around fresh's right-hand side, the attempts
    and finish's): the widest loop, or in a team-body instance (one with
    barriers) the widest loop that holds a loop with barriers, the
    attempt loop (the helpers' loop holds barriers but no such loop, and
    may be the wider one)."""
    spans = loops(insns)
    count = _barrier_counter(insns)
    if not spans or not count((0, len(insns) - 1)):
        return spans[0] if spans else None
    barred = [t for t in spans if count(t)]
    for s in spans:
        if any(t != s and s[0] <= t[0] and t[1] <= s[1] for t in barred):
            return s
    return spans[0]


def helper_loop(insns):
    """The team body's helper loop: the widest loop with barriers outside
    the pass loop, or None (a one-thread instance)."""
    outer = pass_loop(insns)
    count = _barrier_counter(insns)
    for s in loops(insns):
        if outer and (s[1] < outer[0] or s[0] > outer[1]) and count(s):
            return s
    return None


def loop_body(insns):
    """The attempt loop's instructions: the widest backward branch's span
    inside the pass loop (pass_loop), or the pass loop where it holds
    none, or all of them where there is no backward branch."""
    outer = pass_loop(insns)
    if outer is None:
        return insns
    body = insns[outer[0]:outer[1] + 1]
    inner = widest_loop(body[:-1])
    return body[inner[0]:inner[1] + 1] if inner else body


def callee(insns, ops):
    """The instructions that a CALL with operands `ops` runs: the caller's
    own listing from the target address (ptxas places a kernel's
    out-of-line functions after its code) to its first RET, or None."""
    m = re.search(r"0x([0-9a-f]+)", ops)
    if m is None:
        return None
    at = int(m[1], 16)
    start = next((k for k, x in enumerate(insns) if x[0] == at), None)
    if start is None:
        return None
    end = next((k for k in range(start, len(insns))
                if insns[k][2].startswith("RET")), len(insns) - 1)
    return insns[start:end + 1]


def call_census(insns, body):
    """[{target, sites, instructions, chain_cycles, inorder_cycles, bytes,
    by_class}] of the code that the body CALLs (an out-of-line right-hand
    side), each target once. A call to fewer than SLOW_PATH_MAX
    instructions is a slow path of the math library (a division's, a
    square root's, a sine's far argument reduction), which the code
    branches around on all but rare inputs, and is left out."""
    out = {}
    for _a, _pred, op, ops in body:
        if not op.startswith("CALL"):
            continue
        target = ops.split()[-1] if ops else ""
        if target in out:
            out[target]["sites"] += 1
            continue
        code = callee(insns, ops)
        if not code or len(code) < SLOW_PATH_MAX:
            continue
        counts, chain, inorder = census(code)
        out[target] = dict(target=target, sites=1, instructions=len(code),
                           chain_cycles=chain, inorder_cycles=inorder,
                           bytes=code_bytes(code)[0], by_class=counts)
    return list(out.values())


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


def _base(key):
    """An instance's key without its body's suffix."""
    return re.sub(r" (team|group)\d+$", "", key)


def instance_key(name):
    # the checkout's own naming (a child has that checkout on its path)
    from raytrace_tpu_torch.ops.step_chunk import ptxas_usage

    key = ptxas_usage(f"ptxas info : Compiling entry function '{name}'\n"
                      "ptxas info : Used 1 registers")
    return next(iter(key), None)


def instance_census(insns):
    """The census record of one instance's SASS (the keys of the module
    docstring but `sha`)."""
    body = loop_body(insns)
    counts, chain, inorder = census(body)
    size, size_by_class = code_bytes(body)
    calls = call_census(insns, body)
    rec = dict(instructions=len(insns), loop=len(body), by_class=counts,
               chain_cycles=chain, inorder_cycles=inorder, loop_bytes=size,
               bytes_by_class=size_by_class, inner_loop=inner_loop(body),
               calls=calls)
    total = chain + sum(c["sites"] * c["chain_cycles"] for c in calls)
    span = helper_loop(insns)
    if span is not None:
        code = insns[span[0]:span[1] + 1]
        hcounts, hchain, hinorder = census(code)
        rec["helper_loop"] = dict(instructions=len(code),
                                  chain_cycles=hchain,
                                  inorder_cycles=hinorder,
                                  bytes=code_bytes(code)[0],
                                  by_class=hcounts)
        rec["rhs_per_attempt"] = counts.get("barrier", 0) // 2
        total += rec["rhs_per_attempt"] * hchain
    rec["chain_cycles_total"] = total
    return rec


def bodies(census_out, inst):
    """{key: record} of instance `inst` (named without the body's
    "team<K>" or "group<G>" suffix) in run_census's output: one body, or
    two where the instance runs its tail layout on the team body (the
    general-field float bs3 ones) or has a group body (two AD ones)."""
    out = {key: rec for key, rec in census_out.items()
           if _base(key) == inst}
    if not out:
        raise KeyError(inst)
    return out


def entry_names(build_log):
    """The kernel entry points that ptxas compiled, from a build's log
    (ops/step_chunk.py::BUILD_LOG), in their mangled form."""
    return sorted(set(re.findall(r"Compiling entry function '([^']+)'",
                                 build_log)))


def run_census(lib_path, wanted, names=None):
    """{instance key: census record} of the wanted instances (all where
    wanted is None). names: the library's entry points (entry_names), so
    that cuobjdump disassembles only the wanted ones (-fun); without
    them, or where that dump misses a wanted instance, the whole library
    is disassembled (over a minute on the machine with the card)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"

    def wants(name):
        key = instance_key(name)
        return key is not None and (wanted is None or _base(key) in wanted)

    def dump(*only):
        return subprocess.run([tool, "-sass", *only, lib_path],
                              capture_output=True, text=True,
                              check=not only).stdout

    picked = [n for n in names or () if wanted is not None and wants(n)]
    funcs = parse(dump("-fun", ",".join(picked)), wants) if picked else {}
    if not picked or {instance_key(n) for n in funcs} != {
            instance_key(n) for n in picked}:
        funcs = parse(dump(), wants)
    out = {}
    for name, insns in funcs.items():
        text = "\n".join(f"{p} {op} {ops}" for _a, p, op, ops in insns)
        out[instance_key(name)] = dict(
            instance_census(insns),
            sha=hashlib.sha256(text.encode()).hexdigest()[:16])
    return out


def _child(root, wanted):
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [root] + [q for q in sys.path
                            if os.path.abspath(q or ".") != here]
    from raytrace_tpu_torch.ops import step_chunk as sc

    sc.build()
    print(json.dumps(run_census(sc.library_path(), wanted,
                                entry_names(sc.BUILD_LOG))))


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
                    f"{c['inorder_cycles']} cycles" + "".join(
                        f"; calls {x['target']} x {x['sites']} "
                        f"({x['instructions']} instructions, chain "
                        f"{x['chain_cycles']} cycles)"
                        for x in c["calls"])
                  + (f"; helper loop {c['helper_loop']['instructions']} "
                     f"instructions, chain "
                     f"{c['helper_loop']['chain_cycles']} cycles x "
                     f"{c['rhs_per_attempt']} right-hand sides"
                     if "helper_loop" in c else "")
                  + f"; chain with what the loop waits on "
                    f"{c['chain_cycles_total']} "
                    "cycles", flush=True)
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
